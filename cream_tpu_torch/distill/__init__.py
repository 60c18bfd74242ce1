from cream_tpu_torch.distill.logits_store import LogitsReader, LogitsWriter
