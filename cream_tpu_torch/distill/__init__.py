from cream_tpu_torch.distill.clip_losses import clip_contrastive_loss, clip_soft_loss
from cream_tpu_torch.distill.l0 import (L0Config, deterministic_z, expected_sparsity,
                                        init_l0_params, lagrangian_loss, named_l0,
                                        negate_lambda_grads, sample_masks, sample_z,
                                        score_loga)
from cream_tpu_torch.distill.logits_store import LogitsReader, LogitsWriter
from cream_tpu_torch.distill.weight_inherit import weight_inherit
