"""One-shot NAS: AutoFormer's supernet training and evolution search, and
Cream's prioritized-path search (counterpart of `cream_tpu/nas`)."""
