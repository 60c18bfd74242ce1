"""Neural architecture search: AutoFormer's supernet training and evolution
search, Cream's prioritized-path search, and CDARTS' cyclic and staged
searches (counterpart of `cream_tpu/nas`)."""
