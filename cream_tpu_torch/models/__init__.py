from cream_tpu_torch.models.registry import create_model, list_models, register_model
from cream_tpu_torch.models import (clip, efficientvit, resnet, swin,  # noqa: F401  (register the variants)
                                    tinyvit)

__all__ = ["create_model", "list_models", "register_model"]
