from cream_tpu_torch.models.registry import create_model, list_models, register_model
from cream_tpu_torch.models import (autoformer, clip, cream, deit_rpe,  # noqa: F401  (register the variants)
                                    efficientvit, mini_deit, resnet, swin, tinyvit)

__all__ = ["create_model", "list_models", "register_model"]
