from cream_tpu_torch.models.registry import create_model, list_models, register_model
from cream_tpu_torch.models import tinyvit  # noqa: F401  (registers the TinyViT variants)

__all__ = ["create_model", "list_models", "register_model"]
