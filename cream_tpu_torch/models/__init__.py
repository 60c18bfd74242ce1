from cream_tpu_torch.models.registry import create_model, list_models, register_model
from cream_tpu_torch.models import (autoformer, clip, cream, cydas_seg, darts,  # noqa: F401  (register the variants)
                                    deit_rpe, detr, efficientvit, mask_rcnn, mini_deit,
                                    nasbench201, resnet, retinanet, swin, tinyvit)

__all__ = ["create_model", "list_models", "register_model"]
