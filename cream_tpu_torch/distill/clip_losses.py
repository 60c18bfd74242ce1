"""CLIP's contrastive and affinity-mimicking losses, one card or many.

Counterpart of `cream_tpu/distill/clip_losses.py` (TinyCLIP's ClipLoss,
src/open_clip/loss.py:18-165, and ClipSoftLoss, clip_soft_loss.py:54-88).
With a `torch.distributed` process group each rank holds its local block
of the batch: the features are gathered with gradient
(`torch.distributed.nn.functional.all_gather`), each rank computes its
rows of the similarity matrix against the whole batch with labels offset
by rank * B (the reference's `local_loss` path), and the loss is the mean
over ranks. The mean's backward sends each rank's own term 1/world of the
gradient; the gather's backward sums the gathered rows' grads over ranks,
so each rank's features get the gradient of the mean loss. Without a
group it is the one-card loss.

The similarities, softmaxes and cross entropies are fp32 whatever the
features' dtype: the JAX package multiplies bf16 features by the fp32
logit scale first, which promotes them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


class _MeanOverRanks(torch.autograd.Function):
    """The mean of a value over a group's ranks; backward hands each
    rank's own term 1/world of the gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.world = dist.get_world_size(group)
        total = x.detach().clone()
        dist.all_reduce(total, group=group)
        return total / ctx.world

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad / ctx.world, None


def _gather(feat: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return feat
    from torch.distributed.nn.functional import all_gather
    return torch.cat(all_gather(feat, group=group), dim=0)


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _MeanOverRanks.apply(x, group)


def clip_contrastive_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                          logit_scale: torch.Tensor, group=None) -> torch.Tensor:
    """Symmetric InfoNCE over the whole batch; the features are normalized."""
    img, txt = image_features.float(), text_features.float()
    B = img.shape[0]
    logits_i = logit_scale * img @ _gather(txt, group).T
    logits_t = logit_scale * txt @ _gather(img, group).T
    offset = 0 if group is None else dist.get_rank(group) * B
    labels = torch.arange(B, device=img.device) + offset
    loss = (F.cross_entropy(logits_i, labels) + F.cross_entropy(logits_t, labels)) / 2
    return _mean(loss, group)


def clip_soft_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                   logit_scale: torch.Tensor, teacher_image_features: torch.Tensor,
                   teacher_text_features: torch.Tensor, teacher_logit_scale: torch.Tensor,
                   group=None, average_two_losses: bool = True):
    """Affinity mimicking: the student's image->text and text->image
    similarity rows trained by soft cross entropy toward the teacher's rows
    over the same batch. The teacher's features carry no gradient."""
    img, txt = image_features.float(), text_features.float()
    t_img = teacher_image_features.detach().float()
    t_txt = teacher_text_features.detach().float()
    t_scale = teacher_logit_scale.detach()

    def soft_ce(student_logits, teacher_logits):
        p = torch.softmax(teacher_logits, dim=-1)
        return -(p * torch.log_softmax(student_logits, dim=-1)).sum(-1).mean()

    li = soft_ce(logit_scale * img @ _gather(txt, group).T,
                 t_scale * t_img @ _gather(t_txt, group).T)
    lt = soft_ce(logit_scale * txt @ _gather(img, group).T,
                 t_scale * t_txt @ _gather(t_img, group).T)
    li, lt = _mean(li, group), _mean(lt, group)
    if average_two_losses:
        return (li + lt) / 2
    return li, lt
