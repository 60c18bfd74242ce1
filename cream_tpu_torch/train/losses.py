"""Loss zoo, as pure tensor functions: counterpart of
`cream_tpu/train/losses.py`, with the same names and arguments.

  * label-smoothing CE (DeiT/Swin lineages)
  * soft-target CE (TinyViT distillation; the classification trainer's loss)
  * DeiT-style distillation wrapper — none/soft/hard
  * dense teacher probabilities from saved top-K sparse logits
  * MiniViT relation/hidden distillation
  * CDARTS interactive loss (KL with T^2)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def label_smoothing_ce(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: float = 0.1) -> torch.Tensor:
    n = logits.shape[-1]
    target = F.one_hot(labels.long(), n).to(logits.dtype)
    target = target * (1.0 - smoothing) + smoothing / n
    return soft_target_ce(logits, target)


def soft_target_ce(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """CE against a dense probability target: mean over batch of -sum p log q."""
    return -(target_probs * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def kl_divergence(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  tau: float = 1.0) -> torch.Tensor:
    """KL(teacher || student) * tau^2, batch-mean."""
    log_pt = F.log_softmax(teacher_logits / tau, dim=-1)
    log_ps = F.log_softmax(student_logits / tau, dim=-1)
    return ((log_pt.exp() * (log_pt - log_ps)).sum(-1) * tau * tau).mean()


def deit_distillation_loss(base_loss: torch.Tensor,
                           student_logits: torch.Tensor,
                           teacher_logits: torch.Tensor,
                           kind: str = "soft", alpha: float = 0.5,
                           tau: float = 1.0) -> torch.Tensor:
    """base*(1-alpha) + distill*alpha; kind in {none, soft, hard}: 'soft' is
    the tau^2-scaled KL, 'hard' CE against the teacher's argmax."""
    if kind == "none" or alpha == 0.0:
        return base_loss
    if kind == "soft":
        dist = kl_divergence(student_logits, teacher_logits, tau)
    elif kind == "hard":
        dist = F.cross_entropy(student_logits, teacher_logits.argmax(-1))
    else:
        raise ValueError(f"unknown distillation kind {kind}")
    return base_loss * (1 - alpha) + dist * alpha


def dense_from_topk(values: torch.Tensor, indices: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """Dense teacher probabilities from saved top-K: values (B, K) softmax
    probs at int indices (B, K); the other classes share the residual mass
    uniformly (clamped at 0)."""
    B, K = values.shape
    minor = ((1.0 - values.sum(-1, keepdim=True)) / (num_classes - K)).clamp(min=0.0)
    dense = minor.expand(B, num_classes).clone()
    dense.scatter_(1, indices.long(), 0.0)
    return dense.scatter_add(1, indices.long(), values)


def relation_distillation_loss(student_qkv: torch.Tensor,
                               teacher_qkv: torch.Tensor,
                               num_heads_group: int,
                               tau: float = 1.0) -> torch.Tensor:
    """MiniViT attention-relation KD. qkv: (3, B, H, N, D) stacked q, k, v;
    the 9 cross relations softmax(x_i x_j^T / sqrt(D')) with heads grouped
    into `num_heads_group`; mean soft-CE of teacher vs student relations."""
    def relations(qkv):
        three, B, H, N, D = qkv.shape
        g = num_heads_group
        x = qkv.reshape(3, B, g, H // g, N, D)
        x = x.permute(0, 1, 2, 4, 3, 5).reshape(3, B, g, N, (H // g) * D)
        return torch.einsum("ibgnd,jbgmd->ijbgnm", x, x) * x.shape[-1] ** -0.5
    s = relations(student_qkv) / tau
    t = relations(teacher_qkv) / tau
    return -(F.softmax(t, -1) * F.log_softmax(s, -1)).sum(-1).mean() * (tau * tau)


def hidden_relation_loss(student_h: torch.Tensor, teacher_h: torch.Tensor
                         ) -> torch.Tensor:
    """MiniViT hidden-state relation MSE of L2-normalized token relations."""
    def rel(h):
        h = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-6)
        return torch.einsum("bnd,bmd->bnm", h, h)
    return ((rel(student_h) - rel(teacher_h)) ** 2).mean()


def interactive_loss(logits_a: torch.Tensor, logits_b: torch.Tensor,
                     kind: str = "kl", tau: float = 2.0) -> torch.Tensor:
    """CDARTS search/eval-network interaction loss; logits_b is a constant."""
    b = logits_b.detach()
    if kind == "kl":
        return kl_divergence(logits_a, b, tau)
    if kind == "mse":
        return ((logits_a - b) ** 2).mean()
    if kind == "cos":
        a = logits_a / (torch.linalg.vector_norm(logits_a, dim=-1, keepdim=True) + 1e-8)
        b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
        return -(a * b).sum(-1).mean()
    raise ValueError(f"unknown interactive loss kind {kind}")
