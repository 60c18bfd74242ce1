"""CLIP two-tower models with TinyCLIP's L0 gates, and the CLIP classifier
teacher.

Counterpart of `cream_tpu/models/clip.py` (TinyCLIP/src/open_clip/model.py:
VisualTransformer, the text Transformer and CLIP). Every block takes
TinyCLIP's gate set:

  hidden_z (width,)        multiplies the vision embeddings and every
                           residual branch's output; LayerNorm statistics
                           are taken over the nonzero-gated channels only
  heads_z (layers, heads)  multiplies each head's attention output
  mha_z (layers,)          scales a whole attention branch
  intermediate_z (L, I)    multiplies the MLP's hidden activations
  ffn_z (layers,)          scales a whole MLP branch

Head counts and MLP widths are per layer, so a pruned (ragged) model is an
ordinary instance: a block with 0 heads or MLP width 0 skips that sublayer
and owns no parameters for it. `head_dim` stays 64 when the width is pruned.
`prune_clip` materializes a gated model as such a ragged one (host-side),
and `remat=True` recomputes each block in the backward.

Tensor parallelism: built with a `model_shard` (`core.tensor_parallel.
ModelShard`, `current_shard()` under `core.mesh`'s (data, model) layout), a
CLIP or CLIP classifier holds one model rank's shard of every block: whole
heads of q, k and v and their out_proj columns, and its columns of the MLP,
under the same state-dict names (`shard_state_dict` cuts a full one;
`split_clip` shards a built model). Each rank computes its own heads and MLP
channels; the row-split products are summed over the model group in fp32,
out_proj's and c_proj's biases added once after the sum. `heads_z` and
`intermediate_z` are sliced to the rank's heads and channels; `hidden_z`,
`mha_z` and `ffn_z` apply after the sum. Every block's heads and MLP width
must divide by the model size, or the model raises naming the layer. The
unsplit model (no shard) computes as it did.

Rounding points are the JAX package's: parameters are fp32 and cast to the
compute dtype per call; LayerNorm statistics are fp32; q is scaled by
hd**-0.5 in the compute dtype before the product; the scores, the softmax
and P·V's sums are fp32, P and P·V are cast to the compute dtype. The
attention is plain tensor math: no TPU kernel lies on this path.

Parameter names are open_clip's own (`visual.conv1.weight`,
`visual.transformer.resblocks.{i}.attn.in_proj_weight`, `...mlp.c_fc`,
`token_embedding.weight`, `ln_final`, `text_projection`, `logit_scale`), so
a released TinyCLIP or OpenAI-CLIP state_dict loads as it is; the
classifier's are those of TinyViT's CLIP teacher (`visual.*`, `head`).
Inputs: images NHWC, token ids (B, L) int.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cream_tpu_torch.core.tensor_parallel import (ModelShard, copy_to_model, mark_split,
                                                   row_parallel_out, shard_state_dict)
from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.nn.act import gelu
from cream_tpu_torch.nn.layers import linear


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MaskedLayerNorm(nn.Module):
    """LayerNorm (eps 1e-5) in fp32 whose statistics, with a hidden gate,
    cover the nonzero-gated channels only (population variance); the
    gated-off channels come out 0 (TinyCLIP model.py:40-68)."""

    def __init__(self, dim: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype, self.eps = dtype, 1e-5
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor, hidden_z: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        xf = x.float()
        if hidden_z is None:
            return F.layer_norm(xf, self.weight.shape, self.weight, self.bias,
                                self.eps).to(self.dtype)
        m = (hidden_z != 0).float()
        d = m.sum().clamp(min=1.0)
        xm = xf * m
        mean = xm.sum(-1, keepdim=True) / d
        var = (((xm - mean) * m) ** 2).sum(-1, keepdim=True) / d
        y = (xm - mean) * torch.rsqrt(var + self.eps)
        return ((y * self.weight + self.bias) * m).to(self.dtype)


class GatedAttention(nn.Module):
    """Multi-head attention with per-head and hidden gates; `in_proj_weight`
    rows are [q(h0..hH); k; v] as in torch's MultiheadAttention. With a
    `model_shard` it holds that model rank's heads (`heads` is then its
    count of them); `name` labels a refusal."""

    def __init__(self, width: int, heads: int, head_dim: int = 64, *,
                 dtype: torch.dtype, device=None, model_shard: ModelShard | None = None,
                 name: str = "attn"):
        super().__init__()
        self.model_shard = model_shard
        if model_shard is not None:
            heads = model_shard.split(heads, f"{name} heads")
        self.heads, self.head_dim, self.dtype = heads, head_dim, dtype
        inner = heads * head_dim
        self.in_proj_weight = nn.Parameter(torch.empty(3 * inner, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * inner, device=device))
        self.out_proj = nn.Linear(inner, width, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)
        if model_shard is not None:
            mark_split(model_shard, self.in_proj_weight, self.in_proj_bias, self.out_proj.weight)

    def _heads(self, x: torch.Tensor, attn_mask, heads_z) -> torch.Tensor:
        """The heads' outputs, gated, as (B, L, H * hd) in the compute dtype."""
        B, L, _ = x.shape
        H, hd, dt = self.heads, self.head_dim, self.dtype
        qkv = F.linear(x, self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = qkv.view(B, L, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0)
        q = q * hd ** -0.5
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if attn_mask is not None:
            sim = sim + attn_mask
        attn = torch.softmax(sim, dim=-1).to(dt)
        out = torch.matmul(attn.float(), v.float()).to(dt)
        if heads_z is not None:
            if self.model_shard is not None:
                heads_z = heads_z[self.model_shard.part(H * self.model_shard.size)]
            out = out * heads_z.view(1, H, 1, 1).to(dt)
        return out.transpose(1, 2).reshape(B, L, H * hd)

    def partial(self, x: torch.Tensor, attn_mask=None, heads_z=None) -> torch.Tensor:
        """A split layer's share of out_proj's product from its own heads,
        in fp32, without the bias: the model ranks' shares sum to it."""
        x = copy_to_model(x, self.model_shard.group)
        return F.linear(self._heads(x, attn_mask, heads_z),
                        self.out_proj.weight.to(self.dtype)).float()

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                heads_z: Optional[torch.Tensor] = None,
                hidden_z: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        if self.model_shard is None:
            out = linear(self.out_proj, self._heads(x, attn_mask, heads_z), dt)
        else:
            out = row_parallel_out(self.partial(x, attn_mask, heads_z), self.out_proj.bias,
                                   dt, self.model_shard.group)
        if hidden_z is not None:
            out = out * hidden_z.to(dt)
        return out


class Mlp(nn.Module):
    """open_clip's `mlp`: c_fc -> activation -> c_proj. With a
    `model_shard` it holds that model rank's hidden channels."""

    def __init__(self, width: int, hidden: int, *, device=None,
                 model_shard: ModelShard | None = None, name: str = "mlp"):
        super().__init__()
        self.model_shard = model_shard
        if model_shard is not None:
            hidden = model_shard.split(hidden, f"{name} width")
        self.c_fc = nn.Linear(width, hidden, device=device)
        self.c_proj = nn.Linear(hidden, width, device=device)
        if model_shard is not None:
            mark_split(model_shard, self.c_fc.weight, self.c_fc.bias, self.c_proj.weight)

    def hidden(self, x: torch.Tensor, act, dtype: torch.dtype, intermediate_z=None
               ) -> torch.Tensor:
        """The activated hidden channels (this rank's, split), gated."""
        h = act(linear(self.c_fc, x, dtype))
        if intermediate_z is not None:
            if self.model_shard is not None:
                intermediate_z = intermediate_z[
                    self.model_shard.part(h.shape[-1] * self.model_shard.size)]
            h = h * intermediate_z.to(dtype)
        return h

    def partial(self, x: torch.Tensor, act, dtype: torch.dtype, intermediate_z=None
                ) -> torch.Tensor:
        """A split MLP's share of c_proj's product, in fp32, without the
        bias: the model ranks' shares sum to it."""
        x = copy_to_model(x, self.model_shard.group)
        return F.linear(self.hidden(x, act, dtype, intermediate_z),
                        self.c_proj.weight.to(dtype)).float()


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block; heads == 0 or mlp_width == 0 means that branch was
    pruned away: the sublayer is skipped and owns no parameters."""

    def __init__(self, width: int, heads: int, mlp_width: int, act: str = "gelu",
                 head_dim: int = 64, *, dtype: torch.dtype, device=None,
                 model_shard: ModelShard | None = None, name: str = "resblock"):
        super().__init__()
        self.dtype = dtype
        self.act = quick_gelu if act == "quick_gelu" else gelu
        if heads > 0:
            self.ln_1 = MaskedLayerNorm(width, dtype=dtype, device=device)
            self.attn = GatedAttention(width, heads, head_dim, dtype=dtype, device=device,
                                       model_shard=model_shard, name=f"{name}.attn")
        if mlp_width > 0:
            self.ln_2 = MaskedLayerNorm(width, dtype=dtype, device=device)
            self.mlp = Mlp(width, mlp_width, device=device, model_shard=model_shard,
                           name=f"{name}.mlp")

    def forward(self, x: torch.Tensor, attn_mask=None, hidden_z=None, heads_z=None,
                mha_z=None, intermediate_z=None, ffn_z=None) -> torch.Tensor:
        dt = self.dtype
        if hasattr(self, "attn"):
            h = self.attn(self.ln_1(x, hidden_z), attn_mask, heads_z, hidden_z)
            if mha_z is not None:
                h = h * mha_z.to(dt)
            x = x + h
        if hasattr(self, "mlp"):
            mlp, y = self.mlp, self.ln_2(x, hidden_z)
            if mlp.model_shard is None:
                h = linear(mlp.c_proj, mlp.hidden(y, self.act, dt, intermediate_z), dt)
            else:
                h = row_parallel_out(mlp.partial(y, self.act, dt, intermediate_z),
                                     mlp.c_proj.bias, dt, mlp.model_shard.group)
            if hidden_z is not None:
                h = h * hidden_z.to(dt)
            if ffn_z is not None:
                h = h * ffn_z.to(dt)
            x = x + h
        return x


def _layer_gates(masks: Optional[dict], i: int) -> dict:
    if not masks:
        return {}
    out = {}
    if masks.get("hidden_z") is not None:
        out["hidden_z"] = masks["hidden_z"]
    for name in ("heads_z", "mha_z", "intermediate_z", "ffn_z"):
        if masks.get(name) is not None:
            out[name] = masks[name][i]
    return out


class CLIPTransformer(nn.Module):
    """`resblocks`, with per-layer head counts and MLP widths. With `remat`
    each block's activations are recomputed in the backward instead of
    kept (`torch.utils.checkpoint`, non-reentrant, one block at a time), as
    the JAX package's `nn.remat` does: the same values, less memory; a split
    block's recomputed forward repeats its model-group sums, on every rank
    in the same order. `name` (the state-dict prefix) labels a refusal to
    split."""

    def __init__(self, width: int, layers: int, heads: Sequence[int],
                 mlp_widths: Sequence[int], act: str = "gelu", remat: bool = False, *,
                 dtype: torch.dtype, device=None, model_shard: ModelShard | None = None,
                 name: str = "transformer"):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads[i], mlp_widths[i], act,
                                   dtype=dtype, device=device, model_shard=model_shard,
                                   name=f"{name}.resblocks.{i}")
            for i in range(layers))

    def forward(self, x: torch.Tensor, attn_mask=None, masks: Optional[dict] = None):
        for i, block in enumerate(self.resblocks):
            gates = _layer_gates(masks, i)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, attn_mask, use_reentrant=False, **gates)
            else:
                x = block(x, attn_mask, **gates)
        return x


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class VisionTower(nn.Module):
    """open_clip's VisualTransformer: p x p stride-p patch conv (no bias),
    class token, positional embedding, ln_pre, the transformer, ln_post on
    the class token, `@ proj`."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: Sequence[int] | None = None,
                 mlp_widths: Sequence[int] | None = None, output_dim: int = 512,
                 act: str = "gelu", remat: bool = False, *, dtype: torch.dtype,
                 device=None, model_shard: ModelShard | None = None):
        super().__init__()
        self.dtype, self.patch_size = dtype, patch_size
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False, device=device)
        scale = width ** -0.5
        self.class_embedding = nn.Parameter(scale * torch.randn(width, device=device))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn(grid * grid + 1, width, device=device))
        self.ln_pre = MaskedLayerNorm(width, dtype=dtype, device=device)
        self.transformer = CLIPTransformer(
            width, layers, tuple(heads or [width // 64] * layers),
            tuple(mlp_widths or [width * 4] * layers), act, remat, dtype=dtype,
            device=device, model_shard=model_shard, name="visual.transformer")
        self.ln_post = MaskedLayerNorm(width, dtype=dtype, device=device)
        self.proj = nn.Parameter(scale * torch.randn(width, output_dim, device=device))

    def forward(self, image: torch.Tensor, masks: Optional[dict] = None,
                normalized: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = F.conv2d(image.to(dt).permute(0, 3, 1, 2), self.conv1.weight.to(dt),
                     stride=self.patch_size)
        B, W = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dt).expand(B, 1, W)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        hz = masks.get("hidden_z") if masks else None
        if hz is not None:
            x = x * hz.to(dt)
        x = self.ln_pre(x, hz)
        x = self.transformer(x, masks=masks)
        x = self.ln_post(x[:, 0], hz) @ self.proj.to(dt)
        return _normalized(x) if normalized else x


class TextTower(nn.Module):
    """The text transformer: token_embedding, positional_embedding[:L], the
    causal transformer, ln_final, the features at the first argmax of the
    token ids (EOT, the highest id) `@ text_projection`. Its parameters sit
    at the top level of open_clip's CLIP, so the two-tower models subclass
    it."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 width: int = 512, layers: int = 12, heads: Sequence[int] | None = None,
                 mlp_widths: Sequence[int] | None = None, output_dim: int = 512,
                 act: str = "gelu", remat: bool = False, *, dtype: torch.dtype,
                 device=None, model_shard: ModelShard | None = None):
        super().__init__()
        self.dtype, self.context_length = dtype, context_length
        self.token_embedding = nn.Embedding(vocab_size, width, device=device)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(context_length, width, device=device))
        self.transformer = CLIPTransformer(
            width, layers, tuple(heads or [width // 64] * layers),
            tuple(mlp_widths or [width * 4] * layers), act, remat, dtype=dtype,
            device=device, model_shard=model_shard, name="transformer")
        self.ln_final = MaskedLayerNorm(width, dtype=dtype, device=device)
        self.text_projection = nn.Parameter(
            width ** -0.5 * torch.randn(width, output_dim, device=device))

    def encode_text(self, text: torch.Tensor, masks: Optional[dict] = None,
                    normalized: bool = True) -> torch.Tensor:
        dt = self.dtype
        text = text.long()
        L = text.shape[1]
        x = self.token_embedding.weight[text].to(dt) + self.positional_embedding[:L].to(dt)
        causal = torch.full((L, L), -math.inf, device=x.device).triu(1)
        hz = masks.get("hidden_z") if masks else None
        x = self.transformer(x, attn_mask=causal, masks=masks)
        x = self.ln_final(x, hz)
        x = x[torch.arange(x.shape[0], device=x.device), text.argmax(-1)]
        x = x @ self.text_projection.to(dt)
        return _normalized(x) if normalized else x

    def forward(self, text, masks=None, normalized: bool = False):
        return self.encode_text(text, masks, normalized)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision_width: int = 768
    vision_layers: int = 12
    vision_patch: int = 16
    image_size: int = 224
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    context_length: int = 77
    vocab_size: int = 49408


class CLIP(TextTower):
    """Two towers and `logit_scale`; forward(image, text) ->
    (image_features, text_features, exp(logit_scale)), the features L2
    normalized in the compute dtype. `image_masks`/`text_masks` are gate
    dicts (see the module docstring). With `model_shard` both towers' blocks
    are split (see the module docstring)."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig(), quick_gelu: bool = False,
                 vision_heads: Sequence[int] | None = None,
                 vision_mlp_widths: Sequence[int] | None = None,
                 text_heads_per_layer: Sequence[int] | None = None,
                 text_mlp_widths: Sequence[int] | None = None, remat: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 model_shard: ModelShard | None = None):
        act = "quick_gelu" if quick_gelu else "gelu"
        c = cfg
        super().__init__(c.context_length, c.vocab_size, c.text_width, c.text_layers,
                         text_heads_per_layer or [c.text_heads] * c.text_layers,
                         text_mlp_widths, c.embed_dim, act, remat, dtype=dtype,
                         device=device, model_shard=model_shard)
        self.model_shard = model_shard
        self.cfg, self.img_size, self.quick_gelu = cfg, c.image_size, quick_gelu
        # the per-layer geometry as given (None: uniform), which the L0
        # gates of a ragged model follow
        self.vision_heads, self.vision_mlp_widths = vision_heads, vision_mlp_widths
        self.text_heads_per_layer, self.text_mlp_widths = text_heads_per_layer, text_mlp_widths
        self.visual = VisionTower(c.image_size, c.vision_patch, c.vision_width,
                                  c.vision_layers, vision_heads, vision_mlp_widths,
                                  c.embed_dim, act, remat, dtype=dtype, device=device,
                                  model_shard=model_shard)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07)), device=device))

    def encode_image(self, image, masks=None, normalized: bool = True):
        return self.visual(image, masks=masks, normalized=normalized)

    def forward(self, image, text, image_masks=None, text_masks=None):
        return (self.encode_image(image, image_masks), self.encode_text(text, text_masks),
                self.logit_scale.exp())


class CLIPClassifier(nn.Module):
    """The CLIP vision tower and a linear head: TinyViT's distillation
    teacher (TinyViT/models/clip.py:108-158). Logits = head(proj(features));
    a 22k head's logits go through the 22k -> 1k remap in save_logits.
    With `model_shard` the vision tower's blocks are split."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig(), num_classes: int = 1000,
                 quick_gelu: bool = False, *, dtype: torch.dtype = torch.float32,
                 device=None, model_shard: ModelShard | None = None):
        super().__init__()
        c = cfg
        self.cfg, self.img_size, self.dtype = cfg, c.image_size, dtype
        self.quick_gelu, self.model_shard = quick_gelu, model_shard
        self.visual = VisionTower(c.image_size, c.vision_patch, c.vision_width,
                                  c.vision_layers, output_dim=c.embed_dim,
                                  act="quick_gelu" if quick_gelu else "gelu",
                                  dtype=dtype, device=device, model_shard=model_shard)
        self.head = nn.Linear(c.embed_dim, num_classes, device=device)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return linear(self.head, self.visual(image), self.dtype)


def split_clip(model: nn.Module, model_shard: ModelShard) -> nn.Module:
    """A CLIP or CLIP classifier built again as `model_shard`'s split model
    (the same geometry, dtype, device and remat) with its shard of
    `model`'s weights."""
    device = next(model.parameters()).device
    if isinstance(model, CLIP):
        split = CLIP(model.cfg, model.quick_gelu, model.vision_heads, model.vision_mlp_widths,
                     model.text_heads_per_layer, model.text_mlp_widths,
                     model.visual.transformer.remat, dtype=model.dtype, device=device,
                     model_shard=model_shard)
    elif isinstance(model, CLIPClassifier):
        split = CLIPClassifier(model.cfg, model.head.out_features, model.quick_gelu,
                               dtype=model.dtype, device=device, model_shard=model_shard)
    else:
        raise TypeError(f"split_clip: {type(model).__name__} is not a CLIP model")
    split.load_state_dict(shard_state_dict(model.state_dict(), model_shard.rank,
                                           model_shard.size))
    return split


def _np_gate(g) -> Optional[np.ndarray]:
    if g is None:
        return None
    if isinstance(g, torch.Tensor):
        g = g.detach().cpu()
    return np.asarray(g, np.float32)


def _prune_tower(sd: dict, masks: dict, head_dim: int, text: bool) -> dict:
    """One tower's pruned state_dict entries (the reference's per-module
    .prune(): model.py:70-100 LayerNorm, :139-167 Mlp, :169-207
    MultiheadAttention). The arithmetic is the JAX package's `_prune_tower`
    in the same order on the transposed layouts, so the values are its
    bits: gates multiply fp32 numpy arrays, a branch gate as a Python
    float."""
    hz = _np_gate(masks.get("hidden_z"))
    pre = "" if text else "visual."
    W = sd["ln_final.weight" if text else "visual.ln_pre.weight"].shape[0]
    keep = np.where(hz != 0)[0] if hz is not None else np.arange(W)
    new_w = len(keep)
    out = {}

    def ln(p):
        for n in ("weight", "bias"):
            out[f"{p}.{n}"] = sd[f"{p}.{n}"][keep]

    if text:
        emb, pos = sd["token_embedding.weight"], sd["positional_embedding"]
        if hz is not None:
            emb, pos = emb * hz[None, :], pos * hz[None, :]
        out["token_embedding.weight"] = emb[:, keep]
        out["positional_embedding"] = pos[:, keep]
        ln("ln_final")
        out["text_projection"] = sd["text_projection"][keep]
    else:
        conv = sd["visual.conv1.weight"]                        # (W, 3, p, p)
        cls, pos = sd["visual.class_embedding"], sd["visual.positional_embedding"]
        if hz is not None:
            conv = conv * hz[:, None, None, None]
            cls, pos = cls * hz, pos * hz[None, :]
        out["visual.conv1.weight"] = conv[keep]
        out["visual.class_embedding"] = cls[keep]
        out["visual.positional_embedding"] = pos[:, keep]
        ln("visual.ln_pre")
        ln("visual.ln_post")
        out["visual.proj"] = sd["visual.proj"][keep]

    blocks = f"{pre}transformer.resblocks."
    present = sorted({int(k[len(blocks):].split(".")[0]) for k in sd if k.startswith(blocks)})
    for i in present:
        p = f"{blocks}{i}"
        heads_z = _np_gate(masks["heads_z"][i]) if masks.get("heads_z") is not None else None
        mha_z = float(masks["mha_z"][i]) if masks.get("mha_z") is not None else 1.0
        inter_z = _np_gate(masks["intermediate_z"][i]) \
            if masks.get("intermediate_z") is not None else None
        ffn_z = float(masks["ffn_z"][i]) if masks.get("ffn_z") is not None else 1.0
        # a branch a previous prune removed stays removed
        has_attn = f"{p}.attn.in_proj_weight" in sd
        has_ffn = f"{p}.mlp.c_fc.weight" in sd
        H = sd[f"{p}.attn.in_proj_weight"].shape[0] // (3 * head_dim) if has_attn else 0
        head_r = np.where(heads_z != 0)[0] if heads_z is not None else np.arange(H)
        I = sd[f"{p}.mlp.c_fc.weight"].shape[0] if has_ffn else 0
        inter_r = np.where(inter_z != 0)[0] if inter_z is not None else np.arange(I)
        # a branch whose gate is 0, or whose heads or channels are all off,
        # goes with its LayerNorm: the block skips it
        if has_attn and mha_z != 0.0 and len(head_r):
            qkv = sd[f"{p}.attn.in_proj_weight"].reshape(3, H, head_dim, W)
            out[f"{p}.attn.in_proj_weight"] = qkv[:, head_r][..., keep].reshape(-1, new_w)
            out[f"{p}.attn.in_proj_bias"] = sd[f"{p}.attn.in_proj_bias"].reshape(
                3, H, head_dim)[:, head_r].reshape(-1)
            o = sd[f"{p}.attn.out_proj.weight"]                 # (W, H * hd)
            o = o * (1.0 if hz is None else hz[:, None]) * mha_z
            if heads_z is not None:
                o = o.reshape(W, H, head_dim) * heads_z[None, :, None]
            o = o.reshape(W, H, head_dim)[keep][:, head_r]
            ob = sd[f"{p}.attn.out_proj.bias"]
            ob = (ob * (1.0 if hz is None else hz)) * mha_z
            ln(f"{p}.ln_1")
            out[f"{p}.attn.out_proj.weight"] = o.reshape(new_w, -1)
            out[f"{p}.attn.out_proj.bias"] = ob[keep]
        if has_ffn and ffn_z != 0.0 and len(inter_r):
            out[f"{p}.mlp.c_fc.weight"] = sd[f"{p}.mlp.c_fc.weight"][inter_r][:, keep]
            out[f"{p}.mlp.c_fc.bias"] = sd[f"{p}.mlp.c_fc.bias"][inter_r]
            c = sd[f"{p}.mlp.c_proj.weight"]                    # (W, I)
            c = c * (1.0 if inter_z is None else inter_z[None, :]) \
                * (1.0 if hz is None else hz[:, None]) * ffn_z
            cb = sd[f"{p}.mlp.c_proj.bias"]
            cb = (cb * (1.0 if hz is None else hz)) * ffn_z
            ln(f"{p}.ln_2")
            out[f"{p}.mlp.c_proj.weight"] = c[keep][:, inter_r]
            out[f"{p}.mlp.c_proj.bias"] = cb[keep]
    return out


def prune_clip_state_dict(state_dict, vision_masks: dict | None, text_masks: dict | None,
                          head_dim: int = 64) -> dict[str, torch.Tensor]:
    """A CLIP state_dict (open_clip names, full or ragged) with its gates
    materialized: gated-off hidden channels, heads and MLP channels
    removed; a branch whose gate is 0, or whose heads or channels are all
    off, removed with its LayerNorm; the soft gate values folded into the
    weights (hidden_z into conv1, the class and positional embeddings, the
    token embedding, out_proj and c_proj; heads_z into out_proj's columns;
    intermediate_z into c_proj's; mha_z / ffn_z into the branch outputs).
    A tower without masks is kept as it is. Returns fp32 CPU tensors."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in state_dict.items()}
    out = {k: v for k, v in sd.items() if k == "logit_scale"}
    for masks, text in ((vision_masks, False), (text_masks, True)):
        mine = {k: v for k, v in sd.items()
                if k != "logit_scale" and k.startswith("visual.") != text}
        out.update(_prune_tower(sd, masks, head_dim, text) if masks else mine)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def prune_clip(state_dict, cfg: CLIPConfig, vision_masks: dict | None,
               text_masks: dict | None, quick_gelu: bool = False, *,
               dtype: torch.dtype = torch.float32, device, head_dim: int = 64):
    """An L0-pruned CLIP materialized (host-side, as the JAX package's
    `prune_clip`): (the ragged model on `device` with the pruned weights
    loaded, its state_dict). `cfg` gives the family's depths and input
    sizes; the widths, heads and MLP widths come off the pruned shapes."""
    from cream_tpu_torch.zoo.load import clip_geometry
    sd = prune_clip_state_dict(state_dict, vision_masks, text_masks, head_dim)
    g = clip_geometry(sd, cfg.vision_layers, cfg.text_layers, head_dim)
    new_cfg = dataclasses.replace(cfg, embed_dim=g.pop("embed_dim"),
                                  vision_width=g.pop("vision_width"),
                                  text_width=g.pop("text_width"))
    model = CLIP(new_cfg, quick_gelu, **g, dtype=dtype, device=device)
    model.load_state_dict(sd)
    return model, sd


def _with_img_size(cfg: CLIPConfig, img_size: int | None) -> CLIPConfig:
    return cfg if img_size is None else dataclasses.replace(cfg, image_size=img_size)


# configs from TinyCLIP/src/open_clip/model_configs/*.json
CLIP_CONFIGS = {
    "tinyclip_vit_39m_16_text_19m": CLIPConfig(
        vision_width=512, vision_layers=12, vision_patch=16,
        text_width=512, text_layers=6),
    "tinyclip_vit_8m_16_text_3m": CLIPConfig(
        vision_width=256, vision_layers=10, vision_patch=16,
        text_width=256, text_layers=3, text_heads=4),
    "tinyclip_vit_40m_32_text_19m": CLIPConfig(
        vision_width=512, vision_layers=12, vision_patch=32,
        text_width=512, text_layers=6),
    "tinyclip_vit_61m_32_text_29m": CLIPConfig(
        vision_width=640, vision_layers=12, vision_patch=32,
        text_width=512, text_layers=9),
    "clip_vit_b_16": CLIPConfig(vision_width=768, vision_layers=12, vision_patch=16),
    "clip_vit_b_32": CLIPConfig(vision_width=768, vision_layers=12, vision_patch=32),
}

# the classifier teachers; large/14 is TinyViT/models/build.py:29-34
# (embed_dim 768, width 1024, 24 layers, patch 14)
CLIP_CLASSIFIER_CONFIGS = {
    "clip_vit_b_16_classifier": CLIP_CONFIGS["clip_vit_b_16"],
    "clip_vit_b_32_classifier": CLIP_CONFIGS["clip_vit_b_32"],
    "clip_vit_large14_224_classifier": CLIPConfig(
        embed_dim=768, vision_width=1024, vision_layers=24, vision_patch=14),
}


def _clip_factory(name: str, cfg: CLIPConfig):
    def factory(quick_gelu: bool = False, img_size: int | None = None, *, device,
                dtype=torch.float32, **kw):
        return CLIP(_with_img_size(cfg, img_size), quick_gelu, dtype=dtype,
                    device=device, **kw)
    factory.__name__ = name
    return factory


def _classifier_factory(name: str, cfg: CLIPConfig):
    def factory(num_classes: int = 1000, quick_gelu: bool = False,
                img_size: int | None = None, *, device, dtype=torch.float32,
                model_shard: ModelShard | None = None):
        return CLIPClassifier(_with_img_size(cfg, img_size), num_classes, quick_gelu,
                              dtype=dtype, device=device, model_shard=model_shard)
    factory.__name__ = name
    return factory


for _name, _cfg in CLIP_CONFIGS.items():
    register_model(_clip_factory(_name, _cfg))
for _name, _cfg in CLIP_CLASSIFIER_CONFIGS.items():
    register_model(_classifier_factory(_name, _cfg))
