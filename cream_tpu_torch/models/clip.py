"""CLIP two-tower models with TinyCLIP's L0 gates, and the CLIP classifier
teacher.

Counterpart of `cream_tpu/models/clip.py` (TinyCLIP/src/open_clip/model.py:
VisualTransformer, the text Transformer and CLIP), eval only. Every block
takes TinyCLIP's gate set:

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
    rows are [q(h0..hH); k; v] as in torch's MultiheadAttention."""

    def __init__(self, width: int, heads: int, head_dim: int = 64, *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.heads, self.head_dim, self.dtype = heads, head_dim, dtype
        inner = heads * head_dim
        self.in_proj_weight = nn.Parameter(torch.empty(3 * inner, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * inner, device=device))
        self.out_proj = nn.Linear(inner, width, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                heads_z: Optional[torch.Tensor] = None,
                hidden_z: Optional[torch.Tensor] = None) -> torch.Tensor:
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
            out = out * heads_z.view(1, H, 1, 1).to(dt)
        out = linear(self.out_proj, out.transpose(1, 2).reshape(B, L, H * hd), dt)
        if hidden_z is not None:
            out = out * hidden_z.to(dt)
        return out


class Mlp(nn.Module):
    """open_clip's `mlp`: c_fc -> activation -> c_proj."""

    def __init__(self, width: int, hidden: int, *, device=None):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden, device=device)
        self.c_proj = nn.Linear(hidden, width, device=device)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block; heads == 0 or mlp_width == 0 means that branch was
    pruned away: the sublayer is skipped and owns no parameters."""

    def __init__(self, width: int, heads: int, mlp_width: int, act: str = "gelu",
                 head_dim: int = 64, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.act = quick_gelu if act == "quick_gelu" else gelu
        if heads > 0:
            self.ln_1 = MaskedLayerNorm(width, dtype=dtype, device=device)
            self.attn = GatedAttention(width, heads, head_dim, dtype=dtype, device=device)
        if mlp_width > 0:
            self.ln_2 = MaskedLayerNorm(width, dtype=dtype, device=device)
            self.mlp = Mlp(width, mlp_width, device=device)

    def forward(self, x: torch.Tensor, attn_mask=None, hidden_z=None, heads_z=None,
                mha_z=None, intermediate_z=None, ffn_z=None) -> torch.Tensor:
        dt = self.dtype
        if hasattr(self, "attn"):
            h = self.attn(self.ln_1(x, hidden_z), attn_mask, heads_z, hidden_z)
            if mha_z is not None:
                h = h * mha_z.to(dt)
            x = x + h
        if hasattr(self, "mlp"):
            h = self.act(linear(self.mlp.c_fc, self.ln_2(x, hidden_z), dt))
            if intermediate_z is not None:
                h = h * intermediate_z.to(dt)
            h = linear(self.mlp.c_proj, h, dt)
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
    """`resblocks`, with per-layer head counts and MLP widths."""

    def __init__(self, width: int, layers: int, heads: Sequence[int],
                 mlp_widths: Sequence[int], act: str = "gelu", remat: bool = False, *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        if remat:
            raise NotImplementedError(
                "CLIPTransformer(remat=True) is a training memory option; the port "
                "evaluates only")
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads[i], mlp_widths[i], act,
                                   dtype=dtype, device=device)
            for i in range(layers))

    def forward(self, x: torch.Tensor, attn_mask=None, masks: Optional[dict] = None):
        for i, block in enumerate(self.resblocks):
            x = block(x, attn_mask, **_layer_gates(masks, i))
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
                 device=None):
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
            device=device)
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
                 device=None):
        super().__init__()
        self.dtype, self.context_length = dtype, context_length
        self.token_embedding = nn.Embedding(vocab_size, width, device=device)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(context_length, width, device=device))
        self.transformer = CLIPTransformer(
            width, layers, tuple(heads or [width // 64] * layers),
            tuple(mlp_widths or [width * 4] * layers), act, remat, dtype=dtype,
            device=device)
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
    dicts (see the module docstring)."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig(), quick_gelu: bool = False,
                 vision_heads: Sequence[int] | None = None,
                 vision_mlp_widths: Sequence[int] | None = None,
                 text_heads_per_layer: Sequence[int] | None = None,
                 text_mlp_widths: Sequence[int] | None = None, remat: bool = False, *,
                 dtype: torch.dtype = torch.float32, device=None):
        act = "quick_gelu" if quick_gelu else "gelu"
        c = cfg
        super().__init__(c.context_length, c.vocab_size, c.text_width, c.text_layers,
                         text_heads_per_layer or [c.text_heads] * c.text_layers,
                         text_mlp_widths, c.embed_dim, act, remat, dtype=dtype,
                         device=device)
        self.cfg, self.img_size = cfg, c.image_size
        self.visual = VisionTower(c.image_size, c.vision_patch, c.vision_width,
                                  c.vision_layers, vision_heads, vision_mlp_widths,
                                  c.embed_dim, act, remat, dtype=dtype, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07)), device=device))

    def encode_image(self, image, masks=None, normalized: bool = True):
        return self.visual(image, masks=masks, normalized=normalized)

    def forward(self, image, text, image_masks=None, text_masks=None):
        return (self.encode_image(image, image_masks), self.encode_text(text, text_masks),
                self.logit_scale.exp())


class CLIPClassifier(nn.Module):
    """The CLIP vision tower and a linear head: TinyViT's distillation
    teacher (TinyViT/models/clip.py:108-158). Logits = head(proj(features));
    a 22k head's logits go through the 22k -> 1k remap in save_logits."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig(), num_classes: int = 1000,
                 quick_gelu: bool = False, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        c = cfg
        self.cfg, self.img_size, self.dtype = cfg, c.image_size, dtype
        self.visual = VisionTower(c.image_size, c.vision_patch, c.vision_width,
                                  c.vision_layers, output_dim=c.embed_dim,
                                  act="quick_gelu" if quick_gelu else "gelu",
                                  dtype=dtype, device=device)
        self.head = nn.Linear(c.embed_dim, num_classes, device=device)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return linear(self.head, self.visual(image), self.dtype)


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
                img_size: int | None = None, *, device, dtype=torch.float32):
        return CLIPClassifier(_with_img_size(cfg, img_size), num_classes, quick_gelu,
                              dtype=dtype, device=device)
    factory.__name__ = name
    return factory


for _name, _cfg in CLIP_CONFIGS.items():
    register_model(_clip_factory(_name, _cfg))
for _name, _cfg in CLIP_CLASSIFIER_CONFIGS.items():
    register_model(_classifier_factory(_name, _cfg))
