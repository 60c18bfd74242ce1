"""DETR with iRPE: the detection transformer with 2D relative position
encodings in its encoder's self-attention.

Counterpart of `cream_tpu/models/detr.py` (iRPE/DETR-with-iRPE/models/
{transformer.py,detr.py,position_encoding.py} and rpe_attention/). Batch
first (B, N, E) and NHWC maps, as the JAX package. Its call structure:

  * q is scaled by head_dim**-0.5 before `rpe_k` sees it; `rpe_q` takes
    k * scale and is transposed after; `rpe_v` acts on the attention
    matrix and adds to the output (rpe_attention_function.py:324-377);
  * the encoder attends q = k = src + pos, value = src; the decoder's
    self-attention q = k = tgt + query_pos, its cross-attention
    k = memory + pos (transformer.py:224-298);
  * a key padding mask fills the scores with -1e9, not -inf, so a fully
    padded row stays finite;
  * the scores and softmax are fp32 (sums of products of compute-dtype
    values), P and P·V are cast to the compute dtype, as in DeiT's port;
  * LayerNorms take flax's eps 1e-6 (the torch reference's is 1e-5);
  * `decoder.norm` is applied to every decoder layer's output, and the
    auxiliary outputs share `class_embed` and `bbox_embed`.

No TPU kernel lies on this path: the attention, the frozen-BN convs and the
GEMMs are library math in JAX as well. The reference's dropout is absent, as
in JAX. Parameter names are the reference's (`backbone.0.body.*`,
`input_proj`, `query_embed.weight`, `transformer.encoder.layers.{i}.
{self_attn.in_proj_weight,self_attn.in_proj_bias,self_attn.out_proj,
self_attn.rpe_k.lookup_table_weight,linear1,linear2,norm1,norm2}`,
`transformer.decoder.layers.{i}.{self_attn,multihead_attn,...,norm3}`,
`transformer.decoder.norm`, `class_embed`, `bbox_embed.layers.{i}`), so a
released DETR(+iRPE) checkpoint loads as it is. Input NHWC images and an
optional (B, H, W) pixel mask, True where padded.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.models.resnet import ResNetBackbone, resnet18_backbone, resnet50_backbone
from cream_tpu_torch.nn.layers import layer_norm, linear
from cream_tpu_torch.nn.rpe import IRPE
from cream_tpu_torch.ops.rpe import RPEConfig, get_rpe_config

NEG_INF = -1e9
LN_EPS = 1e-6          # flax nn.LayerNorm's default


def parse_enc_rpe2d(spec: str) -> RPEConfig | None:
    """'rpe-{ratio}-{method}-{mode}-{shared_head}-{rpe_on}', the --enc_rpe2d
    format (transformer.py:51-69); '' gives None."""
    if not spec:
        return None
    sp = spec.split("-")
    if len(sp) != 6 or sp[0] != "rpe":
        raise ValueError(f"enc_rpe2d {spec!r} is not rpe-ratio-method-mode-shared-on")
    return get_rpe_config(ratio=float(sp[1]), method=sp[2], mode=sp[3],
                          shared_head=bool(int(sp[4])), skip=0, rpe_on=sp[5])


class RPEMultiheadAttention(nn.Module):
    """Multi-head attention with optional 2D iRPE on q, k and v, batch
    first; torch's packed `in_proj_weight` (3E, E) / `in_proj_bias` and an
    `out_proj`. `hw` is the key grid the iRPE tables are made for."""

    def __init__(self, embed_dim: int, num_heads: int, rpe_config: RPEConfig | None = None,
                 *, dtype: torch.dtype, device=None):
        super().__init__()
        self.embed_dim, self.num_heads, self.dtype = embed_dim, num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, device=device))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)
        d = embed_dim // num_heads
        for name in ("rpe_q", "rpe_k", "rpe_v"):
            cfg = None if rpe_config is None else getattr(rpe_config, name)
            setattr(self, name, None if cfg is None else IRPE(
                d, num_heads, cfg, transposed=name != "rpe_v", dtype=dtype, device=device))

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_padding_mask: torch.Tensor | None = None,
                hw: tuple[int, int] | None = None) -> torch.Tensor:
        E, h, dt = self.embed_dim, self.num_heads, self.dtype
        d = E // h
        scale = float(d) ** -0.5
        B, Lq, _ = query.shape
        Lk = key.shape[1]
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        q = F.linear(query, w[:E], b[:E]) * scale
        k = F.linear(key, w[E:2 * E], b[E:2 * E])
        v = F.linear(value, w[2 * E:], b[2 * E:])
        q = q.view(B, Lq, h, d).transpose(1, 2)
        k = k.view(B, Lk, h, d).transpose(1, 2)
        v = v.view(B, Lk, h, d).transpose(1, 2)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if self.rpe_k is not None:
            sim = sim + self.rpe_k(q, hw)
        if self.rpe_q is not None:
            sim = sim + self.rpe_q(k * scale, hw).transpose(-1, -2)
        if key_padding_mask is not None:
            sim = sim.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        attn = torch.softmax(sim, dim=-1).to(dt)
        out = torch.matmul(attn.float(), v.float()).to(dt)
        if self.rpe_v is not None:
            out = out + self.rpe_v(attn, hw)
        return linear(self.out_proj, out.transpose(1, 2).reshape(B, Lq, E), dt)


class _Layer(nn.Module):
    """The FFN (`linear1`, ReLU, `linear2`) and the LayerNorms of a layer."""

    def _ffn_init(self, d_model: int, dim_feedforward: int, n_norms: int, dtype, device):
        self.dtype = dtype
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        for i in range(n_norms):
            setattr(self, f"norm{i + 1}", nn.LayerNorm(d_model, eps=LN_EPS, device=device))

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.linear2, F.relu(linear(self.linear1, x, self.dtype)), self.dtype)

    def ln(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(getattr(self, f"norm{i}"), x, self.dtype)


def _add(a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return a if b is None else a + b


class TransformerEncoderLayer(_Layer):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 normalize_before: bool = False, rpe_config: RPEConfig | None = None, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = RPEMultiheadAttention(d_model, nhead, rpe_config, dtype=dtype,
                                               device=device)
        self._ffn_init(d_model, dim_feedforward, 2, dtype, device)

    def forward(self, src, src_key_padding_mask=None, pos=None, hw=None) -> torch.Tensor:
        def attn_block(x):
            q = _add(x, pos)
            return self.self_attn(q, q, x, src_key_padding_mask, hw)
        if self.normalize_before:
            src = src + attn_block(self.ln(1, src))
            return src + self.ffn(self.ln(2, src))
        src = self.ln(1, src + attn_block(src))
        return self.ln(2, src + self.ffn(src))


class TransformerDecoderLayer(_Layer):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 normalize_before: bool = False, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = RPEMultiheadAttention(d_model, nhead, dtype=dtype, device=device)
        self.multihead_attn = RPEMultiheadAttention(d_model, nhead, dtype=dtype, device=device)
        self._ffn_init(d_model, dim_feedforward, 3, dtype, device)

    def forward(self, tgt, memory, memory_key_padding_mask=None, pos=None,
                query_pos=None) -> torch.Tensor:
        def self_block(x):
            q = _add(x, query_pos)
            return self.self_attn(q, q, x)

        def cross_block(x):
            return self.multihead_attn(_add(x, query_pos), _add(memory, pos), memory,
                                       memory_key_padding_mask)
        if self.normalize_before:
            tgt = tgt + self_block(self.ln(1, tgt))
            tgt = tgt + cross_block(self.ln(2, tgt))
            return tgt + self.ffn(self.ln(3, tgt))
        tgt = self.ln(1, tgt + self_block(tgt))
        tgt = self.ln(2, tgt + cross_block(tgt))
        return self.ln(3, tgt + self.ffn(tgt))


class _Stack(nn.Module):
    """`layers` and an optional final `norm` (torch's TransformerEncoder /
    TransformerDecoder containers)."""

    def __init__(self, layers: list, d_model: int | None, device):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if d_model is not None:
            self.norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)


class DETRTransformer(nn.Module):
    """Encoder-decoder over an NHWC map (transformer.py:98-111): returns the
    decoder-normed output of every decoder layer (layers, B, Q, E) and the
    encoded memory (B, H, W, C)."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 normalize_before: bool = False, rpe_config: RPEConfig | None = None, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.normalize_before = dtype, normalize_before
        kw = dict(dtype=dtype, device=device)
        self.encoder = _Stack(
            [TransformerEncoderLayer(d_model, nhead, dim_feedforward, normalize_before,
                                     rpe_config, **kw) for _ in range(num_encoder_layers)],
            d_model if normalize_before else None, device)
        self.decoder = _Stack(
            [TransformerDecoderLayer(d_model, nhead, dim_feedforward, normalize_before, **kw)
             for _ in range(num_decoder_layers)], d_model, device)

    def forward(self, src: torch.Tensor, mask: torch.Tensor | None,
                query_embed: torch.Tensor, pos_embed: torch.Tensor):
        B, H, W, C = src.shape
        x = src.reshape(B, H * W, C)
        pos = pos_embed.reshape(B, H * W, C)
        kpm = None if mask is None else mask.reshape(B, H * W)
        for layer in self.encoder.layers:
            x = layer(x, kpm, pos, hw=(H, W))
        if self.normalize_before:
            x = layer_norm(self.encoder.norm, x, self.dtype)
        memory = x
        q = query_embed[None].expand(B, -1, -1)
        tgt = torch.zeros_like(q)
        inter = []
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, kpm, pos, q)
            inter.append(layer_norm(self.decoder.norm, tgt, self.dtype))
        return torch.stack(inter), memory.reshape(B, H, W, C)


def sine_position_embedding(mask: torch.Tensor, num_pos_feats: int = 128,
                            temperature: float = 10000.0, normalize: bool = True,
                            scale: float | None = None) -> torch.Tensor:
    """NHWC fp32 sine embedding of a (B, H, W) padding mask, True = pad
    (position_encoding.py:28-48): fp32 cumsums over the unpadded pixels,
    normalized with eps 1e-6 to [0, scale]; sin and cos interleaved;
    channels [pos_y, pos_x]."""
    if scale is None:
        scale = 2 * math.pi
    not_mask = (~mask).float()
    y = torch.cumsum(not_mask, 1)
    x = torch.cumsum(not_mask, 2)
    if normalize:
        eps = 1e-6
        y = y / (y[:, -1:, :] + eps) * scale
        x = x / (x[:, :, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    dim_t = torch.from_numpy(dim_t.astype(np.float32)).to(mask.device)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()], -1).flatten(-2)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()], -1).flatten(-2)
    return torch.cat([py, px], -1)


class MLP(nn.Module):
    """The box head (detr.py:289-300): `layers.{i}` Linear, ReLU between."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int = 3,
                 *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b, device=device)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, fc in enumerate(self.layers):
            x = linear(fc, x, self.dtype)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DETR(nn.Module):
    """backbone -> 1x1 `input_proj` -> transformer -> `class_embed` /
    `bbox_embed` (detr.py:21-80). forward(images NHWC, pixel_mask=None) ->
    {"pred_logits" (B, Q, classes + 1), "pred_boxes" (B, Q, 4) sigmoid
    cxcywh, and with `aux_loss` "aux_outputs": those of the earlier decoder
    layers}. `canvas` is the image size the entry points feed it."""

    def __init__(self, backbone: ResNetBackbone, num_classes: int = 91, num_queries: int = 100,
                 hidden_dim: int = 256, nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 aux_loss: bool = False, rpe_config: RPEConfig | None = None,
                 canvas: int = 512, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_classes, self.num_queries, self.aux_loss = num_classes, num_queries, aux_loss
        self.canvas, self.dtype, self.hidden_dim = canvas, dtype, hidden_dim
        self.backbone = nn.ModuleList([backbone])
        self.input_proj = nn.Conv2d(backbone.num_channels, hidden_dim, 1, device=device)
        self.query_embed = nn.Embedding(num_queries, hidden_dim, device=device)
        self.transformer = DETRTransformer(hidden_dim, nhead, num_encoder_layers,
                                           num_decoder_layers, dim_feedforward,
                                           rpe_config=rpe_config, dtype=dtype, device=device)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1, device=device)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3, dtype=dtype, device=device)

    @property
    def img_size(self) -> int:
        return self.canvas

    def forward(self, images: torch.Tensor, pixel_mask: torch.Tensor | None = None) -> dict:
        dt = self.dtype
        if pixel_mask is None:
            pixel_mask = torch.zeros(images.shape[:3], dtype=torch.bool, device=images.device)
        feat, mask = self.backbone[0](images, pixel_mask)
        p = self.input_proj
        src = F.conv2d(feat.permute(0, 3, 1, 2), p.weight.to(dt), p.bias.to(dt))
        src = src.permute(0, 2, 3, 1)
        pos = sine_position_embedding(mask, self.hidden_dim // 2).to(dt)
        hs, _ = self.transformer(src, mask, self.query_embed.weight.to(dt), pos)
        logits = linear(self.class_embed, hs, dt)
        boxes = torch.sigmoid(self.bbox_embed(hs))
        out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
        if self.aux_loss:
            out["aux_outputs"] = [{"pred_logits": logits[i], "pred_boxes": boxes[i]}
                                  for i in range(logits.shape[0] - 1)]
        return out


@register_model
def detr_resnet50(enc_rpe2d: str = "", *, device, dtype: torch.dtype = torch.float32, **kw):
    """DETR-R50 (detr.py build(); enc_rpe2d 'rpe-2.0-product-ctx-1-k' is the
    paper's iRPE encoder setting)."""
    return DETR(resnet50_backbone(dtype=dtype, device=device), rpe_config=parse_enc_rpe2d(enc_rpe2d), dtype=dtype, device=device, **kw)


@register_model
def detr_resnet18(enc_rpe2d: str = "", *, device, dtype: torch.dtype = torch.float32, **kw):
    return DETR(resnet18_backbone(dtype=dtype, device=device), rpe_config=parse_enc_rpe2d(enc_rpe2d), dtype=dtype, device=device, **kw)
