"""AutoFormer: the one-shot ViT supernet with weight entanglement, and its
fixed subnets.

Counterpart of `cream_tpu/models/autoformer.py`
(AutoFormer/model/supernet_transformer.py with the `--gp --change_qk
--relative_position` options):
  * pre-LN encoder blocks with elastic embed dim, heads, MLP ratio and
    depth; a block past the sampled depth is skipped (the identity);
  * change_qkv: q/k/v width = 64 x sampled heads, the qkv rows interleaved
    (q0, k0, v0, q1, ...; qkv_super.py:72-77);
  * learned 2D relative positions on keys and values with the cls token's
    row and column at index 0 (multihead_super.py:14-65);
  * gp: the head reads the mean of the patch tokens (not the cls token).

The JAX package masks prefixes at the super widths so that one compiled
program serves the whole space. The port slices the super weights per call
(`nn/elastic.py`), as the reference does: a config costs no rebuild, so
`AutoFormerSuper` is one model object for every config of its space and a
step runs only the sampled widths. A config is the reference's dict
(`layer_num`, per-layer `embed_dim`, `num_heads`, `mlp_ratio`;
`sample_config`), given to `forward(x, config=...)` or fixed at build time
(`config=` "smallest", "largest", "seed:N" or a dict: the speed test's).

The attention keeps JAX's rounding points (`:206-221`): q·kᵀ and q·rpkᵀ as
fp32 products of compute-dtype operands, then the scale; the softmax in
fp32 and P cast to the compute dtype; P·v and P·rpv as fp32 products, each
cast back before the add. No TPU kernel lies on this path (the JAX
attention is plain jnp).

Parameter names are the reference's, which `cream_tpu.zoo.import_torch.
convert_autoformer_supernet` reads: `patch_embed_super.proj`, `cls_token`,
`pos_embed`, `blocks.{i}.{attn_layer_norm, attn.qkv, attn.proj,
attn.rel_pos_embed_{k,v}.embeddings_table_{v,h}, ffn_layer_norm, fc1,
fc2}`, `norm`, `head`. `AutoFormerSubnet` (the deployed, truly sliced
model; `extract_subnet`) keeps the names, its qkv rows as [q; k; v].
Input NHWC.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cream_tpu_torch.models.registry import register_model
from cream_tpu_torch.nn.act import gelu
from cream_tpu_torch.nn.elastic import (ElasticLayerNorm, ElasticLinear, slice_layer_norm,
                                        slice_linear, slice_qkv_interleaved)
from cream_tpu_torch.ops.common import drop_path

HEAD_DIM = 64  # change_qkv fixes the per-head dim at 64 (supernet_transformer.py:166)


# ---------------------------------------------------------------- search space

@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Choice lists (experiments/supernet/*.yaml SEARCH_SPACE)."""
    mlp_ratio: tuple = (3.5, 4.0)
    num_heads: tuple = (3, 4)
    depth: tuple = (12, 13, 14)
    embed_dim: tuple = (192, 216, 240)

    @property
    def super_embed_dim(self) -> int:
        return max(self.num_heads) * HEAD_DIM

    @property
    def super_depth(self) -> int:
        return max(self.depth)

    @property
    def super_mlp_ratio(self) -> float:
        return max(self.mlp_ratio)


SPACES = {
    "tiny": SearchSpace(),
    "small": SearchSpace(mlp_ratio=(3.0, 3.5, 4.0), num_heads=(5, 6, 7),
                         depth=(12, 13, 14), embed_dim=(320, 384, 448)),
    "base": SearchSpace(mlp_ratio=(3.0, 3.5, 4.0), num_heads=(9, 10),
                        depth=(14, 15, 16), embed_dim=(528, 576, 624)),
}


def sample_config(rng: np.random.Generator, space: SearchSpace) -> dict:
    """Uniform per-layer sampling (supernet_engine.py:13-24), the JAX
    package's draws in its order."""
    depth = int(rng.choice(space.depth))
    return {
        "layer_num": depth,
        "embed_dim": [int(rng.choice(space.embed_dim))] * depth,
        "num_heads": [int(rng.choice(space.num_heads)) for _ in range(depth)],
        "mlp_ratio": [float(rng.choice(space.mlp_ratio)) for _ in range(depth)],
    }


def encode_config(config: dict, space: SearchSpace) -> dict:
    """The JAX package's fixed-shape encoding of a config for its masked
    supernet (padded to the super depth), as numpy int32: what the JAX
    supernet takes for `config`. The port's supernet takes the config
    itself."""
    D = space.super_depth
    depth = config["layer_num"]
    emb = config["embed_dim"][0]
    heads = list(config["num_heads"]) + [max(space.num_heads)] * (D - depth)
    ffn = [int(e * r) for e, r in zip(config["embed_dim"], config["mlp_ratio"])]
    ffn = ffn + [int(emb * max(space.mlp_ratio))] * (D - depth)
    return {"embed_dim": np.int32(emb), "layer_num": np.int32(depth),
            "num_heads": np.asarray(heads, np.int32), "ffn_dim": np.asarray(ffn, np.int32)}


def fixed_config(space: SearchSpace, spec) -> dict:
    """A config from `spec`: "smallest" / "largest" (every choice at its
    least / most), "seed:N" (`sample_config` on default_rng(N)) or a config
    dict (returned as it is)."""
    if isinstance(spec, dict):
        return spec
    if spec in ("smallest", "largest"):
        pick = min if spec == "smallest" else max
        depth = pick(space.depth)
        return {"layer_num": depth, "embed_dim": [pick(space.embed_dim)] * depth,
                "num_heads": [pick(space.num_heads)] * depth,
                "mlp_ratio": [float(pick(space.mlp_ratio))] * depth}
    if isinstance(spec, str) and spec.startswith("seed:"):
        return sample_config(np.random.default_rng(int(spec[5:])), space)
    raise ValueError(f"config must be 'smallest', 'largest', 'seed:N' or a dict, got {spec!r}")


def config_param_count(config: dict, num_classes: int = 1000, num_patches: int = 196,
                       max_relative_position: int = 14) -> int:
    """Analytic param count of a subnet (get_sampled_params_numel,
    supernet_transformer.py:129-146)."""
    emb = config["embed_dim"][0]
    n = emb * 3 * 16 * 16 + emb            # patch conv + bias
    n += emb * (2 + num_patches)           # cls + pos (the reference counts these)
    rel_table = 2 * (2 * max_relative_position + 2) * HEAD_DIM
    for i in range(config["layer_num"]):
        qd = config["num_heads"][i] * HEAD_DIM
        ffn = int(emb * config["mlp_ratio"][i])
        n += emb * 3 * qd + 3 * qd         # qkv
        n += qd * emb + emb                # proj
        n += 2 * rel_table                 # rel pos k and v
        n += 2 * 2 * emb                   # two LayerNorms
        n += emb * ffn + ffn + ffn * emb + emb  # fc1, fc2
    n += 2 * emb                           # final norm
    n += emb * num_classes + num_classes   # head
    return n


def config_flops(config: dict, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000) -> int:
    """Analytic MACs of a subnet (get_complexity,
    supernet_transformer.py:142-146)."""
    emb = config["embed_dim"][0]
    n_tok = (img_size // patch_size) ** 2 + 1
    macs = (img_size // patch_size) ** 2 * emb * 3 * patch_size ** 2  # patch
    for i in range(config["layer_num"]):
        qd = config["num_heads"][i] * HEAD_DIM
        ffn = int(emb * config["mlp_ratio"][i])
        macs += n_tok * emb * 3 * qd          # qkv
        macs += n_tok * n_tok * qd * 2        # qk^T + av
        macs += n_tok * qd * emb              # proj
        macs += n_tok * emb * ffn * 2         # fc1 + fc2
    macs += emb * num_classes
    return macs


def ffn_dims(config: dict) -> list[int]:
    return [int(e * r) for e, r in zip(config["embed_dim"], config["mlp_ratio"])]


# ------------------------------------------------------- relative position 2D

@functools.lru_cache(maxsize=None)
def rel_pos_index(seq_len: int, max_rel: int) -> tuple[np.ndarray, np.ndarray]:
    """(N, N) int index maps of the vertical and horizontal tables, the cls
    token's row and column at 0 (multihead_super.py:40-59)."""
    length = seq_len - 1
    s = int(length ** 0.5)
    r = np.arange(length)
    dv = r[None, :] // s - r[:, None] // s
    dh = r[None, :] % s - r[:, None] % s
    mv = np.clip(dv, -max_rel, max_rel) + max_rel + 1
    mh = np.clip(dh, -max_rel, max_rel) + max_rel + 1
    mv = np.pad(mv, ((1, 0), (1, 0)))
    mh = np.pad(mh, ((1, 0), (1, 0)))
    return mv.astype(np.int64), mh.astype(np.int64)


class RelativePosition2D(nn.Module):
    """Learned 2D relative-position embeddings (head dim 64):
    `forward(N, dtype)` -> (N, N, 64), tv[mv] + th[mh] in fp32, cast."""

    def __init__(self, max_relative_position: int = 14, *, device=None):
        super().__init__()
        self.max_relative_position = max_relative_position
        tdim = 2 * max_relative_position + 2
        self.embeddings_table_v = nn.Parameter(torch.empty(tdim, HEAD_DIM, device=device))
        self.embeddings_table_h = nn.Parameter(torch.empty(tdim, HEAD_DIM, device=device))
        for t in (self.embeddings_table_v, self.embeddings_table_h):
            nn.init.trunc_normal_(t, std=0.02)
        self._index: dict = {}

    def forward(self, seq_len: int, dtype: torch.dtype) -> torch.Tensor:
        device = self.embeddings_table_v.device
        key = (seq_len, device)
        if key not in self._index:
            self._index[key] = tuple(torch.from_numpy(m).to(device) for m in
                                     rel_pos_index(seq_len, self.max_relative_position))
        mv, mh = self._index[key]
        return (self.embeddings_table_v[mv] + self.embeddings_table_h[mh]).to(dtype)


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  rpk: torch.Tensor | None, rpv: torch.Tensor | None,
                  dtype: torch.dtype) -> torch.Tensor:
    """softmax((q kᵀ + q rpkᵀ)·64^-0.5) (v + rpv) on (B, h, N, 64) q, k, v
    and (N, N, 64) tables at JAX's rounding points (see the module's
    docstring)."""
    scale = HEAD_DIM ** -0.5
    qf = q.float()
    attn = torch.matmul(qf, k.float().transpose(-1, -2)) * scale
    if rpk is not None:
        attn = attn + torch.einsum("bhnd,nmd->bhnm", qf, rpk.float()) * scale
    p = torch.softmax(attn, dim=-1).to(dtype)
    pf = p.float()
    out = torch.matmul(pf, v.float()).to(dtype)
    if rpv is not None:
        out = out + torch.einsum("bhnm,nmd->bhnd", pf, rpv.float()).to(dtype)
    return out


# ------------------------------------------------------------------- blocks

class ElasticAttention(nn.Module):
    """Multi-head attention with relative positions on elastic widths.
    `interleaved` qkv rows (the supernet's) or [q; k; v] (a subnet's)."""

    def __init__(self, embed_dim: int, heads: int, rel_pos: bool = True,
                 max_relative_position: int = 14, interleaved: bool = True, *, device=None):
        super().__init__()
        self.interleaved = interleaved
        self.qkv = ElasticLinear(embed_dim, 3 * heads * HEAD_DIM, device=device)
        self.proj = ElasticLinear(heads * HEAD_DIM, embed_dim, device=device)
        for fc in (self.qkv, self.proj):
            nn.init.xavier_uniform_(fc.weight)
            nn.init.zeros_(fc.bias)
        self.rel_pos_embed_k = self.rel_pos_embed_v = None
        if rel_pos:
            self.rel_pos_embed_k = RelativePosition2D(max_relative_position, device=device)
            self.rel_pos_embed_v = RelativePosition2D(max_relative_position, device=device)

    def forward(self, x: torch.Tensor, heads: int, dtype: torch.dtype) -> torch.Tensor:
        B, N, emb = x.shape
        qd = heads * HEAD_DIM
        y = self.qkv(x, 3 * qd, dtype)
        if self.interleaved:   # unit u = (head, d), then (q, k, v)
            q, k, v = y.view(B, N, heads, HEAD_DIM, 3).permute(4, 0, 2, 1, 3)
        else:
            q, k, v = y.view(B, N, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
        rpk = rpv = None
        if self.rel_pos_embed_k is not None:
            rpk = self.rel_pos_embed_k(N, dtype)
            rpv = self.rel_pos_embed_v(N, dtype)
        out = rel_attention(q, k, v, rpk, rpv, dtype)
        return self.proj(out.transpose(1, 2).reshape(B, N, qd), emb, dtype)


class ElasticEncoderLayer(nn.Module):
    """Pre-LN block: x + attn(LN(x)); x + fc2(GELU(fc1(LN(x)))), drop path
    on both branches in train mode."""

    def __init__(self, embed_dim: int, heads: int, ffn_dim: int, drop_path_rate: float = 0.0,
                 rel_pos: bool = True, max_relative_position: int = 14,
                 interleaved: bool = True, *, device=None):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.attn_layer_norm = ElasticLayerNorm(embed_dim, device=device)
        self.attn = ElasticAttention(embed_dim, heads, rel_pos, max_relative_position,
                                     interleaved, device=device)
        self.ffn_layer_norm = ElasticLayerNorm(embed_dim, device=device)
        self.fc1 = ElasticLinear(embed_dim, ffn_dim, device=device)
        self.fc2 = ElasticLinear(ffn_dim, embed_dim, device=device)
        for fc in (self.fc1, self.fc2):
            nn.init.xavier_uniform_(fc.weight)
            nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor, heads: int, ffn: int, dtype: torch.dtype,
                generator: torch.Generator | None = None) -> torch.Tensor:
        emb, eval_ = x.shape[-1], not self.training
        h = self.attn(self.attn_layer_norm(x, dtype), heads, dtype)
        x = x + drop_path(h, self.drop_path_rate, eval_, generator)
        h = gelu(self.fc1(self.ffn_layer_norm(x, dtype), ffn, dtype))
        return x + drop_path(self.fc2(h, emb, dtype), self.drop_path_rate, eval_, generator)


class PatchEmbed(nn.Module):
    """p x p stride-p conv with bias; `forward(x, emb, dtype)` takes the
    first `emb` output channels: NHWC images -> (B, grid², emb) tokens."""

    def __init__(self, embed_dim: int, patch_size: int, *, device=None):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size, device=device)

    def forward(self, x: torch.Tensor, emb: int, dtype: torch.dtype) -> torch.Tensor:
        p = self.proj
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), p.weight[:emb].to(dtype),
                     p.bias[:emb].to(dtype), p.stride)
        return y.flatten(2).transpose(1, 2)


class _AutoFormer(nn.Module):
    """The token pipeline both models share: patch conv, cls token,
    absolute positions, the blocks, the last LayerNorm and the head, on the
    widths of `config`."""

    def __init__(self, embed_dim: int, heads: list[int], ffn: list[int], num_classes: int,
                 img_size: int, patch_size: int, drop_path_rate: float, gp: bool,
                 abs_pos: bool, rel_pos: bool, max_relative_position: int, interleaved: bool,
                 dtype: torch.dtype, device):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of patch {patch_size}")
        self.img_size, self.num_classes, self.gp, self.dtype = img_size, num_classes, gp, dtype
        depth = len(heads)
        n_tok = (img_size // patch_size) ** 2 + 1
        self.patch_embed_super = PatchEmbed(embed_dim, patch_size, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, device=device))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        self.pos_embed = None
        if abs_pos:
            self.pos_embed = nn.Parameter(torch.empty(1, n_tok, embed_dim, device=device))
            nn.init.trunc_normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(
            ElasticEncoderLayer(embed_dim, heads[i], ffn[i],
                                drop_path_rate * i / max(depth - 1, 1), rel_pos,
                                max_relative_position, interleaved, device=device)
            for i in range(depth))
        self.norm = ElasticLayerNorm(embed_dim, device=device)
        self.head = ElasticLinear(embed_dim, num_classes, device=device)
        nn.init.xavier_uniform_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def _forward(self, x: torch.Tensor, config: dict,
                 generator: torch.Generator | None) -> torch.Tensor:
        if tuple(x.shape[1:]) != (self.img_size, self.img_size, 3):
            raise ValueError(f"expected (B, {self.img_size}, {self.img_size}, 3) NHWC input, "
                             f"got {tuple(x.shape)}")
        B, dt = x.shape[0], self.dtype
        emb, depth = config["embed_dim"][0], config["layer_num"]
        x = self.patch_embed_super(x, emb, dt)
        x = torch.cat([self.cls_token[..., :emb].to(dt).expand(B, -1, -1), x], dim=1)
        if self.pos_embed is not None:
            x = x + self.pos_embed[..., :emb].to(dt)
        for block, heads, ffn in zip(self.blocks[:depth], config["num_heads"], ffn_dims(config)):
            x = block(x, heads, ffn, dt, generator)
        x = self.norm(x, dt)
        feat = x[:, 1:].mean(dim=1) if self.gp else x[:, 0]
        return self.head(feat, self.num_classes, dt)


class AutoFormerSuper(_AutoFormer):
    """The supernet of `space` at its super widths (embed = 64 x max heads,
    MLP = embed x max ratio, depth = max depth). `forward(x, config=...)`
    runs the config's subnet on views of the super weights; without a
    config it runs `self.config` (set at build time, e.g. for a speed
    test). Drop path grows from 0 to `drop_path_rate` over the super depth
    (JAX's default 0.1) and draws from the generator given to forward."""

    def __init__(self, space: SearchSpace = SPACES["tiny"], num_classes: int = 1000,
                 img_size: int = 224, patch_size: int = 16, drop_path_rate: float = 0.1,
                 gp: bool = True, abs_pos: bool = True, rel_pos: bool = True,
                 max_relative_position: int = 14, config=None, *,
                 dtype: torch.dtype = torch.float32, device=None):
        U, D = space.super_embed_dim, space.super_depth
        F_ = int(U * space.super_mlp_ratio)
        super().__init__(U, [max(space.num_heads)] * D, [F_] * D, num_classes, img_size,
                         patch_size, drop_path_rate, gp, abs_pos, rel_pos,
                         max_relative_position, True, dtype, device)
        self.space, self.patch_size = space, patch_size
        self.max_relative_position = max_relative_position
        self.rel_pos, self.abs_pos = rel_pos, abs_pos
        self.config = None if config is None else fixed_config(space, config)

    def check_config(self, config: dict) -> None:
        """Raises unless `config` fits the super widths."""
        sp = self.space
        depth = config["layer_num"]
        ok = (0 < depth <= sp.super_depth
              and all(len(config[k]) >= depth for k in ("embed_dim", "num_heads", "mlp_ratio"))
              and len(set(config["embed_dim"][:depth])) == 1
              and 0 < config["embed_dim"][0] <= sp.super_embed_dim
              and all(0 < h <= max(sp.num_heads) for h in config["num_heads"][:depth])
              and all(0 < f <= int(sp.super_embed_dim * sp.super_mlp_ratio)
                      for f in ffn_dims(config)[:depth]))
        if not ok:
            raise ValueError(f"config does not fit the supernet's widths: {config}")

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None, *,
                config: dict | None = None) -> torch.Tensor:
        config = self.config if config is None else config
        if config is None:
            raise ValueError("AutoFormerSuper.forward needs a config (or one fixed at build)")
        self.check_config(config)
        return self._forward(x, config, generator)


class AutoFormerSubnet(_AutoFormer):
    """A plain fixed-width ViT for a deployed subnet (the RETRAIN genotypes,
    experiments/subnet/AutoFormer-{T,S,B}.yaml): per-layer heads and MLP
    ratios, qkv rows as [q; k; v]. No drop path (JAX's has none)."""

    def __init__(self, embed_dim: int, depth: int, num_heads, mlp_ratio,
                 num_classes: int = 1000, img_size: int = 224, patch_size: int = 16,
                 gp: bool = True, abs_pos: bool = True, rel_pos: bool = True,
                 max_relative_position: int = 14, *, dtype: torch.dtype = torch.float32,
                 device=None):
        config = {"layer_num": depth, "embed_dim": [embed_dim] * depth,
                  "num_heads": [int(h) for h in num_heads[:depth]],
                  "mlp_ratio": [float(r) for r in mlp_ratio[:depth]]}
        super().__init__(embed_dim, config["num_heads"], ffn_dims(config), num_classes,
                         img_size, patch_size, 0.0, gp, abs_pos, rel_pos,
                         max_relative_position, False, dtype, device)
        self.config = config

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        return self._forward(x, self.config, generator)


@torch.no_grad()
def extract_subnet(model: AutoFormerSuper, config: dict) -> AutoFormerSubnet:
    """The truly sliced subnet of `config` (the prefix and interleaved
    entanglement rules, Linear_super.py:71-75, qkv_super.py:72-77, applied
    once), on the supernet's device and compute dtype, in eval mode."""
    model.check_config(config)
    emb, depth = config["embed_dim"][0], config["layer_num"]
    device = model.cls_token.device
    sub = AutoFormerSubnet(emb, depth, config["num_heads"], config["mlp_ratio"],
                           model.num_classes, model.img_size, model.patch_size, model.gp,
                           model.abs_pos, model.rel_pos, model.max_relative_position,
                           dtype=model.dtype, device=device)
    src = model.state_dict()
    sd = {"patch_embed_super.proj.weight": src["patch_embed_super.proj.weight"][:emb],
          "patch_embed_super.proj.bias": src["patch_embed_super.proj.bias"][:emb],
          "cls_token": src["cls_token"][..., :emb]}
    if model.abs_pos:
        sd["pos_embed"] = src["pos_embed"][..., :emb]

    def put(name, pair):
        sd[f"{name}.weight"], b = pair
        if b is not None:
            sd[f"{name}.bias"] = b

    for i, (heads, ffn) in enumerate(zip(config["num_heads"][:depth], ffn_dims(config))):
        p, qd = f"blocks.{i}", heads * HEAD_DIM
        for ln in ("attn_layer_norm", "ffn_layer_norm"):
            put(f"{p}.{ln}", slice_layer_norm(src[f"{p}.{ln}.weight"], src[f"{p}.{ln}.bias"],
                                              emb))
        put(f"{p}.attn.qkv", slice_qkv_interleaved(src[f"{p}.attn.qkv.weight"],
                                                   src[f"{p}.attn.qkv.bias"], emb, 3 * qd))
        for name, n_in, n_out in (("attn.proj", qd, emb), ("fc1", emb, ffn), ("fc2", ffn, emb)):
            put(f"{p}.{name}", slice_linear(src[f"{p}.{name}.weight"], src[f"{p}.{name}.bias"],
                                            n_in, n_out))
        for key, t in src.items():
            if key.startswith(f"{p}.attn.rel_pos_embed_"):
                sd[key] = t
    put("norm", slice_layer_norm(src["norm.weight"], src["norm.bias"], emb))
    put("head", slice_linear(src["head.weight"], src["head.bias"], emb, model.num_classes))
    sub.load_state_dict(sd)
    return sub.eval()


def _factory(name: str, space: SearchSpace):
    def factory(num_classes: int = 1000, img_size: int = 224, drop_path_rate: float = 0.1,
                config=None, *, device, dtype=torch.float32):
        return AutoFormerSuper(space, num_classes=num_classes, img_size=img_size,
                               drop_path_rate=drop_path_rate, config=config, dtype=dtype,
                               device=device)
    factory.__name__ = name
    return factory


for _size, _space in SPACES.items():
    register_model(_factory(f"autoformer_supernet_{_size}", _space))
