"""Weights for the port: released .pth files, the JAX package's variables,
and seeded random weights.

The port's parameter names are the released microsoft/Cream TinyViT,
EfficientViT, Swin/S3 and Mini-Swin names, so a released checkpoint loads
with `model.load_state_dict` once `load_pth` has read it, and the JAX
package's `cream_tpu.zoo.import_torch.convert_tinyvit` /
`convert_efficientvit` / `convert_swin` / `convert_mini_swin` map a port
state_dict to its variables. `state_dict_from_jax`,
`efficientvit_state_dict_from_jax`, `swin_state_dict_from_jax` and
`mini_swin_state_dict_from_jax` are their exact inverses;
`bias_attention_state_dict_from_jax` carries a JAX `BiasAttention`'s
variables to the port's module.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch


# buffers of released files that the port's models rebuild from shapes:
# TinyViT/EfficientViT's attention index, Swin/S3's relative position index
# and shifted-window mask
REBUILT_BUFFERS = ("attention_bias_idxs", "relative_position_index", "attn_mask")


def load_pth(path: str) -> dict[str, torch.Tensor]:
    """A released TinyViT, EfficientViT, Swin/S3 or Mini-Swin .pth ->
    state_dict for the port's model. The buffers the model rebuilds
    (`REBUILT_BUFFERS`) are dropped, and 1x1 conv weights stored 2-D, as
    released EfficientViT files store some, get their two unit axes back
    (the reference's `model/build.py:76-83` does the same)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: v[:, :, None, None] if k.endswith(".c.weight") and v.ndim == 2 else v
            for k, v in ckpt.items() if not k.endswith(REBUILT_BUFFERS)}


def load_for_model(model: torch.nn.Module, path: str) -> dict[str, torch.Tensor]:
    """`load_pth(path)` for `model`: where a position table's shape differs
    from the model's (`attention_biases`, `relative_position_bias_table`,
    `absolute_pos_embed`), it is bicubic-remapped (torch's A = -0.75) as the
    JAX loader's `load_model_variables(template=...)` and the reference's
    `load_pretrained` remap it (224 -> 384 -> 512 checkpoint inheritance);
    any other mismatch raises."""
    from cream_tpu_torch.zoo.interpolate import remap_resolution
    sd = load_pth(path)
    template = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return {k: torch.as_tensor(v) for k, v in remap_resolution(sd, template).items()}


def _conv(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _dense(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k).T)                      # (in, out) -> (out, in)


class _Writer:
    def __init__(self, variables: Mapping):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree: Mapping, path: str):
        for k in path.split("/"):
            tree = tree[k]
        return tree

    def conv_bn(self, fp: str, tp: str):
        self.sd[f"{tp}.c.weight"] = _conv(self._get(self.params, f"{fp}/conv/kernel"))
        self.bn(f"{fp}/bn", f"{tp}.bn")

    def ln(self, fp: str, tp: str):
        node = self._get(self.params, fp)
        self.sd[f"{tp}.weight"] = np.asarray(node["scale"])
        self.sd[f"{tp}.bias"] = np.asarray(node["bias"])

    def dense(self, fp: str, tp: str):
        node = self._get(self.params, fp)
        self.sd[f"{tp}.weight"] = _dense(node["kernel"])
        if "bias" in node:
            self.sd[f"{tp}.bias"] = np.asarray(node["bias"])

    def bn(self, fp: str, tp: str):
        node, st = self._get(self.params, fp), self._get(self.stats, fp)
        self.sd[f"{tp}.weight"] = np.asarray(node["scale"])
        self.sd[f"{tp}.bias"] = np.asarray(node["bias"])
        self.sd[f"{tp}.running_mean"] = np.asarray(st["mean"])
        self.sd[f"{tp}.running_var"] = np.asarray(st["var"])
        self.sd[f"{tp}.num_batches_tracked"] = np.asarray(0, np.int64)

    def conv_biased(self, fp: str, tp: str):
        node = self._get(self.params, fp)
        self.sd[f"{tp}.weight"] = _conv(node["kernel"])
        self.sd[f"{tp}.bias"] = np.asarray(node["bias"])

    def raw(self, fp: str, tp: str):
        self.sd[tp] = np.asarray(self._get(self.params, fp))

    def state_dict(self) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.array(v)) for k, v in self.sd.items()}


def _depths(params: Mapping) -> tuple[int, ...]:
    count: dict[int, int] = {}
    for key in params:
        if key.startswith("stages_"):
            s = int(key.split("_")[1])
            count[s] = count.get(s, 0) + 1
    return tuple(count[s] for s in range(len(count)))


def state_dict_from_jax(variables: Mapping, with_head: bool = True
                        ) -> dict[str, torch.Tensor]:
    """The JAX package's TinyViT variables ({"params", "batch_stats"} trees of
    arrays) -> the port's state_dict. Inverse of `convert_tinyvit`."""
    w = _Writer(variables)
    depths = _depths(w.params)
    w.conv_bn("patch_embed/conv1", "patch_embed.seq.0")
    w.conv_bn("patch_embed/conv2", "patch_embed.seq.2")
    for s, depth in enumerate(depths):
        for i in range(depth):
            fp, tp = f"stages_{s}_{i}", f"layers.{s}.blocks.{i}"
            if s == 0:
                for c in ("conv1", "conv2", "conv3"):
                    w.conv_bn(f"{fp}/{c}", f"{tp}.{c}")
            else:
                w.ln(f"{fp}/attn/norm", f"{tp}.attn.norm")
                w.dense(f"{fp}/attn/qkv", f"{tp}.attn.qkv")
                w.dense(f"{fp}/attn/proj", f"{tp}.attn.proj")
                w.sd[f"{tp}.attn.attention_biases"] = np.asarray(
                    w._get(w.params, f"{fp}/attn/attention_biases"))
                w.conv_bn(f"{fp}/local_conv", f"{tp}.local_conv")
                w.ln(f"{fp}/mlp/norm", f"{tp}.mlp.norm")
                w.dense(f"{fp}/mlp/fc1", f"{tp}.mlp.fc1")
                w.dense(f"{fp}/mlp/fc2", f"{tp}.mlp.fc2")
        if s < len(depths) - 1:
            for c in ("conv1", "conv2", "conv3"):
                w.conv_bn(f"downsamples_{s}/{c}", f"layers.{s}.downsample.{c}")
    w.ln("norm_head", "norm_head")
    if with_head and "head" in w.params:
        w.dense("head", "head")
    return w.state_dict()


def bias_attention_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's `BiasAttention` variables ({"params": {norm, qkv,
    proj, attention_biases}}) -> the port's `nn.attention.BiasAttention`
    state_dict (the released TinyViT `Attention` names)."""
    w = _Writer(variables)
    w.ln("norm", "norm")
    w.dense("qkv", "qkv")
    w.dense("proj", "proj")
    w.raw("attention_biases", "attention_biases")
    return w.state_dict()


def efficientvit_state_dict_from_jax(variables: Mapping, with_head: bool = True
                                     ) -> dict[str, torch.Tensor]:
    """The JAX package's EfficientViT variables -> the port's state_dict
    (released names). Inverse of `convert_efficientvit`: each stage after
    the first opens with the subsample sandwich (`blocks{s}.0` / `.1` /
    `.2`) and its blocks follow from index 3."""
    w = _Writer(variables)
    depths = _depths(w.params)
    for j, tseq in enumerate((0, 2, 4, 6)):
        w.conv_bn(f"patch_embed_{j}", f"patch_embed.{tseq}")
    for s, depth in enumerate(depths):
        seq, off = f"blocks{s + 1}", 0
        if s > 0:
            sub = f"subsamples_{s - 1}"
            w.conv_bn(f"{sub}/pre_dw", f"{seq}.0.0.m")
            w.conv_bn(f"{sub}/pre_ffn/pw1", f"{seq}.0.1.m.pw1")
            w.conv_bn(f"{sub}/pre_ffn/pw2", f"{seq}.0.1.m.pw2")
            for c in ("conv1", "conv2", "conv3"):
                w.conv_bn(f"{sub}/merge/{c}", f"{seq}.1.{c}")
            w.conv_biased(f"{sub}/merge/se/fc1", f"{seq}.1.se.conv_reduce")
            w.conv_biased(f"{sub}/merge/se/fc2", f"{seq}.1.se.conv_expand")
            w.conv_bn(f"{sub}/post_dw", f"{seq}.2.0.m")
            w.conv_bn(f"{sub}/post_ffn/pw1", f"{seq}.2.1.m.pw1")
            w.conv_bn(f"{sub}/post_ffn/pw2", f"{seq}.2.1.m.pw2")
            off = 3
        for i in range(depth):
            fp, tp = f"stages_{s}_{i}", f"{seq}.{off + i}"
            for c in ("dw0", "dw1"):
                w.conv_bn(f"{fp}/{c}", f"{tp}.{c}.m")
            for c in ("ffn0", "ffn1"):
                w.conv_bn(f"{fp}/{c}/pw1", f"{tp}.{c}.m.pw1")
                w.conv_bn(f"{fp}/{c}/pw2", f"{tp}.{c}.m.pw2")
            a_f, a_t = f"{fp}/mixer/attn", f"{tp}.mixer.m.attn"
            heads = sum(k.startswith("qkv_") for k in w._get(w.params, a_f))
            for h in range(heads):
                w.conv_bn(f"{a_f}/qkv_{h}", f"{a_t}.qkvs.{h}")
                w.conv_bn(f"{a_f}/dw_{h}", f"{a_t}.dws.{h}")
            w.conv_bn(f"{a_f}/proj", f"{a_t}.proj.1")
            w.raw(f"{a_f}/attention_biases", f"{a_t}.attention_biases")
    if with_head:
        for head in ("head", "head_dist"):
            if head in w.params:
                w.bn(f"{head}/bn", f"{head}.bn")
                w.dense(f"{head}/linear", f"{head}.l")
    return w.state_dict()


def _swin_stem_and_head(w: _Writer, with_head: bool) -> None:
    w.conv_biased("patch_embed/proj", "patch_embed.proj")
    w.ln("patch_embed/norm", "patch_embed.norm")
    w.ln("norm", "norm")
    if with_head and "head" in w.params:
        w.dense("head", "head")


def _swin_blocks(params: Mapping) -> dict[int, int]:
    """{stage: number of blocks} from the `layers_{s}_block_{i}` keys."""
    count: dict[int, int] = {}
    for key in params:
        if "_block_" in key:
            s = int(key.split("_")[1])
            count[s] = count.get(s, 0) + 1
    return count


def _swin_downsample(w: _Writer, s: int) -> None:
    fp = f"layers_{s}_downsample"
    if fp in w.params:
        w.ln(f"{fp}/norm", f"layers.{s}.downsample.norm")
        w.dense(f"{fp}/reduction", f"layers.{s}.downsample.reduction")


def _swin_attn_mlp(w: _Writer, fp: str, tp: str) -> None:
    w.dense(f"{fp}/attn/qkv", f"{tp}.attn.qkv")
    w.dense(f"{fp}/attn/proj", f"{tp}.attn.proj")
    w.raw(f"{fp}/attn/relative_position_bias_table",
          f"{tp}.attn.relative_position_bias_table")
    w.dense(f"{fp}/mlp/fc1", f"{tp}.mlp.fc1")
    w.dense(f"{fp}/mlp/fc2", f"{tp}.mlp.fc2")


def swin_state_dict_from_jax(variables: Mapping, with_head: bool = True
                             ) -> dict[str, torch.Tensor]:
    """The JAX package's Swin / S3 variables -> the port's state_dict
    (released names). Inverse of `convert_swin`."""
    w = _Writer(variables)
    _swin_stem_and_head(w, with_head)
    for s, n in sorted(_swin_blocks(w.params).items()):
        for i in range(n):
            fp, tp = f"layers_{s}_block_{i}", f"layers.{s}.blocks.{i}"
            w.ln(f"{fp}/norm1", f"{tp}.norm1")
            w.ln(f"{fp}/norm2", f"{tp}.norm2")
            _swin_attn_mlp(w, fp, tp)
        _swin_downsample(w, s)
    return w.state_dict()


def mini_swin_state_dict_from_jax(variables: Mapping, with_head: bool = True
                                  ) -> dict[str, torch.Tensor]:
    """The JAX package's MiniSwin variables -> the port's state_dict
    (released Mini-Swin names: shared `attn`/`mlp` per physical block,
    per-repeat `norm1_list.{r}`, `norm2_list.{r}`, `proj_l.{r}`,
    `proj_w.{r}`, `local_norm_list.{r}`, `local_conv_list.{r}`). Inverse of
    `convert_mini_swin`."""
    w = _Writer(variables)
    _swin_stem_and_head(w, with_head)
    for s, n in sorted(_swin_blocks(w.params).items()):
        for i in range(n):
            fp, tp = f"layers_{s}_block_{i}", f"layers.{s}.blocks.{i}"
            _swin_attn_mlp(w, fp, tp)
            block = w._get(w.params, fp)
            for r in range(sum(k.startswith("norm1_list_") for k in block)):
                w.ln(f"{fp}/norm1_list_{r}", f"{tp}.norm1_list.{r}")
                w.ln(f"{fp}/norm2_list_{r}", f"{tp}.norm2_list.{r}")
                w.dense(f"{fp}/proj_l_{r}", f"{tp}.proj_l.{r}")
                w.dense(f"{fp}/proj_w_{r}", f"{tp}.proj_w.{r}")
                if f"local_norm_list_{r}" in block:
                    w.ln(f"{fp}/local_norm_list_{r}", f"{tp}.local_norm_list.{r}")
                    w.conv_biased(f"{fp}/local_conv_list_{r}", f"{tp}.local_conv_list.{r}")
        _swin_downsample(w, s)
    return w.state_dict()


def seeded_state_dict(model: torch.nn.Module, seed: int = 0
                      ) -> dict[str, torch.Tensor]:
    """Random but non-degenerate weights for `model`, drawn with numpy's
    default_rng(seed) over the sorted state_dict names (float32, on the CPU).

    Conv/Linear weights ~ N(0, 1/fan_in); biases ~ N(0, 0.02²); BN and LN
    scales (including MBConv.conv3's, which init at 0) ~ U(0.5, 1.5);
    running means ~ N(0, 0.1²), running variances ~ U(0.5, 1.5);
    attention_biases ~ N(0, 0.5²).

    A model whose residual stream has no normalisation (EfficientViT) names
    the scales of its residual branches' last BNs in `SEEDED_BRANCH_ENDS`
    (name suffixes) and a factor in `SEEDED_BRANCH_SCALE`; those scales are
    multiplied by it, so the stream does not grow geometrically with depth.
    Other models draw the same numbers as without the attributes."""
    rng = np.random.default_rng(seed)
    branch_scale = getattr(model, "SEEDED_BRANCH_SCALE", 1.0)
    branch_ends = getattr(model, "SEEDED_BRANCH_ENDS", ())
    out: dict[str, torch.Tensor] = {}
    for name, t in sorted(model.state_dict().items()):
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros_like(t, device="cpu")
            continue
        if name.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("running_mean"):
            a = rng.normal(0.0, 0.1, shape)
        elif name.endswith("attention_biases"):
            a = rng.normal(0.0, 0.5, shape)
        elif name.endswith("bias"):
            a = rng.normal(0.0, 0.02, shape)
        elif t.ndim == 1:
            a = rng.uniform(0.5, 1.5, shape)
            if name.endswith(branch_ends):
                a = a * branch_scale
        else:
            a = rng.normal(0.0, 1.0 / math.sqrt(math.prod(shape[1:])), shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out
