"""TinyViT weights for the port: released .pth files, the JAX package's
variables, and seeded random weights.

The port's parameter names are the released microsoft/Cream TinyViT names, so
a released checkpoint loads with `model.load_state_dict` as it is, and
`cream_tpu.zoo.import_torch.convert_tinyvit` maps a port state_dict to the
JAX package's variables. `state_dict_from_jax` is its exact inverse.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch


def load_pth(path: str) -> dict[str, torch.Tensor]:
    """A released TinyViT .pth -> state_dict for the port's model. The
    attention index buffers are dropped: the model rebuilds them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: v for k, v in ckpt.items()
            if not k.endswith("attention_bias_idxs")}


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
        bn = self._get(self.params, f"{fp}/bn")
        st = self._get(self.stats, f"{fp}/bn")
        self.sd[f"{tp}.bn.weight"] = np.asarray(bn["scale"])
        self.sd[f"{tp}.bn.bias"] = np.asarray(bn["bias"])
        self.sd[f"{tp}.bn.running_mean"] = np.asarray(st["mean"])
        self.sd[f"{tp}.bn.running_var"] = np.asarray(st["var"])
        self.sd[f"{tp}.bn.num_batches_tracked"] = np.asarray(0, np.int64)

    def ln(self, fp: str, tp: str):
        node = self._get(self.params, fp)
        self.sd[f"{tp}.weight"] = np.asarray(node["scale"])
        self.sd[f"{tp}.bias"] = np.asarray(node["bias"])

    def dense(self, fp: str, tp: str):
        node = self._get(self.params, fp)
        self.sd[f"{tp}.weight"] = _dense(node["kernel"])
        if "bias" in node:
            self.sd[f"{tp}.bias"] = np.asarray(node["bias"])


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
    return {k: torch.from_numpy(np.array(v)) for k, v in w.sd.items()}


def seeded_state_dict(model: torch.nn.Module, seed: int = 0
                      ) -> dict[str, torch.Tensor]:
    """Random but non-degenerate weights for `model`, drawn with numpy's
    default_rng(seed) over the sorted state_dict names (float32, on the CPU).

    Conv/Linear weights ~ N(0, 1/fan_in); biases ~ N(0, 0.02²); BN and LN
    scales (including MBConv.conv3's, which init at 0) ~ U(0.5, 1.5);
    running means ~ N(0, 0.1²), running variances ~ U(0.5, 1.5);
    attention_biases ~ N(0, 0.5²)."""
    rng = np.random.default_rng(seed)
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
        else:
            a = rng.normal(0.0, 1.0 / math.sqrt(math.prod(shape[1:])), shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out
