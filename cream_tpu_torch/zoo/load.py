"""Weights for the port: released .pth files, the JAX package's variables,
and seeded random weights.

The port's parameter names are the released microsoft/Cream TinyViT,
EfficientViT, Swin/S3, Mini-Swin, DeiT(+iRPE) and Mini-DeiT names and
open_clip's CLIP names, so a
released checkpoint loads with `model.load_state_dict` once `load_pth` (or,
for a model of its own geometry, `load_for_model`) has read it, and the JAX
package's `cream_tpu.zoo.import_torch.convert_tinyvit` /
`convert_efficientvit` / `convert_swin` / `convert_mini_swin` /
`convert_clip` / `convert_clip_classifier` / `convert_clip_rn` /
`convert_deit_rpe` / `convert_mini_deit` map a port state_dict to its
variables. `state_dict_from_jax`, `efficientvit_state_dict_from_jax`,
`swin_state_dict_from_jax`, `mini_swin_state_dict_from_jax`,
`deit_rpe_state_dict_from_jax`, `mini_deit_state_dict_from_jax`,
`clip_state_dict_from_jax`,
`clip_classifier_state_dict_from_jax` and `clip_resnet_state_dict_from_jax`
are their exact inverses; `retinanet_state_dict_from_jax` and
`mask_rcnn_state_dict_from_jax` carry the JAX detectors' variables to the
port's mmdet-named detectors; `bias_attention_state_dict_from_jax` carries a
JAX `BiasAttention`'s variables to the port's module.

CLIP checkpoints come in TinyCLIP's historical layouts too
(`normalize_clip_layout`), and a TinyCLIP checkpoint pruned by
auto-weight-inheritance builds its own ragged model (`load_pruned_clip`).
"""
from __future__ import annotations

import math
import re
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
    (the reference's `model/build.py:76-83` does the same). A file holding
    {"model": ...} or, as open_clip saves them, {"state_dict": ...} is
    unwrapped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
    return {k: v[:, :, None, None] if k.endswith(".c.weight") and v.ndim == 2 else v
            for k, v in ckpt.items() if not k.endswith(REBUILT_BUFFERS)}


def load_for_model(model: torch.nn.Module, ckpt) -> dict[str, torch.Tensor]:
    """The state_dict for `model` from `ckpt`, a released-layout .pth path
    (read by `load_pth`) or a state_dict. Where a position table's shape
    differs from the model's (`attention_biases`,
    `relative_position_bias_table`, `absolute_pos_embed`), it is
    bicubic-remapped (torch's A = -0.75) as the JAX loader's
    `load_model_variables(template=...)` and the reference's
    `load_pretrained` remap it (224 -> 384 -> 512 checkpoint inheritance);
    any other mismatch raises. A CLIP-family model (two-tower, classifier
    teacher, ModifiedResNet tower) takes TinyCLIP's historical layouts
    (`clip_state_dict_for`); a pruned TinyCLIP checkpoint needs the ragged
    model `load_pruned_clip` builds."""
    from cream_tpu_torch.zoo.interpolate import remap_resolution
    sd = dict(ckpt) if isinstance(ckpt, Mapping) else load_pth(ckpt)
    if _is_clip_family(model):
        sd = clip_state_dict_for(model, sd)
    template = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return {k: torch.as_tensor(v) for k, v in remap_resolution(sd, template).items()}


# ---- CLIP family ----

# scalars OpenAI's released CLIP files keep beside the weights
CLIP_META_KEYS = ("input_resolution", "context_length", "vocab_size")


def _is_clip_family(model: torch.nn.Module) -> bool:
    from cream_tpu_torch.models.clip import CLIP, CLIPClassifier
    from cream_tpu_torch.models.resnet import CLIPResNet, ModifiedResNet
    return isinstance(model, (CLIP, CLIPClassifier, CLIPResNet, ModifiedResNet))


def normalize_clip_layout(sd: Mapping) -> dict:
    """TinyCLIP's historical checkpoint layouts -> open_clip's names (the
    JAX package's rule; TinyCLIP model.py convert_to_new_checkpoint
    :1115-1160): strip DDP's `module.`, map `_image_encoder.module.*` to
    `visual.*` and `_text_encoder.module.*` to the top-level text names,
    the auto-weight-inheritance `*_encoder_without_ddp` prefixes to the
    same, and `_logit_scale.logit_scale` to `logit_scale`."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        k = k.replace("image_encoder_without_ddp", "_image_encoder") \
             .replace("text_encoder_without_ddp", "_text_encoder")
        if k == "_logit_scale.logit_scale":
            k = "logit_scale"
        if k.startswith("_image_encoder."):
            k = k.replace("_image_encoder.", "", 1)
            if k.startswith("module."):
                k = "visual." + k[len("module."):]
        elif k.startswith("_text_encoder."):
            k = k.replace("_text_encoder.", "", 1)
            if k.startswith("module."):
                k = k[len("module."):]
        out[k] = v
    return out


def clip_state_dict_for(model: torch.nn.Module, sd: Mapping) -> dict:
    """A CLIP-family state_dict in open_clip's names for `model`: the
    historical layouts normalized, OpenAI's scalar keys dropped, a 0-d
    `logit_scale`, and for a bare ModifiedResNet tower the `visual.*` part
    of a whole CLIP file. A checkpoint whose tower geometry differs from the
    model's (a pruned one) raises."""
    from cream_tpu_torch.models.clip import CLIP
    from cream_tpu_torch.models.resnet import ModifiedResNet
    sd = {k: v for k, v in normalize_clip_layout(sd).items() if k not in CLIP_META_KEYS}
    if isinstance(model, ModifiedResNet) and any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    if "logit_scale" in sd:
        sd["logit_scale"] = torch.as_tensor(sd["logit_scale"]).reshape(())
    if isinstance(model, CLIP):
        c = model.cfg
        want = clip_geometry(model.state_dict(), c.vision_layers, c.text_layers)
        got = clip_geometry(sd, c.vision_layers, c.text_layers)
        if got != want:
            raise ValueError(f"the checkpoint's CLIP geometry {got} is not the model's "
                             f"{want}: a pruned checkpoint builds its own ragged model "
                             f"(zoo.load.load_pruned_clip)")
    return sd


def clip_geometry(sd: Mapping, vision_layers: int, text_layers: int,
                  head_dim: int = 64) -> dict:
    """The ragged CLIP's keyword arguments read off the shapes of a
    state_dict's tensors or arrays, as the JAX package's
    `convert_clip_pruned` reads them: each block's heads off
    `in_proj_weight` (3 * heads * head_dim rows), its MLP width off
    `mlp.c_fc`, a missing branch as 0; the hidden widths off
    `visual.ln_pre` and `positional_embedding`; embed_dim off
    `visual.proj`. `vision_layers`/`text_layers` are the family's full
    depths, so a layer pruned away entirely keeps its slot."""
    shape = lambda k: tuple(np.shape(sd[k])) if k in sd else None

    def block(prefix: str) -> tuple[int, int]:
        qkv, fc = shape(f"{prefix}.attn.in_proj_weight"), shape(f"{prefix}.mlp.c_fc.weight")
        return (0 if qkv is None else qkv[0] // (3 * head_dim), 0 if fc is None else fc[0])

    v = [block(f"visual.transformer.resblocks.{i}") for i in range(vision_layers)]
    t = [block(f"transformer.resblocks.{i}") for i in range(text_layers)]
    return dict(vision_width=shape("visual.ln_pre.weight")[0],
                vision_heads=tuple(h for h, _ in v), vision_mlp_widths=tuple(m for _, m in v),
                text_width=shape("positional_embedding")[1],
                text_heads_per_layer=tuple(h for h, _ in t),
                text_mlp_widths=tuple(m for _, m in t),
                embed_dim=shape("visual.proj")[1])


def load_pruned_clip(name, ckpt, *, device, dtype: torch.dtype = torch.float32,
                     quick_gelu: bool = False, img_size: int | None = None):
    """A TinyCLIP checkpoint (a .pth path or a state_dict, any historical
    layout), pruned by auto-weight-inheritance or not -> (its CLIP model,
    state_dict). `name` picks the family's config (its full depths), or is
    a `CLIPConfig`; the kept heads, MLP widths and hidden widths come off
    the checkpoint's shapes, as the JAX package's `load_pruned_clip` /
    `convert_clip_pruned` read them, and the model is built ragged with
    them: no gates, no zero-padding back to the full model."""
    import dataclasses

    from cream_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
    cfg = CLIP_CONFIGS[name] if isinstance(name, str) else name
    sd = normalize_clip_layout(dict(ckpt) if isinstance(ckpt, Mapping) else load_pth(ckpt))
    g = clip_geometry(sd, cfg.vision_layers, cfg.text_layers)
    cfg = dataclasses.replace(cfg, embed_dim=g["embed_dim"], vision_width=g["vision_width"],
                              text_width=g["text_width"],
                              image_size=img_size or cfg.image_size)
    model = CLIP(cfg, quick_gelu, g["vision_heads"], g["vision_mlp_widths"],
                 g["text_heads_per_layer"], g["text_mlp_widths"], dtype=dtype,
                 device=device).eval()
    return model, load_for_model(model, sd)


def _clip_blocks(w: "_Writer", fp: str, tp: str) -> None:
    """A JAX CLIPTransformer's present blocks (`{fp}/resblocks_{i}`, each
    branch only where it has params) -> `{tp}.resblocks.{i}.*`."""
    for key, blk in w._get(w.params, fp).items():
        f, t = f"{fp}/{key}", f"{tp}.resblocks.{int(key.split('_')[1])}"
        if "attn" in blk:
            w.ln(f"{f}/ln_1", f"{t}.ln_1")
            qkv = blk["attn"]["in_proj"]
            w.sd[f"{t}.attn.in_proj_weight"] = _dense(qkv["kernel"])
            w.sd[f"{t}.attn.in_proj_bias"] = np.asarray(qkv["bias"])
            w.dense(f"{f}/attn/out_proj", f"{t}.attn.out_proj")
        if "c_fc" in blk:
            w.ln(f"{f}/ln_2", f"{t}.ln_2")
            w.dense(f"{f}/c_fc", f"{t}.mlp.c_fc")
            w.dense(f"{f}/c_proj", f"{t}.mlp.c_proj")


def _clip_vision(w: "_Writer", fp: str = "visual") -> None:
    w.sd["visual.conv1.weight"] = _conv(w._get(w.params, f"{fp}/conv1/kernel"))
    for name in ("class_embedding", "positional_embedding", "proj"):
        w.raw(f"{fp}/{name}", f"visual.{name}")
    w.ln(f"{fp}/ln_pre", "visual.ln_pre")
    w.ln(f"{fp}/ln_post", "visual.ln_post")
    _clip_blocks(w, f"{fp}/transformer", "visual.transformer")


def _clip_text(w: "_Writer", fp: str = "text") -> None:
    w.raw(f"{fp}/token_embedding/embedding", "token_embedding.weight")
    w.raw(f"{fp}/positional_embedding", "positional_embedding")
    w.ln(f"{fp}/ln_final", "ln_final")
    w.raw(f"{fp}/text_projection", "text_projection")
    _clip_blocks(w, f"{fp}/transformer", "transformer")
    w.raw("logit_scale", "logit_scale")


def clip_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's CLIP variables (full or ragged, e.g. `prune_clip`'s)
    -> the port's state_dict (open_clip names). Inverse of `convert_clip`
    / `convert_clip_pruned`."""
    w = _Writer(variables)
    _clip_vision(w)
    _clip_text(w)
    return w.state_dict()


def clip_classifier_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's CLIPClassifier variables -> the port's state_dict.
    Inverse of `convert_clip_classifier`."""
    w = _Writer(variables)
    _clip_vision(w)
    w.dense("head", "head")
    return w.state_dict()


def clip_resnet_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's CLIPResNet variables (or a bare ModifiedResNet
    tower's) -> the port's state_dict. Inverse of `convert_clip_rn` /
    `convert_clip_resnet_tower`."""
    w = _Writer(variables)
    two_tower = "visual" in w.params
    fp, tp = ("visual/", "visual.") if two_tower else ("", "")
    for i in (1, 2, 3):
        w.sd[f"{tp}conv{i}.weight"] = _conv(w._get(w.params, f"{fp}conv{i}/kernel"))
        w.bn(f"{fp}bn{i}", f"{tp}bn{i}")
    tower = w._get(w.params, fp.rstrip("/")) if two_tower else w.params
    for key in tower:
        if not key.startswith("layer"):
            continue
        li, bi = key[len("layer"):].split("_")
        f, t = f"{fp}{key}", f"{tp}layer{li}.{bi}"
        for c in (1, 2, 3):
            w.sd[f"{t}.conv{c}.weight"] = _conv(w._get(w.params, f"{f}/conv{c}/kernel"))
            w.bn(f"{f}/bn{c}", f"{t}.bn{c}")
        if "downsample_conv" in tower[key]:
            w.sd[f"{t}.downsample.0.weight"] = _conv(
                w._get(w.params, f"{f}/downsample_conv/kernel"))
            w.bn(f"{f}/downsample_bn", f"{t}.downsample.1")
    w.raw(f"{fp}attnpool/positional_embedding", f"{tp}attnpool.positional_embedding")
    for p in ("q_proj", "k_proj", "v_proj", "c_proj"):
        w.dense(f"{fp}attnpool/{p}", f"{tp}attnpool.{p}")
    if two_tower:
        _clip_text(w)
    return w.state_dict()


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
    `proj_w.{r}`, `local_norm_list.{r}`, `local_conv_list.{r}`; with
    `is_sep_layernorm` off one `norm1`/`norm2`, and without the head or FFN
    transforms none of theirs). Inverse of `convert_mini_swin`."""
    w = _Writer(variables)
    _swin_stem_and_head(w, with_head)
    for s, n in sorted(_swin_blocks(w.params).items()):
        for i in range(n):
            fp, tp = f"layers_{s}_block_{i}", f"layers.{s}.blocks.{i}"
            _swin_attn_mlp(w, fp, tp)
            block = w._get(w.params, fp)
            if "norm1" in block:
                w.ln(f"{fp}/norm1", f"{tp}.norm1")
                w.ln(f"{fp}/norm2", f"{tp}.norm2")
            per_repeat = [int(k.rsplit("_", 1)[1]) for k in block
                          if k.startswith(("norm1_list_", "proj_l_", "local_norm_list_"))]
            for r in range(max(per_repeat, default=-1) + 1):
                if f"norm1_list_{r}" in block:
                    w.ln(f"{fp}/norm1_list_{r}", f"{tp}.norm1_list.{r}")
                    w.ln(f"{fp}/norm2_list_{r}", f"{tp}.norm2_list.{r}")
                if f"proj_l_{r}" in block:
                    w.dense(f"{fp}/proj_l_{r}", f"{tp}.proj_l.{r}")
                    w.dense(f"{fp}/proj_w_{r}", f"{tp}.proj_w.{r}")
                if f"local_norm_list_{r}" in block:
                    w.ln(f"{fp}/local_norm_list_{r}", f"{tp}.local_norm_list.{r}")
                    w.conv_biased(f"{fp}/local_conv_list_{r}", f"{tp}.local_conv_list.{r}")
        _swin_downsample(w, s)
    return w.state_dict()


def _irpe_from_jax(w: _Writer, fp: str, tp: str) -> None:
    """An IRPE's tables, and a cross method's `rp_rows` / `rp_cols`."""
    for key in w._get(w.params, fp):
        if key in ("rp_rows", "rp_cols"):
            _irpe_from_jax(w, f"{fp}/{key}", f"{tp}.{key}")
        else:
            w.raw(f"{fp}/{key}", f"{tp}.{key}")


def _n_blocks(params: Mapping) -> int:
    return sum(k.startswith("blocks_") for k in params)


def deit_rpe_state_dict_from_jax(variables: Mapping, with_head: bool = True
                                 ) -> dict[str, torch.Tensor]:
    """The JAX package's RPEVisionTransformer variables -> the port's
    state_dict (the reference's DeiT(+iRPE) names: `blocks.{i}.attn.rpe_{q,k,v}.
    lookup_table_{weight,bias}`, `....rp_rows` / `rp_cols` for the cross
    method, `dist_token` and `head_dist` when distilled). Inverse of
    `convert_deit_rpe`."""
    w = _Writer(variables)
    for key in ("cls_token", "dist_token", "pos_embed"):
        if key in w.params:
            w.raw(key, key)
    w.conv_biased("patch_embed", "patch_embed.proj")
    for i in range(_n_blocks(w.params)):
        fp, tp = f"blocks_{i}", f"blocks.{i}"
        w.ln(f"{fp}/norm1", f"{tp}.norm1")
        w.ln(f"{fp}/norm2", f"{tp}.norm2")
        w.dense(f"{fp}/attn/qkv", f"{tp}.attn.qkv")
        w.dense(f"{fp}/attn/proj", f"{tp}.attn.proj")
        for r in ("rpe_q", "rpe_k", "rpe_v"):
            if r in w.params[fp]["attn"]:
                _irpe_from_jax(w, f"{fp}/attn/{r}", f"{tp}.attn.{r}")
        w.dense(f"{fp}/mlp_fc1", f"{tp}.mlp.fc1")
        w.dense(f"{fp}/mlp_fc2", f"{tp}.mlp.fc2")
    w.ln("norm", "norm")
    for head in ("head", "head_dist"):
        if with_head and head in w.params:
            w.dense(head, head)
    return w.state_dict()


def mini_deit_state_dict_from_jax(variables: Mapping, with_head: bool = True
                                  ) -> dict[str, torch.Tensor]:
    """The JAX package's MiniDeiT variables -> the port's state_dict (the
    reference's Mini-DeiT names: shared `blocks.{i}.block.{attn.qkv,
    attn.proj,mlp.fc1,mlp.fc2}`, per repeat `norm{1,2}.instances.{r}`,
    `attn.rpe_k.instances.{r}.lookup_table_weight` and
    `attn.conv_{l,w}.instances.{r}.weight` as (h, h, 1, 1) convs). Inverse
    of `convert_mini_deit`."""
    w = _Writer(variables)
    w.raw("pos_embed", "pos_embed")
    w.conv_biased("patch_embed", "patch_embed.proj")
    for i in range(_n_blocks(w.params)):
        fp, tp = f"blocks_{i}", f"blocks.{i}.block"
        for src, dst in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                         ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
            w.dense(f"{fp}/{src}", f"{tp}.{dst}")
        block = w.params[fp]
        for r in range(sum(k.startswith("norm1_") for k in block)):
            w.ln(f"{fp}/norm1_{r}", f"{tp}.norm1.instances.{r}")
            w.ln(f"{fp}/norm2_{r}", f"{tp}.norm2.instances.{r}")
            _irpe_from_jax(w, f"{fp}/rpe_k_{r}", f"{tp}.attn.rpe_k.instances.{r}")
            for conv in ("conv_l", "conv_w"):
                if f"{conv}_{r}" in block:      # Dense (h_in, h_out) -> (h_out, h_in, 1, 1)
                    kernel = np.asarray(block[f"{conv}_{r}"]["kernel"])
                    w.sd[f"{tp}.attn.{conv}.instances.{r}.weight"] = kernel.T[:, :, None, None]
    w.ln("norm", "norm")
    if with_head and "head" in w.params:
        w.dense("head", "head")
    return w.state_dict()


def autoformer_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's AutoFormerSuper variables (nested `blocks_{i}/attn/
    qkv`, the qkv columns interleaved) or AutoFormerSubnet variables (flat
    `blocks_{i}_attn_qkv`, [q; k; v]) -> the port's state_dict, the
    reference's names (`patch_embed_super.proj`, `blocks.{i}.attn.qkv`,
    `.attn.rel_pos_embed_{k,v}.embeddings_table_{v,h}`, ...). Inverse of
    `convert_autoformer_supernet` on a supernet."""
    w = _Writer(variables)
    for key in ("cls_token", "pos_embed"):
        if key in w.params:
            w.raw(key, key)
    w.conv_biased("patch_embed", "patch_embed_super.proj")
    nested = "blocks_0" in w.params
    n = sum(re.fullmatch(r"blocks_\d+" if nested else r"blocks_\d+_fc1", k) is not None
            for k in w.params)
    for i in range(n):
        for part, dst in (("attn_layer_norm", "attn_layer_norm"), ("attn/qkv", "attn.qkv"),
                          ("attn/proj", "attn.proj"), ("ffn_layer_norm", "ffn_layer_norm"),
                          ("fc1", "fc1"), ("fc2", "fc2"),
                          ("attn/rel_pos_embed_k", "attn.rel_pos_embed_k"),
                          ("attn/rel_pos_embed_v", "attn.rel_pos_embed_v")):
            fp = (f"blocks_{i}/{part}" if nested else
                  f"blocks_{i}_" + part.replace("attn/rel_", "rel_").replace("/", "_"))
            tp = f"blocks.{i}.{dst}"
            if part.endswith("layer_norm"):
                w.ln(fp, tp)
            elif "rel_pos" not in part:
                w.dense(fp, tp)
            else:
                try:
                    tables = w._get(w.params, fp)
                except KeyError:        # a model without relative positions
                    continue
                for tab, t in tables.items():
                    w.sd[f"{tp}.{tab}"] = np.asarray(t)
    w.ln("norm", "norm")
    w.dense("head", "head")
    return w.state_dict()


def cream_state_dict_from_jax(variables: Mapping, with_head: bool = True
                              ) -> dict[str, torch.Tensor]:
    """The JAX package's CreamSupernet (`stage_{s}_layer_{i}/choice_{c}`) or
    CreamChildNet (`stage_{s}_layer_{i}`) variables -> the port's
    state_dict (timm names; a supernet's choices as
    `blocks.{s+1}.{i}.{c}.…`). Inverse of `convert_cream_childnet` on a
    childnet."""
    w = _Writer(variables)

    def conv_bn(fp: str, conv: str, bn: str):
        w.sd[f"{conv}.weight"] = _conv(w._get(w.params, f"{fp}/conv/kernel"))
        w.bn(f"{fp}/bn", bn)

    def block(fp: str, tp: str, names):
        for part, bn in names:
            conv_bn(f"{fp}/{part}", f"{tp}.{part}", f"{tp}.{bn}")
        for se in ("conv_reduce", "conv_expand"):
            w.conv_biased(f"{fp}/se/{se}", f"{tp}.se.{se}")

    ir = (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))
    conv_bn("conv_stem", "conv_stem", "bn1")
    block("blocks_0", "blocks.0.0", (("conv_dw", "bn1"), ("conv_pw", "bn2")))
    layers = sorted((tuple(int(v) for v in k.split("_")[1::2]), k)
                    for k in w.params if k.startswith("stage_"))
    n_stages = 1 + max(s for (s, _), _ in layers)
    for (s, i), key in layers:
        node = w.params[key]
        if any(k.startswith("choice_") for k in node):
            for c in sorted(int(k.split("_")[1]) for k in node if k.startswith("choice_")):
                block(f"{key}/choice_{c}", f"blocks.{s + 1}.{i}.{c}", ir)
        else:
            block(key, f"blocks.{s + 1}.{i}", ir)
    conv_bn("blocks_tail", f"blocks.{n_stages + 1}.0.conv", f"blocks.{n_stages + 1}.0.bn1")
    w.conv_biased("conv_head", "conv_head")
    if with_head:
        w.dense("classifier", "classifier")
    return w.state_dict()


# ---- DARTS / CDARTS / NAS-Bench-201 ----

def _bn_stats(w: _Writer, fp: str, tp: str) -> None:
    """A BatchNorm without scale or bias: its running statistics."""
    st = w._get(w.stats, fp)
    w.sd[f"{tp}.running_mean"] = np.asarray(st["mean"])
    w.sd[f"{tp}.running_var"] = np.asarray(st["var"])
    w.sd[f"{tp}.num_batches_tracked"] = np.asarray(0, np.int64)


def _conv_bn_seq(w: _Writer, fp: str, tp: str, ci: int, bi: int) -> None:
    """A JAX ConvBN (`conv`, `bn`) -> a reference Sequential's conv `ci`
    and BN `bi`."""
    w.sd[f"{tp}.{ci}.weight"] = _conv(w._get(w.params, f"{fp}/conv/kernel"))
    w.bn(f"{fp}/bn", f"{tp}.{bi}")


def _darts_op(w: _Writer, fp: str, tp: str) -> None:
    """One DARTS op's params, its kind read off its JAX names: SepConv
    (`dw0`/`pw0`/`bn0`, `dw1`/…), DilConv (`dw`/`pw`/`bn`) or a
    FactorizedReduce (`conv1`/`conv2`/`bn`); the pools, the identity and
    'none' have none."""
    node = w._get(w.params, fp)
    if "conv1" in node:
        w.sd[f"{tp}.conv1.weight"] = _conv(node["conv1"]["kernel"])
        w.sd[f"{tp}.conv2.weight"] = _conv(node["conv2"]["kernel"])
        w.bn(f"{fp}/bn", f"{tp}.bn")
        return
    for j, sub in ((0, "0"), (1, "1")) if "dw0" in node else ((None, ""),):
        tq = tp if j is None else f"{tp}.net.{j}"
        w.sd[f"{tq}.net.1.weight"] = _conv(node[f"dw{sub}"]["kernel"])
        w.sd[f"{tq}.net.2.weight"] = _conv(node[f"pw{sub}"]["kernel"])
        w.bn(f"{fp}/bn{sub}", f"{tq}.net.3")


def _darts_cell(w: _Writer, fp: str, tp: str, search: bool) -> None:
    """A JAX SearchCell (`dag_{i}_{j}/op_{k}`) or AugmentCell (`dag_{i}_{e}`)
    -> the port's (`dag.{i}.{j}._ops.{k}`, `dag.{i}.{e}.0`), with its
    preprocessing (a StdConv `preproc*/conv_bn` or a FactorizedReduce)."""
    node = w._get(w.params, fp)
    for pre in ("preproc0", "preproc1"):
        if "conv_bn" in node[pre]:
            _conv_bn_seq(w, f"{fp}/{pre}/conv_bn", f"{tp}.{pre}.net", 1, 2)
        else:
            _darts_op(w, f"{fp}/{pre}", f"{tp}.{pre}")
    for key in node:
        if not key.startswith("dag_"):
            continue
        _, i, j = key.split("_")
        if search:
            for op in node[key]:
                _darts_op(w, f"{fp}/{key}/{op}", f"{tp}.dag.{i}.{j}._ops.{op.split('_')[1]}")
        else:
            _darts_op(w, f"{fp}/{key}", f"{tp}.dag.{i}.{j}.0")


def _numbered(params: Mapping, prefix: str) -> list[int]:
    return sorted(int(k[len(prefix):]) for k in params if k.startswith(prefix))


def darts_search_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's SearchCNN variables (`stem`, `cell_{i}`, `head`)
    -> the port's `models.darts.SearchCNN` state_dict."""
    w = _Writer(variables)
    _conv_bn_seq(w, "stem", "stem", 0, 1)
    for li in _numbered(w.params, "cell_"):
        _darts_cell(w, f"cell_{li}", f"cells.{li}", search=True)
    w.dense("head", "linear")
    return w.state_dict()


def darts_augment_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's AugmentCNN variables -> the port's
    `models.darts.AugmentCNN` state_dict."""
    w = _Writer(variables)
    _conv_bn_seq(w, "stem", "stem", 0, 1)
    for li in _numbered(w.params, "cell_"):
        _darts_cell(w, f"cell_{li}", f"cells.{li}", search=False)
    w.dense("head", "linear")
    return w.state_dict()


def cdarts_retrain_state_dict_from_jax(variables: Mapping, genotypes, model_type: str = "imagenet",
                                       res_stem: bool = False) -> dict[str, torch.Tensor]:
    """The JAX package's CDARTSRetrain variables -> the port's
    `models.darts.CDARTSRetrain` state_dict, in the released ModelTest
    names: the exact inverse of `convert_cdarts_retrain`."""
    from cream_tpu_torch.models.darts import as_genotypes, cdarts_retrain_plan
    w = _Writer(variables)
    if model_type == "cifar" or res_stem:
        _conv_bn_seq(w, "stem", "feature_extractor.0", 0, 1)
    else:
        _conv_bn_seq(w, "stem0_a", "feature_extractor.0", 0, 1)
        _conv_bn_seq(w, "stem0_b", "feature_extractor.0", 3, 4)
        _conv_bn_seq(w, "stem1", "feature_extractor.1", 1, 2)
    _, cell_nums, _ = cdarts_retrain_plan(model_type, res_stem)
    for li in range(len(as_genotypes(genotypes))):
        for i in range(cell_nums[li]):
            _darts_cell(w, f"cell_{li}_{i}", f"nas_layers.{li}.{i}", search=False)
    w.dense("fc", "fc")
    return w.state_dict()


def nasbench201_state_dict_from_jax(variables: Mapping, genotype=None, N: int | None = None
                                    ) -> dict[str, torch.Tensor]:
    """The JAX package's TinyNetwork201 (`genotype` None) or
    TinyNetwork201Infer (`genotype` its genotype or arch string) variables
    -> the port's `models.nasbench201` state_dict: `cell_{idx}` and
    `reduction_{s}` interleaved into `cells.{k}`, a search cell's
    `edge{i}_{j}_op{o}` as `edges.{i<-j}.{o}`, an infer cell's
    `edge{i}_{j}_{op}` as `layers.{k}` in the genotype's order. `N`, the
    cells a stage, is read off the cell names where None (an infer cell
    without a conv has no variables: give N for such a genotype)."""
    from cream_tpu_torch.models.nasbench201 import structure_fromstr
    w = _Writer(variables)
    w.sd["stem.0.weight"] = _conv(w.params["stem_conv"]["kernel"])
    w.bn("stem_bn", "stem.1")
    n = N or len(_numbered(w.params, "cell_")) // 3
    cells = range(3 * n)

    def relu_conv_bn(fp: str, tp: str) -> None:
        w.sd[f"{tp}.op.1.weight"] = _conv(w._get(w.params, f"{fp}/conv/kernel"))
        if "bn" in w._get(w.params, fp):
            w.bn(f"{fp}/bn", f"{tp}.op.2")
        else:
            _bn_stats(w, f"{fp}/bn", f"{tp}.op.2")

    if isinstance(genotype, str):
        genotype = structure_fromstr(genotype)
    for idx in cells:
        stage = idx // n
        k = idx + stage
        if stage and idx % n == 0:
            r, t = f"reduction_{stage}", f"cells.{k - 1}"
            relu_conv_bn(f"{r}/conv_a", f"{t}.conv_a")
            relu_conv_bn(f"{r}/conv_b", f"{t}.conv_b")
            w.sd[f"{t}.downsample.1.weight"] = _conv(w.params[r]["downsample"]["kernel"])
        node = w.params.get(f"cell_{idx}", {})
        if genotype is None:
            for key in node:
                i, j, o = key[len("edge"):].replace("_op", "_").split("_")
                relu_conv_bn(f"cell_{idx}/{key}", f"cells.{k}.edges.{i}<-{j}.{o}")
        else:
            layer = 0
            for ni, inputs in enumerate(genotype, start=1):
                for op, j in inputs:
                    if f"edge{ni}_{j}_{op}" in node:
                        relu_conv_bn(f"cell_{idx}/edge{ni}_{j}_{op}", f"cells.{k}.layers.{layer}")
                    layer += 1
    w.bn("lastact_bn", "lastact.0")
    w.dense("head", "classifier")
    return w.state_dict()


def cdarts_controller_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's CDARTSController variables -> the port's
    `nas.cdarts_stage.CDARTSController` state_dict: `stem`, `super_{l}_{c}`
    as `super_layers.{l}.{c}`, `nas_{l}_{c}` as `nas_layers.{l}.{c}`, the
    aux heads' `conv1`/`bn1`/`conv2`/`bn2`/`classifier` as
    `features.{2,3,5,6}`/`classifier`, `fc_super`, `fc_nas`,
    `ensemble_param`."""
    w = _Writer(variables)
    _conv_bn_seq(w, "stem", "stem", 0, 1)
    for key in w.params:
        if key.startswith(("super_", "nas_")):
            kind, li, ci = key.split("_")
            _darts_cell(w, key, f"{kind}_layers.{li}.{ci}", search=kind == "super")
        elif key.startswith("distill_aux_head"):
            w.sd[f"{key}.features.2.weight"] = _conv(w.params[key]["conv1"]["kernel"])
            _bn_stats(w, f"{key}/bn1", f"{key}.features.3")
            w.sd[f"{key}.features.5.weight"] = _conv(w.params[key]["conv2"]["kernel"])
            _bn_stats(w, f"{key}/bn2", f"{key}.features.6")
            w.dense(f"{key}/classifier", f"{key}.classifier")
    w.dense("fc_super", "fc_super")
    w.dense("fc_nas", "fc_nas")
    w.raw("ensemble_param", "ensemble_param")
    return w.state_dict()


def load_cdarts_retrain(ckpt, cells_json, *, device, dtype: torch.dtype = torch.float32,
                        model_type: str = "imagenet", res_stem: bool = False,
                        init_channels: int = 48, num_classes: int = 1000):
    """A released CDARTS retrain checkpoint and its cells/*.json genotype
    file -> the port's CDARTSRetrain with those weights, in eval mode (the
    CDARTS/CDARTS/test.py:72-86 path; the JAX package's
    `zoo.load.load_cdarts_retrain`). `ckpt` is a .pth path (read by
    `load_pth`) or a state_dict in the released ModelTest names, loaded
    without conversion; keys the model does not have are left out, as the
    JAX converter leaves them; a key the model has and the file lacks
    raises. `cells_json` is a path to the genotype JSON or its parsed
    dict."""
    import json

    from cream_tpu_torch.models import create_model
    cells = cells_json if isinstance(cells_json, dict) else json.loads(open(cells_json).read())
    name = "cdarts_retrain_imagenet" if model_type == "imagenet" else "cdarts_retrain_cifar"
    extra = {"res_stem": res_stem} if model_type == "imagenet" else {}
    model = create_model(name, genotypes=cells, num_classes=num_classes,
                         init_channels=init_channels, device=device, dtype=dtype, **extra)
    sd = dict(ckpt) if isinstance(ckpt, Mapping) else load_pth(ckpt)
    want = model.state_dict()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items() if k in want})
    return model.eval()


# ---- detectors: RetinaNet, Mask R-CNN ----

def _conv_transpose(k: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (transpose_kernel=False) HWIO -> torch
    ConvTranspose2d (in, out, kh, kw): the kernel flipped in both spatial
    axes."""
    return np.ascontiguousarray(np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1))


def _numbered_keys(node: Mapping, prefix: str) -> list[int]:
    return sorted(int(k[len(prefix):]) for k in node if re.fullmatch(rf"{prefix}\d+", k))


def _sub_variables(variables: Mapping, key: str) -> dict:
    return {"params": variables["params"][key],
            "batch_stats": variables.get("batch_stats", {}).get(key, {})}


def _detector_backbone(variables: Mapping) -> dict[str, torch.Tensor]:
    """The EfficientViT backbone's state_dict under `backbone.`."""
    sd = efficientvit_state_dict_from_jax(_sub_variables(variables, "backbone"), with_head=False)
    return {f"backbone.{k}": v for k, v in sd.items()}


def _fpn_from_jax(w: _Writer, fp: str, tp: str) -> None:
    node = w._get(w.params, fp)
    for prefix, dst in (("lateral_", "lateral_convs"), ("fpn_", "fpn_convs"),
                        ("extra_fpn_", "extra_fpn_convs")):
        for i in _numbered_keys(node, prefix):
            w.conv_biased(f"{fp}/{prefix}{i}", f"{tp}.{dst}.{i}.conv")
    for i in _numbered_keys(node, "extra_trans_"):
        t = node[f"extra_trans_{i}"]
        w.sd[f"{tp}.extra_trans_convs.{i}.weight"] = _conv_transpose(t["kernel"])
        w.sd[f"{tp}.extra_trans_convs.{i}.bias"] = np.asarray(t["bias"])


def retinanet_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's RetinaNet variables over EfficientViT (`backbone`,
    `neck`, `bbox_head`) -> the port's `models.retinanet.RetinaNet`
    state_dict, in mmdet's names: the backbone through
    `efficientvit_state_dict_from_jax` under `backbone.`, the transposed
    convs' kernels flipped."""
    w = _Writer(variables)
    _fpn_from_jax(w, "neck", "neck")
    head = w.params["bbox_head"]
    for kind in ("cls", "reg"):
        for i in _numbered_keys(head, f"{kind}_conv_"):
            w.conv_biased(f"bbox_head/{kind}_conv_{i}", f"bbox_head.{kind}_convs.{i}.conv")
    w.conv_biased("bbox_head/retina_cls", "bbox_head.retina_cls")
    w.conv_biased("bbox_head/retina_reg", "bbox_head.retina_reg")
    return {**_detector_backbone(variables), **w.state_dict()}


def mask_rcnn_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's MaskRCNN variables over EfficientViT (`backbone`,
    `neck`, `rpn_head`, `bbox_head`, `mask_head`) -> the port's
    `models.mask_rcnn.MaskRCNN` state_dict, in mmdet's names (`rpn_head.*`,
    `roi_head.bbox_head.*`, `roi_head.mask_head.*`). The first shared fc's
    rows go from JAX's NHWC flattening of the 7x7 RoI features to mmdet's
    NCHW one; the transposed convs' kernels are flipped."""
    w = _Writer(variables)
    _fpn_from_jax(w, "neck", "neck")
    for c in ("rpn_conv", "rpn_cls", "rpn_reg"):
        w.conv_biased(f"rpn_head/{c}", f"rpn_head.{c}")
    bb = "roi_head.bbox_head"
    fc0 = np.asarray(w.params["bbox_head"]["shared_fc0"]["kernel"])  # (7*7*C, out), rows (h, w, c)
    side = 7
    w.sd[f"{bb}.shared_fcs.0.weight"] = np.ascontiguousarray(
        fc0.reshape(side, side, -1, fc0.shape[1]).transpose(3, 2, 0, 1).reshape(fc0.shape[1], -1))
    w.sd[f"{bb}.shared_fcs.0.bias"] = np.asarray(w.params["bbox_head"]["shared_fc0"]["bias"])
    w.dense("bbox_head/shared_fc1", f"{bb}.shared_fcs.1")
    w.dense("bbox_head/fc_cls", f"{bb}.fc_cls")
    w.dense("bbox_head/fc_reg", f"{bb}.fc_reg")
    mh = "roi_head.mask_head"
    for i in _numbered_keys(w.params["mask_head"], "conv_"):
        w.conv_biased(f"mask_head/conv_{i}", f"{mh}.convs.{i}.conv")
    up = w.params["mask_head"]["upsample"]
    w.sd[f"{mh}.upsample.weight"] = _conv_transpose(up["kernel"])
    w.sd[f"{mh}.upsample.bias"] = np.asarray(up["bias"])
    w.conv_biased("mask_head/conv_logits", f"{mh}.conv_logits")
    return {**_detector_backbone(variables), **w.state_dict()}


# ---- DETR with iRPE / CyDAS segmentation ----

def _frozen_bn(w: _Writer, constants: Mapping, fp: str, tp: str) -> None:
    node = w._get(constants, fp)
    for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                     ("var", "running_var")):
        w.sd[f"{tp}.{dst}"] = np.asarray(node[src])


def _mha(w: _Writer, fp: str, tp: str) -> None:
    node = w._get(w.params, fp)
    w.sd[f"{tp}.in_proj_weight"] = _dense(node["in_proj_kernel"])
    w.sd[f"{tp}.in_proj_bias"] = np.asarray(node["in_proj_bias"])
    w.dense(f"{fp}/out_proj", f"{tp}.out_proj")
    for r in ("rpe_q", "rpe_k", "rpe_v"):
        if r in node:
            _irpe_from_jax(w, f"{fp}/{r}", f"{tp}.{r}")


def detr_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's DETR variables (`params` and the frozen BNs'
    `constants`) -> the port's `models.detr.DETR` state_dict, in the
    reference's names: the ResNet under `backbone.0.body.` (torchvision's
    `layer{l}.{b}.conv{i}` / `bn{i}` / `downsample.{0,1}`), the packed
    attention projections as torch's (3E, E) `in_proj_weight`,
    `transformer.{encoder,decoder}.layers.{i}`, `transformer.decoder.norm`.
    The JAX package has no DETR importer; this is its inverse layout."""
    w = _Writer(variables)
    consts = variables.get("constants", {})
    body, cbody = w.params["backbone"]["body"], consts["backbone"]["body"]
    tb = "backbone.0.body"
    w.sd[f"{tb}.conv1.weight"] = _conv(body["conv1"]["kernel"])
    _frozen_bn(w, cbody, "bn1", f"{tb}.bn1")
    for key in sorted(k for k in body if k.startswith("layer")):
        li, bi = key[len("layer"):].split("_")
        tp = f"{tb}.layer{li}.{bi}"
        for name, node in body[key].items():
            if name == "downsample_conv":
                w.sd[f"{tp}.downsample.0.weight"] = _conv(node["kernel"])
            else:
                w.sd[f"{tp}.{name}.weight"] = _conv(node["kernel"])
        for name in cbody[key]:
            _frozen_bn(w, cbody[key], name,
                       f"{tp}.downsample.1" if name == "downsample_bn" else f"{tp}.{name}")
    w.conv_biased("input_proj", "input_proj")
    w.raw("query_embed", "query_embed.weight")
    tr = w.params["transformer"]
    for kind in ("encoder", "decoder"):
        for i in _numbered_keys(tr, f"{kind}_layers_"):
            fp, tp = f"transformer/{kind}_layers_{i}", f"transformer.{kind}.layers.{i}"
            for name, node in tr[f"{kind}_layers_{i}"].items():
                if name.endswith("attn"):
                    _mha(w, f"{fp}/{name}", f"{tp}.{name}")
                elif name == "ffn":
                    w.dense(f"{fp}/ffn/linear1", f"{tp}.linear1")
                    w.dense(f"{fp}/ffn/linear2", f"{tp}.linear2")
                else:
                    w.ln(f"{fp}/{name}", f"{tp}.{name}")
        if f"{kind}_norm" in tr:
            w.ln(f"transformer/{kind}_norm", f"transformer.{kind}.norm")
    w.dense("class_embed", "class_embed")
    for i in _numbered_keys(w.params["bbox_embed"], "layers_"):
        w.dense(f"bbox_embed/layers_{i}", f"bbox_embed.layers.{i}")
    return w.state_dict()


def cydas_seg_state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's CyDASSeg variables -> the port's
    `models.cydas_seg.CyDASSeg` state_dict in the reference CyDASseg's
    names; the exact inverse of `cream_tpu.zoo.import_torch.
    convert_cydas_seg` (the trunk through `cream_state_dict_from_jax`'s
    blocks, a Self_Attn pipeline as `net.{0,1,3,5,7,8}`)."""
    w = _Writer(variables)

    def conv_bn(fp: str, conv: str, bn: str):
        w.sd[f"{conv}.weight"] = _conv(w._get(w.params, f"{fp}/conv/kernel"))
        w.bn(f"{fp}/bn", bn)

    def se(fp: str, tp: str):
        for c in ("conv_reduce", "conv_expand"):
            w.conv_biased(f"{fp}/se/{c}", f"{tp}.se.{c}")

    bb = w.params["backbone"]
    conv_bn("backbone/conv_stem", "backbone.conv_stem", "backbone.bn1")
    q = "backbone.blocks.0.0"
    conv_bn("backbone/blocks_0/conv_dw", f"{q}.conv_dw", f"{q}.bn1")
    se("backbone/blocks_0", q)
    conv_bn("backbone/blocks_0/conv_pw", f"{q}.conv_pw", f"{q}.bn2")
    layers = sorted(tuple(int(v) for v in k.split("_")[1::2]) for k in bb
                    if k.startswith("stage_"))
    for s, i in layers:
        fp, tp = f"backbone/stage_{s}_layer_{i}", f"backbone.blocks.{s + 1}.{i}"
        for part, bn in (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3")):
            conv_bn(f"{fp}/{part}", f"{tp}.{part}", f"{tp}.{bn}")
        se(fp, tp)
    tail = f"backbone.blocks.{1 + max(s for s, _ in layers) + 1}.0"
    conv_bn("backbone/blocks_tail", f"{tail}.conv", f"{tail}.bn1")

    def conv_norm(fp: str, tp: str):
        conv_bn(f"{fp}/conv", f"{tp}.conv.0", f"{tp}.conv.1")

    def self_attn(fp: str, tp: str):
        if "shortcut" in w._get(w.params, fp):
            conv_bn(f"{fp}/shortcut", f"{tp}.shortcut.0", f"{tp}.shortcut.1")
        conv_bn(f"{fp}/net_proj", f"{tp}.net.0", f"{tp}.net.1")
        for c in ("query_conv", "key_conv", "value_conv"):
            w.conv_biased(f"{fp}/att/{c}", f"{tp}.net.3.{c}")
        w.raw(f"{fp}/att/gamma", f"{tp}.net.3.gamma")
        w.bn(f"{fp}/net_bn", f"{tp}.net.5")
        conv_bn(f"{fp}/net_out", f"{tp}.net.7", f"{tp}.net.8")

    for name in ("arms32_0", "arms32_1", "refines32_0", "refines32_1"):
        conv_norm(name, name.replace("_", "."))
    conv_bn("ffm/conv", "ffm.conv_1x1.conv", "ffm.conv_1x1.bn")
    conv_norm("heads8/feature_projection", "heads8.feature_projection")
    self_attn("heads8/att_sa", "heads8.att_sa")
    conv_bn("heads8/conv_3x3", "heads8.conv_3x3.conv", "heads8.conv_3x3.bn")
    w.conv_biased("heads8/conv_1x1", "heads8.conv_1x1")
    for h in ("heads16", "heads32"):
        if h in w.params:
            self_attn(f"{h}/att_sa", f"{h}.att_sa")
            w.conv_biased(f"{h}/conv_1x1", f"{h}.conv_1x1")
    return w.state_dict()


def seeded_state_dict(model: torch.nn.Module, seed: int = 0
                      ) -> dict[str, torch.Tensor]:
    """Random but non-degenerate weights for `model`, drawn with numpy's
    default_rng(seed) over the sorted state_dict names (float32, on the CPU).

    Conv/Linear weights ~ N(0, 1/fan_in); biases ~ N(0, 0.02²); BN and LN
    scales (including MBConv.conv3's, which init at 0) ~ U(0.5, 1.5);
    running means ~ N(0, 0.1²), running variances ~ U(0.5, 1.5);
    attention_biases ~ N(0, 0.5²); iRPE's `lookup_table_weight` /
    `lookup_table_bias` (zero at init, which would hide a dropped or
    misindexed term) ~ N(0, 0.05²); CLIP's `logit_scale` is its initial
    log(1/0.07), drawing nothing.

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
        if name == "logit_scale":                      # CLIP's initial temperature
            out[name] = torch.tensor(float(np.log(1 / 0.07)))
            continue
        if name.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("running_mean"):
            a = rng.normal(0.0, 0.1, shape)
        elif name.endswith("attention_biases"):
            a = rng.normal(0.0, 0.5, shape)
        elif name.endswith(("lookup_table_weight", "lookup_table_bias")):
            a = rng.normal(0.0, 0.05, shape)
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
