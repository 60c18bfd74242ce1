"""cream_tpu_torch's DETR with iRPE (`models/detr.py`, the frozen-BN ResNet
of `models/resnet.py`, `nn/rpe.py`'s per-grid tables, the DETR CLI's step)
and its weight bridge, against the JAX package's on shared seeded weights
and numpy-seeded inputs (fp32, on the CPU).

Weights: `seeded_state_dict` on the port's model (iRPE tables N(0, 0.05²),
frozen-BN buffers drawn like BN's), carried to JAX through
`zoo.load.detr_state_dict_from_jax` inverted (`jax_variables`: the bridge
run on index-filled leaves, then each tensor put back with the inverse
layout change). The live comparisons run narrow models (a 1-1-1-1 ResNet,
hidden 32, 2 + 2 layers). The full widths (`detr_resnet50` with the paper's
iRPE-K encoder, `detr_resnet18` plain, 91 classes, 100 queries, aux loss)
are held to the record JAX wrote (`__main__`),
tests/data/torch_port/detr_resnet50_irpe_k_seed0.npz: both models' outputs
on a 2 x 160 x 224 batch whose pixel masks pad regions that do not end on
a multiple of 32, and one train step of DETR-R50 iRPE-K in float64 (JAX's
fp32 CPU grads sit 1.5-2% off it at some ops): its losses, its Hungarian
assignments and per-tensor grad norms. Regenerate it with
    PYTHONPATH=.:tests python tests/test_torch_detr.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.models import detr as JD
from cream_tpu.models import resnet as JRN
from cream_tpu.train import detection as JDET
from cream_tpu_torch.cli import train_detr
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models import detr as D
from cream_tpu_torch.models import resnet as RN
from cream_tpu_torch.nn.rpe import IRPE
from cream_tpu_torch.ops.rpe import get_rpe_config
from cream_tpu_torch.train.detection import criterion, hungarian_assign, matching_cost
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import make_loss_step
from cream_tpu_torch.zoo.load import detr_state_dict_from_jax, seeded_state_dict
from torch_port_bridges import assert_bridge_inverts
from torch_threads import one_torch_thread_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "detr_resnet50_irpe_k_seed0.npz"
WEIGHT_SEED, INPUT_SEED, TARGET_SEED, ROWS_SEED = 0, 1, 2, 3
PAPER_RPE = "rpe-2.0-product-ctx-1-k"
GOLDEN_HW, GOLDEN_MAX_BOXES = (160, 224), 8
NARROW = dict(num_classes=5, num_queries=6, hidden_dim=32, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=64, aux_loss=True)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def jax_variables(sd: dict, template) -> dict:
    """The port's DETR state_dict (or grads keyed by param name over it) in
    the JAX model's variable layout: `detr_state_dict_from_jax` run on the
    template's leaves filled with their own index tells each tensor's JAX
    leaf; conv OIHW -> HWIO, Dense and in_proj (out, in) -> (in, out), the
    query embedding and iRPE tables as they are. Every leaf is reached."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i + 1, np.float32) for i, leaf in enumerate(leaves)])
    out = [None] * len(leaves)
    for name, t in detr_state_dict_from_jax(marked).items():
        i = int(t.numpy().flat[0]) - 1
        v = _np(sd[name])
        if v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        elif v.ndim == 2 and name != "query_embed.weight":
            v = v.T
        assert out[i] is None and v.shape == tuple(leaves[i].shape), name
        out[i] = np.ascontiguousarray(v)
    missing = [i for i, v in enumerate(out) if v is None]
    assert not missing, f"{len(missing)} JAX leaves no port tensor reaches"
    return jax.tree_util.tree_unflatten(treedef, out)


def padded_batch(seed: int, batch: int, hw: tuple[int, int]):
    """N(0, 1) images and pixel masks: image 0 padded below row 0.8 H,
    image 1 right of column 0.75 W (neither a multiple of 32), others
    unpadded; padded pixels zero."""
    x = np.random.default_rng(seed).standard_normal((batch, *hw, 3)).astype(np.float32)
    mask = np.zeros((batch, *hw), bool)
    mask[0, int(0.8 * hw[0]) + 1:] = True
    if batch > 1:
        mask[1, :, int(0.75 * hw[1]) + 3:] = True
    x[mask] = 0.0
    return x, mask


def narrow_pair(spec: str = PAPER_RPE, block: str = "basic"):
    """(port narrow DETR with seeded weights, its state_dict, JAX DETR)."""
    cfg = D.parse_enc_rpe2d(spec)
    m = D.DETR(RN.ResNetBackbone((1, 1, 1, 1), block), rpe_config=cfg, **NARROW).eval()
    sd = seeded_state_dict(m, WEIGHT_SEED)
    m.load_state_dict(sd)
    jm = JD.DETR(backbone=JRN.ResNetBackbone((1, 1, 1, 1), block), rpe_config=cfg, **NARROW)
    return m, sd, jm


# ------------------------------------------------------------- backbone

@pytest.mark.parametrize("hw,out", [((100, 130), (4, 5)), ((160, 224), (5, 7)),
                                    ((97, 33), (4, 2)), ((64, 64), (2, 2))])
def test_mask_downsample_is_jax_nearest(hw, out):
    """The pixel mask shrinks with jax.image.resize's nearest (half-pixel
    centres, float32 offsets), a padded edge off any multiple of 32."""
    rng = np.random.default_rng(sum(hw))
    mask = rng.random((2, *hw)) < 0.5
    mask[0, hw[0] // 2 + 5:] = True
    want = np.asarray(jax.image.resize(jnp.asarray(mask, jnp.float32), (2, *out),
                                       "nearest") > 0.5)
    rows, cols = RN.nearest_indices(hw[0], out[0]), RN.nearest_indices(hw[1], out[1])
    np.testing.assert_array_equal(mask[:, rows][:, :, cols], want)
    got = torch.from_numpy(mask)[:, torch.from_numpy(rows)][:, :, torch.from_numpy(cols)]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layers,block", [((1, 1, 1, 1), "basic"), ((1, 2, 1, 1), "bottleneck")])
def test_frozen_bn_resnet_matches_jax(layers, block):
    """The backbone's stride-32 features and mask on a padded batch (fp32,
    1e-5 of the largest); the frozen BN's four buffers are buffers."""
    m = RN.ResNetBackbone(layers, block)
    sd = seeded_state_dict(m, 4)
    m.load_state_dict(sd)
    assert not any("bn" in n for n, _ in m.named_parameters())
    assert {"body.bn1.weight", "body.bn1.running_var", "body.layer2.0.downsample.1.bias",
            "body.layer1.0.conv1.weight"} <= set(sd)
    jm = JRN.ResNetBackbone(layers, block)
    x, mask = padded_batch(5, 2, (100, 130))
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x),
                                              jnp.asarray(mask)))
    v = backbone_variables(sd, template)
    feat, jmask = jm.apply(v, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got, gmask = m(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(jmask))
    want = np.asarray(feat)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


def backbone_variables(sd: dict, template) -> dict:
    """A JAX ResNetBackbone's variables (`params` and `constants` under
    `body`) from the port backbone's state_dict."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, leaf in flat:
        keys = [k.key for k in path]
        assert keys[1] == "body", keys
        out.append(_backbone_leaf(sd, keys[0], keys[2:]))
        assert out[-1].shape == tuple(leaf.shape), keys
    return jax.tree_util.tree_unflatten(treedef, out)


def _backbone_leaf(sd: dict, coll: str, parts: list[str]) -> np.ndarray:
    """One JAX backbone leaf (body/[layer{l}_{b}/]name/leaf) from the port's
    names."""
    tp = "body"
    if parts[0].startswith("layer"):
        li, bi = parts[0][len("layer"):].split("_")
        tp += f".layer{li}.{bi}"
        parts = parts[1:]
    name = parts[0]
    if coll == "params":
        name = "downsample.0" if name == "downsample_conv" else name
        return _np(sd[f"{tp}.{name}.weight"]).transpose(2, 3, 1, 0)
    name = "downsample.1" if name == "downsample_bn" else name
    buf = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    return _np(sd[f"{tp}.{name}.{buf[parts[1]]}"])


def test_clip_avg_pool_forward_unchanged():
    """The CLIP RN tower's pool now runs on a contiguous NCHW copy (torch's
    CUDA avg_pool2d backward is wrong on a channels_last input): on the CPU
    its output is bit for bit the channels_last pool's, and its input grad
    is the float64 pool's."""
    x = torch.randn(2, 14, 10, 24, generator=torch.Generator().manual_seed(0))
    old = torch.nn.functional.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    assert torch.equal(RN._avg_pool(x, 2), old)
    xi = x.double().requires_grad_()
    y = RN._avg_pool(xi, 2)
    gy = torch.linspace(-1, 1, y.numel(), dtype=y.dtype).reshape(y.shape)
    g, = torch.autograd.grad((y * gy).sum(), [xi])
    want = gy.repeat_interleave(2, 1).repeat_interleave(2, 2) / 4
    assert torch.allclose(g, want, rtol=0, atol=1e-15)


# ----------------------------------------------------------- transformer

def test_sine_position_embedding_matches_jax():
    """fp32 cumsums with eps 1e-6, temperature ** (2 (i // 2) / F), sin and
    cos interleaved, [pos_y, pos_x]; padded rows and columns too."""
    _, mask = padded_batch(0, 2, (9, 13))
    mask[0, :, 10:] = True
    want = np.asarray(JD.sine_position_embedding(jnp.asarray(mask), 16))
    got = D.sine_position_embedding(torch.from_numpy(mask), 16)
    assert got.dtype == torch.float32 and got.shape == (2, 9, 13, 32)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("rpe_on", ["k", "qk", "qkv", None])
def test_rpe_attention_matches_jax(rpe_on):
    """RPEMultiheadAttention with a key padding mask (a fully padded key row
    too) and iRPE on k, q and k, or q, k and v, on a 5 x 7 grid: outputs and
    input grads within 1e-5 of the largest."""
    E, H, grid = 32, 4, (5, 7)
    cfg = None if rpe_on is None else get_rpe_config(1.9, "product", "ctx", True, 0, rpe_on)
    m = D.RPEMultiheadAttention(E, H, cfg, dtype=torch.float32)
    sd = seeded_state_dict(m, 1)
    m.load_state_dict(sd)
    jm = JD.RPEMultiheadAttention(E, H, cfg)
    rng = np.random.default_rng(2)
    L = grid[0] * grid[1]
    q, k, v = (rng.standard_normal((2, L, E)).astype(np.float32) for _ in range(3))
    kpm = np.zeros((2, L), bool)
    kpm[0, 20:] = True
    kpm[1] = True                                   # every key padded: finite, uniform
    v_j = {"params": {"in_proj_kernel": _np(sd["in_proj_weight"]).T,
                      "in_proj_bias": _np(sd["in_proj_bias"]),
                      "out_proj": {"kernel": _np(sd["out_proj.weight"]).T,
                                   "bias": _np(sd["out_proj.bias"])}}}
    for r in ("rpe_q", "rpe_k", "rpe_v"):
        if f"{r}.lookup_table_weight" in sd:
            v_j["params"][r] = {"lookup_table_weight": _np(sd[f"{r}.lookup_table_weight"])}
    w = rng.standard_normal((2, L, E)).astype(np.float32)

    def f(q, k, v):
        out = jm.apply(v_j, q, k, v, key_padding_mask=jnp.asarray(kpm), hw=grid)
        return (out * w).sum(), out
    (_, want), gq = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = m(tq, tk, tv, torch.from_numpy(kpm), grid)
    (got * torch.from_numpy(w)).sum().backward()
    assert bool(torch.isfinite(got).all())
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())
    for t, g in zip((tq, tk, tv), gq):
        g = np.asarray(g)
        np.testing.assert_allclose(_np(t.grad), g, rtol=0, atol=1e-5 * np.abs(g).max())


def test_irpe_on_a_grid_per_call():
    """An IRPE without a grid makes each call's tables (cached per grid and
    device) and gives what an IRPE built for that grid gives, on the same
    table; DeiT's built grid is unchanged."""
    cfg = get_rpe_config(1.9, "product", "ctx", True, 0, "k").rpe_k
    free = IRPE(8, 2, cfg)
    with torch.no_grad():
        free.lookup_table_weight.normal_(0, 0.05, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 2, 35, 8, generator=torch.Generator().manual_seed(1))
    for hw in ((5, 7), (7, 5)):
        built = IRPE(8, 2, cfg, *hw)
        built.load_state_dict(free.state_dict())
        assert torch.equal(free(x, hw), built(x))
    assert len(free._grids) == 2
    free(x, (5, 7))
    assert len(free._grids) == 2
    with pytest.raises(ValueError):
        free(x, (6, 6))


def test_encoder_and_decoder_layers_match_jax():
    """One encoder layer (iRPE-K, padding) and one decoder layer (query
    pos, memory padding) at hidden 32: 1e-5 of the largest; LN eps 1e-6."""
    E, grid = 32, (4, 6)
    L = grid[0] * grid[1]
    cfg = D.parse_enc_rpe2d("rpe-1.9-product-ctx-1-k")
    rng = np.random.default_rng(3)
    src, pos = (rng.standard_normal((2, L, E)).astype(np.float32) for _ in range(2))
    tgt, qpos = (rng.standard_normal((2, 5, E)).astype(np.float32) for _ in range(2))
    kpm = np.zeros((2, L), bool)
    kpm[1, 15:] = True
    enc = D.TransformerEncoderLayer(E, 4, 64, rpe_config=cfg)
    dec = D.TransformerDecoderLayer(E, 4, 64)
    assert enc.norm1.eps == dec.norm3.eps == 1e-6
    for i, (port, jmod, args, targs) in enumerate((
            (enc, JD.TransformerEncoderLayer(E, 4, 64, rpe_config=cfg),
             (src, kpm, pos), dict(hw=grid)),
            (dec, JD.TransformerDecoderLayer(E, 4, 64),
             (tgt, src, kpm, pos, qpos), {}))):
        sd = seeded_state_dict(port, 10 + i)
        port.load_state_dict(sd)
        template = jax.eval_shape(lambda: jmod.init(jax.random.key(0),
                                                    *map(jnp.asarray, args), **targs))
        v = layer_variables(sd, template["params"])
        want = np.asarray(jmod.apply({"params": v}, *map(jnp.asarray, args), **targs))
        with torch.no_grad():
            got = port(*map(torch.from_numpy, args), **targs)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


def layer_variables(sd: dict, template: dict) -> dict:
    """A JAX layer's params from a port layer's state_dict."""
    out = {}
    for key, node in template.items():
        if key == "ffn":
            out[key] = {n: {"kernel": _np(sd[f"{n}.weight"]).T, "bias": _np(sd[f"{n}.bias"])}
                        for n in node}
        elif key.startswith("norm"):
            out[key] = {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}
        else:
            att = {"in_proj_kernel": _np(sd[f"{key}.in_proj_weight"]).T,
                   "in_proj_bias": _np(sd[f"{key}.in_proj_bias"]),
                   "out_proj": {"kernel": _np(sd[f"{key}.out_proj.weight"]).T,
                                "bias": _np(sd[f"{key}.out_proj.bias"])}}
            for r in ("rpe_q", "rpe_k", "rpe_v"):
                if r in node:
                    att[r] = {"lookup_table_weight": _np(sd[f"{key}.{r}.lookup_table_weight"])}
            out[key] = att
    return out


# ----------------------------------------------------------------- model

@pytest.fixture(scope="module")
def narrow():
    torch.set_num_threads(1)
    m, sd, jm = narrow_pair()
    x, mask = padded_batch(INPUT_SEED, 2, (100, 130))
    template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x),
                                              jnp.asarray(mask)))
    v = jax_variables(sd, template)
    return dict(m=m, sd=sd, jm=jm, x=x, mask=mask, template=template, v=v)


def test_narrow_detr_matches_jax(narrow):
    """The narrow DETR (iRPE-K, a padded batch): final and auxiliary logits
    and boxes within 1e-5 of the largest."""
    want = jax.jit(narrow["jm"].apply)(narrow["v"], jnp.asarray(narrow["x"]),
                                       jnp.asarray(narrow["mask"]))
    with torch.no_grad():
        got = narrow["m"](torch.from_numpy(narrow["x"]), torch.from_numpy(narrow["mask"]))
    pairs = [(got, want)] + list(zip(got["aux_outputs"], want["aux_outputs"]))
    assert len(pairs) == NARROW["num_decoder_layers"]
    for g, w in pairs:
        for k in ("pred_logits", "pred_boxes"):
            w_ = np.asarray(w[k])
            np.testing.assert_allclose(_np(g[k]), w_, rtol=0, atol=1e-5 * np.abs(w_).max())


def test_bridge_reaches_every_leaf_and_inverts(narrow):
    assert_bridge_inverts(narrow["sd"], narrow["v"], detr_state_dict_from_jax)
    assert {"backbone.0.body.layer2.0.downsample.1.running_mean", "query_embed.weight",
            "transformer.encoder.layers.0.self_attn.in_proj_weight",
            "transformer.encoder.layers.1.self_attn.rpe_k.lookup_table_weight",
            "transformer.decoder.layers.1.multihead_attn.out_proj.bias",
            "transformer.decoder.norm.weight", "bbox_embed.layers.2.weight",
            "input_proj.weight", "class_embed.bias"} <= set(narrow["sd"])


def narrow_targets(seed: int, batch: int, num_classes: int, max_boxes: int):
    boxes, labels, valid = train_detr.synthetic_targets(np.random.default_rng(seed), batch,
                                                        max_boxes, num_classes)
    return boxes, labels.astype(np.int32), valid


def test_narrow_step_matches_jax(narrow):
    """The CLI's step on the narrow model: one forward, the final and
    auxiliary outputs matched on the host, CE 1 / L1 5 / GIoU 2; the
    assignments equal JAX's, the loss within 1e-4 and the per-tensor grad
    norms within 1e-3 of JAX's (JAX's two forwards: costs, then the loss
    under grad)."""
    jm, v = narrow["jm"], narrow["v"]
    x, mask = jnp.asarray(narrow["x"]), jnp.asarray(narrow["mask"])
    boxes, labels, valid = narrow_targets(TARGET_SEED, 2, NARROW["num_classes"], 4)
    out = jax.jit(jm.apply)(v, x, mask)
    assigns = [JDET.hungarian_assign(np.asarray(JDET.matching_cost(
        o["pred_logits"], o["pred_boxes"], boxes, labels, valid)), valid)
        for o in [out] + out["aux_outputs"]]

    def loss_fn(p):
        o = jm.apply({"params": p, "constants": v["constants"]}, x, mask)
        total = 0.0
        for oo, a in zip([o] + o["aux_outputs"], assigns):
            l = JDET.detection_loss(oo, boxes, labels, valid, jnp.asarray(a), 5, 0.1,
                                    jnp.maximum(valid.sum(), 1.0))
            total = total + l["loss_ce"] + 5.0 * l["loss_bbox"] + 2.0 * l["loss_giou"]
        return total
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    m = narrow["m"]
    m.load_state_dict(narrow["sd"])
    m.train()
    got = m(torch.from_numpy(narrow["x"]), torch.from_numpy(narrow["mask"]))
    t = {"boxes": torch.from_numpy(boxes), "labels": torch.from_numpy(labels),
         "valid": torch.from_numpy(valid)}
    for o, a in zip([got] + got["aux_outputs"], assigns):
        with torch.no_grad():
            c = matching_cost(o["pred_logits"], o["pred_boxes"], t["boxes"], t["labels"],
                              t["valid"])
        np.testing.assert_array_equal(hungarian_assign(c.numpy(), valid), a)
    losses = criterion(got, t["boxes"], t["labels"], t["valid"], 5)
    total = losses["total"]
    params = dict(m.named_parameters())
    pg = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    total = total.detach()
    m.eval()
    assert abs(float(total) - float(loss)) <= 1e-4 * float(loss)
    assert_grad_norms(grads, pg, narrow)


def assert_grad_norms(jax_grads, port_grads: dict, ctx: dict, rel: float = 1e-3):
    """Per-tensor grad norms within `rel`, plus 1e-6 of the largest."""
    state = {k: t.detach() for k, t in ctx["m"].state_dict().items()}
    ported = jax_variables({**state, **port_grads}, ctx["template"])["params"]
    a = np.asarray([np.linalg.norm(np.asarray(g)) for g in jax.tree_util.tree_leaves(jax_grads)])
    b = np.asarray([np.linalg.norm(g) for g in jax.tree_util.tree_leaves(ported)])
    diff = np.abs(a - b)
    assert np.all(diff <= rel * a + 1e-6 * a.max()), (diff / np.maximum(a, 1e-30)).max()


def test_one_forward_step_equals_two(narrow):
    """The port's step runs the forward once (the matching under no_grad on
    its outputs); JAX's runs it for the costs and again under grad. With no
    dropout the two give the same loss and grads, bit for bit."""
    m, sd = narrow["m"], narrow["sd"]
    boxes, labels, valid = (torch.from_numpy(a) for a in narrow_targets(
        TARGET_SEED + 1, 2, NARROW["num_classes"], 4))
    batch = {"image": torch.from_numpy(narrow["x"]), "pad_mask": torch.from_numpy(narrow["mask"]),
             "boxes": boxes, "labels": labels, "valid": valid}
    m.load_state_dict(sd)
    m.train()
    with torch.no_grad():
        first = m(batch["image"], batch["pad_mask"])
    outs = [first] + first["aux_outputs"]
    assigns = [torch.from_numpy(hungarian_assign(matching_cost(
        o["pred_logits"], o["pred_boxes"], boxes, labels, valid).numpy(), valid.numpy()))
        for o in outs]
    second = m(batch["image"], batch["pad_mask"])
    from cream_tpu_torch.train.detection import detection_loss
    nb = valid.sum().float().clamp_min(1.0)
    two = sum(l["loss_ce"] + 5.0 * l["loss_bbox"] + 2.0 * l["loss_giou"] for l in (
        detection_loss(o, boxes, labels, valid, a, 5, 0.1, nb)
        for o, a in zip([second] + second["aux_outputs"], assigns)))
    params = dict(m.named_parameters())
    g_two = torch.autograd.grad(two, list(params.values()))
    state = TrainState(m, train_detr.detr_adamw())
    before = {k: t.clone() for k, t in params.items()}
    _, one, _ = make_loss_step(train_detr.detr_step_loss(5))(state, batch)
    m.eval()
    assert float(one) == float(two)
    # the update moved every param (one forward's grads reached them all)
    assert all(not torch.equal(before[k], p) for k, p in m.named_parameters())
    assert all(bool(torch.isfinite(g).all()) for g in g_two)
    m.load_state_dict(sd)


# ------------------------------------------------------------ full width

@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("name,spec", [("detr_resnet50", PAPER_RPE), ("detr_resnet18", "")])
def test_full_width_matches_golden(golden, name, spec):
    """detr_resnet50 (iRPE-K) and detr_resnet18 (plain) at full width on the
    padded 160 x 224 batch: logits and boxes of the final output, and seeded
    query rows of every auxiliary output, within 1e-4 of the largest."""
    torch.set_num_threads(2)
    m = create_model(name, enc_rpe2d=spec, aux_loss=True, device="cpu")
    m.load_state_dict(golden_weights(m, int(golden["weight_seed"])))
    x, mask = padded_batch(int(golden["input_seed"]), 2, GOLDEN_HW)
    with torch.no_grad():
        out = m(torch.from_numpy(x), torch.from_numpy(mask))
    tag = name.split("_")[1]
    rows = golden["rows"]
    checks = [(out["pred_logits"], golden[f"{tag}_logits"]),
              (out["pred_boxes"], golden[f"{tag}_boxes"]),
              (torch.stack([a["pred_logits"][:, rows] for a in out["aux_outputs"]]),
               golden[f"{tag}_aux_logits_rows"]),
              (torch.stack([a["pred_boxes"][:, rows] for a in out["aux_outputs"]]),
               golden[f"{tag}_aux_boxes_rows"])]
    for got, want in checks:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-4 * np.abs(want).max())


QUERY_STD = 30.0


def golden_weights(model, seed: int) -> dict:
    """`seeded_state_dict` with the query embedding drawn N(0, QUERY_STD²)
    from default_rng(seed + 1). Random-init queries decode to nearly the
    same boxes (spread ~4e-4 at N(0, 1)), so the Hungarian matching has
    near-ties (cost margins ~1e-5) that fp32 and float64 break apart;
    queries this far apart make every output's matching tie-free (margins
    >= 1e-4, `assignment_margin`)."""
    sd = seeded_state_dict(model, seed)
    q = sd["query_embed.weight"]
    sd["query_embed.weight"] = torch.from_numpy((QUERY_STD * np.random.default_rng(
        seed + 1).standard_normal(tuple(q.shape))).astype(np.float32))
    return sd


def assignment_margin(cost: np.ndarray, assign: np.ndarray, valid: np.ndarray) -> float:
    """The least cost increase of a one-step change of a Hungarian
    assignment: two targets swapping their queries, or a target moving to
    an unassigned query (over the valid targets of each image)."""
    gaps = []
    for i in range(cost.shape[0]):
        t = np.where(valid[i])[0]
        q = assign[i][t]
        c = cost[i]
        free = np.setdiff1d(np.arange(c.shape[0]), q)
        for a in range(len(t)):
            gaps.append((c[free, t[a]] - c[q[a], t[a]]).min())
            for b in range(a + 1, len(t)):
                gaps.append(c[q[a], t[b]] + c[q[b], t[a]] - c[q[a], t[a]] - c[q[b], t[b]])
    return float(min(gaps))


def detr_golden_batch(golden) -> dict:
    x, mask = padded_batch(int(golden["input_seed"]), 2, GOLDEN_HW)
    boxes, labels, valid = narrow_targets(int(golden["target_seed"]), 2, 91, GOLDEN_MAX_BOXES)
    return {"image": torch.from_numpy(x), "pad_mask": torch.from_numpy(mask),
            "boxes": torch.from_numpy(boxes), "labels": torch.from_numpy(labels),
            "valid": torch.from_numpy(valid)}


def test_full_width_step_matches_float64_golden(golden):
    """DETR-R50 iRPE-K's CLI step at full width in fp32 against JAX's in
    float64: the six assignments equal (each output's float64 costs have a
    margin >= 1e-4 between the assignment and any one-step change of it),
    the loss within 1e-4, the global grad norm within 1e-4 and the
    per-tensor grad norms within 1e-3."""
    torch.set_num_threads(2)
    m = create_model("detr_resnet50", enc_rpe2d=PAPER_RPE, aux_loss=True, device="cpu")
    m.load_state_dict(golden_weights(m, int(golden["weight_seed"])))
    b = detr_golden_batch(golden)
    m.train()
    out = m(b["image"], b["pad_mask"])
    for i, o in enumerate([out] + out["aux_outputs"]):
        with torch.no_grad():
            c = matching_cost(o["pred_logits"], o["pred_boxes"], b["boxes"], b["labels"],
                              b["valid"])
        np.testing.assert_array_equal(hungarian_assign(c.numpy(), b["valid"].numpy()),
                                      golden["assigns"][i])
    losses = criterion(out, b["boxes"], b["labels"], b["valid"], 91)
    params = dict(m.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(losses["total"], list(params.values()))))
    assert abs(float(losses["total"]) - float(golden["loss"])) <= 1e-4 * float(golden["loss"])
    for k in ("loss_ce", "loss_bbox", "loss_giou"):
        assert abs(float(losses[k]) - float(golden[k])) <= 1e-4 * abs(float(golden[k]))
    names = list(golden["names"])
    assert sorted(grads) == names
    got = np.asarray([float(grads[n].norm()) for n in names])
    want = golden["grad_norms"]
    gn = float(np.sqrt((got.astype(np.float64) ** 2).sum()))
    assert abs(gn - float(golden["grad_norm"])) <= 1e-4 * float(golden["grad_norm"])
    assert np.all(np.abs(got - want) <= 1e-3 * want + 1e-7 * want.max()), \
        (np.abs(got - want) / want).max()


def test_cli_synthetic_run_on_cpu(tmp_path):
    """The CLI's synthetic mode end to end: the JAX CLI's draws, finite
    losses, the history written."""
    out = tmp_path / "detr.json"
    res = train_detr.main(["--cpu", "--synthetic", "--steps", "3", "--batch-size", "2",
                           "--image-size", "64", "--num-classes", "4", "--out", str(out)])
    h = res["history"]
    assert len(h) == 3 and all(np.isfinite(r["total"]) for r in h)
    assert out.exists()
    b = train_detr.synthetic_batches(2, 64, 6, 4, 2, 0)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(b[0]["image"], rng.standard_normal((2, 64, 64, 3))
                                  .astype(np.float32))


def write_golden(path: Path = GOLDEN) -> None:
    """JAX's DETR-R50 iRPE-K and DETR-R18 on the port's seeded weights: the
    outputs in fp32, one R50 train step in float64."""
    rows = np.sort(np.random.default_rng(ROWS_SEED).choice(100, 12, replace=False))
    x, mask = padded_batch(INPUT_SEED, 2, GOLDEN_HW)
    rec = dict(weight_seed=WEIGHT_SEED, input_seed=INPUT_SEED, target_seed=TARGET_SEED,
               rows=rows)
    models = {}
    for name, spec in (("detr_resnet50", PAPER_RPE), ("detr_resnet18", "")):
        port = create_model(name, enc_rpe2d=spec, aux_loss=True, device="cpu")
        sd = golden_weights(port, WEIGHT_SEED)
        jm = getattr(JD, name)(enc_rpe2d=spec, aux_loss=True)
        template = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x),
                                                  jnp.asarray(mask)))
        v = jax_variables(sd, template)
        out = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(mask))
        tag = name.split("_")[1]
        rec[f"{tag}_logits"] = np.asarray(out["pred_logits"])
        rec[f"{tag}_boxes"] = np.asarray(out["pred_boxes"])
        rec[f"{tag}_aux_logits_rows"] = np.stack(
            [np.asarray(a["pred_logits"])[:, rows] for a in out["aux_outputs"]])
        rec[f"{tag}_aux_boxes_rows"] = np.stack(
            [np.asarray(a["pred_boxes"])[:, rows] for a in out["aux_outputs"]])
        models[name] = (port, v)
    port, v = models["detr_resnet50"]
    boxes, labels, valid = narrow_targets(TARGET_SEED, 2, 91, GOLDEN_MAX_BOXES)
    jax.config.update("jax_enable_x64", True)
    jm = JD.detr_resnet50(enc_rpe2d=PAPER_RPE, aux_loss=True, dtype=jnp.float64)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    x64, b64 = jnp.asarray(x, jnp.float64), jnp.asarray(boxes, jnp.float64)
    out = jax.jit(jm.apply)(v, x64, jnp.asarray(mask))
    costs = [np.asarray(JDET.matching_cost(o["pred_logits"], o["pred_boxes"], b64, labels,
                                           valid)) for o in [out] + out["aux_outputs"]]
    assigns = [JDET.hungarian_assign(c, valid) for c in costs]
    margins = [assignment_margin(c, a, valid) for c, a in zip(costs, assigns)]
    assert min(margins) >= 1e-4, margins

    def loss_fn(p):
        o = jm.apply({"params": p, "constants": v["constants"]}, x64, jnp.asarray(mask))
        total, main = 0.0, None
        for oo, a in zip([o] + o["aux_outputs"], assigns):
            l = JDET.detection_loss(oo, b64, labels, valid, jnp.asarray(a), 91, 0.1,
                                    jnp.maximum(valid.sum(), 1.0).astype(jnp.float64))
            main = l if main is None else main
            total = total + l["loss_ce"] + 5.0 * l["loss_bbox"] + 2.0 * l["loss_giou"]
        return total, main
    (loss, main), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    jax.config.update("jax_enable_x64", False)
    named = detr_state_dict_from_jax({"params": grads, "constants": v["constants"]})
    names = sorted(n for n, _ in port.named_parameters())
    np.savez_compressed(
        path, **rec, assigns=np.stack(assigns), assignment_margin=float(np.min(margins)),
        loss=float(loss), **{k: float(main[k]) for k in ("loss_ce", "loss_bbox", "loss_giou")},
        names=np.asarray(names),
        grad_norms=np.asarray([np.linalg.norm(named[n].numpy()) for n in names], np.float32),
        grad_norm=float(np.sqrt(sum(np.sum(np.square(np.asarray(g), dtype=np.float64))
                                    for g in jax.tree_util.tree_leaves(grads)))))
    print(f"wrote {path} ({path.stat().st_size} bytes), loss {float(loss):.6f}, "
          f"assignment margin {float(np.min(margins)):.3e}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
