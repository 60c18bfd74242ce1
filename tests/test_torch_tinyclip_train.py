"""cream_tpu_torch's TinyCLIP training path vs the JAX package's, on the CPU:
the L0 gates (`distill/l0.py`), the contrastive and affinity losses with
their all_gather path (`distill/clip_losses.py`, a 2-process gloo run),
`prune_clip`, `weight_inherit`, the L0 distillation step over three steps
against JAX's `run_stage`, the pipeline CLI (manual inheritance, two L0
stages, kill and resume) and the full-width TinyCLIP-39M/16 step against
the stored JAX golden.

JAX's threefry noise cannot be drawn in torch: the tests compute the
uniforms JAX's `sample_masks` draws (the same key splits) and hand them to
the port's `sample_masks(uniforms=...)`.

Regenerate the golden file (one fp32 JAX L0 distill step of
tinyclip_vit_39m_16_text_19m at B=2 on the seeded weights) with
    PYTHONPATH=.:tests python tests/test_torch_tinyclip_train.py
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cream_tpu.cli import tinyclip_pipeline as jax_pipeline
from cream_tpu.distill import clip_losses as jax_losses
from cream_tpu.distill import l0 as jax_l0
from cream_tpu.distill.weight_inherit import weight_inherit as jax_weight_inherit
from cream_tpu.models import create_model as jax_create_model
from cream_tpu.models.clip import CLIP as JaxCLIP
from cream_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from cream_tpu.models.clip import prune_clip as jax_prune_clip
from cream_tpu.zoo import import_torch as jit
from cream_tpu_torch.cli import tinyclip_pipeline
from cream_tpu_torch.cli.speed_test import tinyclip_train_throughput
from cream_tpu_torch.distill import clip_losses, l0
from cream_tpu_torch.distill.weight_inherit import weight_inherit
from cream_tpu_torch.models import create_model
from cream_tpu_torch.models.clip import CLIP, CLIPConfig, prune_clip
from cream_tpu_torch.zoo.load import clip_state_dict_from_jax, seeded_state_dict

import chip_smoke
from test_torch_clip import (NARROW, _jax_gates, _np, _np_sd, gate_set, golden_text,
                             narrow_clip, pair_inputs, port_features)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "torch_port" / "tinyclip_39m_train_seed0.npz"
GOLDEN_MODEL = "tinyclip_vit_39m_16_text_19m"


# ---- helpers ----

def jax_uniforms(key, params) -> dict:
    """The uniforms JAX's `sample_masks(key, params, ...)` draws in
    training, by mask name (tuples of rows for ragged loga): the same key
    splits in the same order."""
    out = {}
    for pname, mname in l0.MASK_NAMES.items():
        if pname not in params:
            continue
        rows = params[pname] if isinstance(params[pname], tuple) else (params[pname],)
        drawn = []
        for r in rows:
            key, sub = jax.random.split(key)
            drawn.append(np.asarray(jax.random.uniform(
                sub, r.shape, minval=jax_l0.EPS, maxval=1 - jax_l0.EPS)))
        out[mname] = tuple(drawn) if isinstance(params[pname], tuple) else drawn[0]
    return out


def torch_tree(tree):
    """numpy leaves (tuples kept) -> torch tensors."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree, np.float32))


def l0_pair(cfg, seed: int = 0, mean: float = 1.0, std: float = 2.5):
    """The same random l0 params on both sides: (port params, JAX params)."""
    rng = np.random.default_rng(seed)
    port = l0.init_l0_params(cfg)
    with torch.no_grad():
        for v in l0.named_l0(port).values():
            v.copy_(torch.from_numpy(rng.normal(mean, std, tuple(v.shape)).astype(np.float32)))
        port["lambda_1"].fill_(float(rng.uniform(1, 5)))
        port["lambda_2"].fill_(float(rng.uniform(1, 5)))
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(_np(t)), port, is_leaf=is_tensor)
    return port, jp


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def leaves(tree) -> list:
    return jax.tree_util.tree_leaves(tree, is_leaf=is_tensor)


def assert_tree_close(got, want, atol, what=""):
    """Equal structure (None entries on both sides alike) and leaves within
    `atol`."""
    if isinstance(want, dict):
        assert {k for k, v in got.items() if v is not None} == \
            {k for k, v in want.items() if v is not None}, what
        for k, w in want.items():
            if w is not None:
                assert_tree_close(got[k], w, atol, f"{what}/{k}")
    elif isinstance(want, (tuple, list)):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, atol, f"{what}/{i}")
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0,
                                   err_msg=what)


L0_CFGS = {
    "uniform": l0.L0Config(128, 512, 2, 2),
    "uniform-no-layer": l0.L0Config(128, 512, 2, 2, ("hidden", "heads", "intermediate")),
    "ragged": l0.L0Config(100, 400, 2, 3, heads_per_layer=(0, 2, 1),
                          intermediate_per_layer=(100, 300, 0)),
    "ragged-no-layer": l0.L0Config(100, 400, 2, 3, ("hidden", "heads", "intermediate"),
                                   heads_per_layer=(0, 2, 1),
                                   intermediate_per_layer=(100, 300, 0)),
}


def jax_cfg(cfg):
    return jax_l0.L0Config(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


# ---- L0 gates ----

@pytest.mark.parametrize("name", L0_CFGS)
def test_init_l0_params_matches_jax(name):
    cfg = L0_CFGS[name]
    port = l0.init_l0_params(cfg, init_mean=3.0)
    want = jax_l0.init_l0_params(jax_cfg(cfg), init_mean=3.0)
    assert set(port) == set(want)
    assert_tree_close(port, want, atol=0)
    for t in l0.named_l0(port).values():
        assert t.is_leaf and t.requires_grad and t.dtype == torch.float32
    assert isinstance(port["heads_loga"], tuple) == name.startswith("ragged")
    assert (cfg.prunable_model_size, cfg.params_per_head) == (
        jax_cfg(cfg).prunable_model_size, jax_cfg(cfg).params_per_head)


@pytest.mark.parametrize("name", L0_CFGS)
def test_sampled_masks_and_their_grads_match_jax(name):
    """Training masks from JAX's uniforms: the values (1e-6) and the grads
    of a weighted sum of every mask with respect to every loga (1e-6),
    against jax.grad; the generator path draws masks in [0, 1]."""
    cfg = L0_CFGS[name]
    port, jp = l0_pair(cfg, seed=1)
    key = jax.random.key(7)
    want = jax_l0.sample_masks(key, jp, jax_cfg(cfg))
    got = l0.sample_masks(port, uniforms=torch_tree(jax_uniforms(key, jp)))
    assert_tree_close(got, want, atol=1e-6, what=name)

    rng = np.random.default_rng(2)
    weights = [rng.standard_normal(np.shape(z)).astype(np.float32)
               for z in jax.tree_util.tree_leaves(want)]

    def jax_total(p):
        masks = jax_l0.sample_masks(key, p, jax_cfg(cfg))
        return sum((z * w).sum() for z, w in zip(jax.tree_util.tree_leaves(masks), weights))

    jgrad = l0.named_l0(jax.grad(jax_total)(jp))
    total = sum((z * torch.from_numpy(w)).sum() for z, w in zip(leaves(got), weights))
    named = l0.named_l0(port)
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    for k, g in zip(named, grads):
        np.testing.assert_allclose(_np(g), np.asarray(jgrad[k]), atol=1e-6, rtol=0,
                                   err_msg=k)

    drawn = l0.sample_masks(port, generator=torch.Generator().manual_seed(0))
    assert [z.shape for z in leaves(drawn)] == [z.shape for z in leaves(got)]
    assert all(bool(((z >= 0) & (z <= 1)).all()) for z in leaves(drawn))


@pytest.mark.parametrize("name", L0_CFGS)
def test_deterministic_masks_match_jax(name):
    """Inference masks: the soft values (1e-6) and the hard zeros at the
    same entries."""
    cfg = L0_CFGS[name]
    port, jp = l0_pair(cfg, seed=3)
    want = jax_l0.sample_masks(jax.random.key(0), jp, jax_cfg(cfg), training=False)
    got = l0.sample_masks(port, training=False)
    assert_tree_close(got, want, atol=1e-6, what=name)
    for g, w in zip(leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(_np(g) == 0, np.asarray(w) == 0)
    assert any(bool((g == 0).any()) for g in leaves(got))


def test_deterministic_z_drops_the_same_tied_entries_as_jax():
    """Sixteen equal log-alphas expect 2.69 zeros: numpy's argsort picks
    which three of the tied entries drop, on both sides."""
    loga = np.zeros(16, np.float32)
    loga[[3, 9]] = 5.0
    got = _np(l0.deterministic_z(torch.from_numpy(loga)))
    want = np.asarray(jax_l0.deterministic_z(jnp.asarray(loga)))
    assert (want == 0).sum() == 2
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    rows = (np.zeros(5, np.float32), np.zeros(0, np.float32), np.zeros(11, np.float32))
    got = l0.sample_masks({"heads_loga": tuple(map(torch.from_numpy, rows)),
                           "lambda_1": torch.tensor(1.0)}, training=False)["heads_z"]
    want = jax_l0.sample_masks(jax.random.key(0), {"heads_loga": tuple(map(jnp.asarray, rows))},
                               None, training=False)["heads_z"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("step", [0, 3, 9])
@pytest.mark.parametrize("name", L0_CFGS)
def test_sparsity_and_lagrangian_and_their_grads_match_jax(name, step):
    """expected_sparsity, the warmed-up target and the lagrangian (1e-6
    relative) and the lagrangian's grads with respect to every loga and
    both multipliers (1e-6), against jax.grad."""
    cfg = L0_CFGS[name]
    port, jp = l0_pair(cfg, seed=4, mean=2.0, std=1.5)
    (jloss, (js, jt)), jgrad = jax.value_and_grad(
        lambda p: (lambda o: (o[0], o[1:]))(jax_l0.lagrangian_loss(
            p, jax_cfg(cfg), 0.6, jnp.asarray(step), 6)), has_aux=True)(jp)
    loss, s, t = l0.lagrangian_loss(port, cfg, 0.6, step, 6)
    s, t = s.detach(), t.detach()
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    np.testing.assert_allclose(float(t), float(jt), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert (float(loss) > 0) == (step > 0)                 # the target ramps from 0
    named = l0.named_l0(port)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    jnamed = l0.named_l0(jgrad)
    for k, g in zip(named, grads):
        np.testing.assert_allclose(_np(g), np.asarray(jnamed[k]), atol=1e-6, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(float(l0.expected_sparsity(port, cfg)),
                               float(jax_l0.expected_sparsity(jp, jax_cfg(cfg))), rtol=1e-6)


def test_negate_lambda_grads_is_the_sign_mask():
    cfg = L0_CFGS["ragged"]
    port, jp = l0_pair(cfg, seed=5)
    grads = {k: torch.full_like(v, 2.0) for k, v in l0.named_l0(port, "v.").items()}
    signs = l0.named_l0(jax_l0.lambda_sign_mask(jp), "v.")
    for k, g in l0.negate_lambda_grads(grads).items():
        np.testing.assert_array_equal(_np(g), 2.0 * np.asarray(signs[k]))


# ---- losses ----

def loss_inputs(B=6, d=16, seed=0):
    rng = np.random.default_rng(seed)

    def unit():
        x = rng.standard_normal((B, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    return unit(), unit(), unit(), unit(), np.float32(20.0), np.float32(30.0)


@pytest.mark.parametrize("kind", ["contrastive", "soft", "soft-two"])
def test_clip_losses_and_feature_grads_match_jax(kind):
    """Values (1e-6 relative) and the grads with respect to the student's
    features and logit scale (1e-6 of their largest magnitude: the logit
    scale of 20 multiplies them), against jax.grad."""
    img, txt, t_img, t_txt, scale, t_scale = loss_inputs()

    def jfn(i, t, s):
        if kind == "contrastive":
            return jax_losses.clip_contrastive_loss(i, t, s)
        out = jax_losses.clip_soft_loss(i, t, s, t_img, t_txt, t_scale,
                                        average_two_losses=kind == "soft")
        return out if kind == "soft" else out[0] + 2 * out[1]

    jl, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2))(img, txt, scale)
    pi, pt, ps = (torch.tensor(x, requires_grad=True) for x in (img, txt, scale))
    if kind == "contrastive":
        loss = clip_losses.clip_contrastive_loss(pi, pt, ps)
    else:
        out = clip_losses.clip_soft_loss(pi, pt, ps, torch.from_numpy(t_img),
                                         torch.from_numpy(t_txt), torch.tensor(t_scale),
                                         average_two_losses=kind == "soft")
        loss = out if kind == "soft" else out[0] + 2 * out[1]
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for g, w in zip(torch.autograd.grad(loss, (pi, pt, ps)), jg):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, atol=1e-6 * np.abs(w).max(), rtol=0)


_GLOO_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from cream_tpu_torch.distill.clip_losses import clip_contrastive_loss, clip_soft_loss

    rank, port, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    d = np.load(inp)
    B = d["img"].shape[0] // 2
    part = lambda k: torch.from_numpy(d[k][rank * B:(rank + 1) * B])
    img, txt = part("img").requires_grad_(), part("txt").requires_grad_()
    scale = torch.tensor(d["scale"], requires_grad=True)
    c = clip_contrastive_loss(img, txt, scale, group=dist.group.WORLD)
    s = clip_soft_loss(img, txt, scale, part("t_img"), part("t_txt"),
                       torch.tensor(d["t_scale"]), group=dist.group.WORLD)
    loss = c + s
    loss.backward()
    np.savez(out, c=c.item(), s=s.item(), img=img.grad.numpy(), txt=txt.grad.numpy(),
             scale=scale.grad.numpy())
    dist.barrier()  # neither rank tears gloo down while the other still talks to it
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gather_matches_one_process(tmp_path):
    """The all_gather path on 2 gloo processes, each holding half the batch:
    the contrastive and soft losses equal the one-process losses on the
    whole batch, and the features' grads (each rank's rows) and the summed
    logit-scale grads equal the one-process grads (1e-6)."""
    img, txt, t_img, t_txt, scale, t_scale = loss_inputs(B=8, seed=3)
    inp = tmp_path / "in.npz"
    np.savez(inp, img=img, txt=txt, t_img=t_img, t_txt=t_txt, scale=scale, t_scale=t_scale)
    script = tmp_path / "worker.py"
    script.write_text(_GLOO_WORKER)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(inp),
                               str(tmp_path / f"out{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-3000:]
    res = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]

    pi, pt, ps = (torch.tensor(x, requires_grad=True) for x in (img, txt, scale))
    c = clip_losses.clip_contrastive_loss(pi, pt, ps)
    s = clip_losses.clip_soft_loss(pi, pt, ps, torch.from_numpy(t_img),
                                   torch.from_numpy(t_txt), torch.tensor(t_scale))
    (c + s).backward()
    np.testing.assert_allclose(float(c), float(jax_losses.clip_contrastive_loss(
        img, txt, scale)), rtol=1e-6)
    for r in res:
        np.testing.assert_allclose(float(r["c"]), float(c), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(r["s"]), float(s), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.concatenate([r["img"] for r in res]), _np(pi.grad),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.concatenate([r["txt"] for r in res]), _np(pt.grad),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(sum(float(r["scale"]) for r in res), float(ps.grad),
                               atol=1e-6, rtol=1e-6)


# ---- prune_clip ----

def _jax_prune(variables, vm, tm, cfg=None):
    pm, pv = jax_prune_clip(variables, cfg or JaxCLIPConfig(**NARROW), vm, tm)
    return pm, clip_state_dict_from_jax(pv)


def _assert_sd_equal(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


def test_prune_clip_matches_jax_on_soft_gates():
    """Soft (non-0/1) gates on every type and both towers, with whole-branch
    drops (the last layer's attention, layer 0's MLP, head 0 of layer 0):
    the pruned state_dict is JAX's bit for bit; the pruned model's features
    equal the gated full model's (1e-5) wherever the text tower's hidden
    gate is 0/1 (see the next test)."""
    port = narrow_clip()
    rng = np.random.default_rng(9)
    vm, tm = (gate_set(rng, 128, 2, 2, 512) for _ in range(2))
    _, want = _jax_prune(jit.convert_clip(_np_sd(port.state_dict()), 2, 2), vm, tm)
    model, got = prune_clip(port.state_dict(), port.cfg, vm, tm)
    _assert_sd_equal(got, want)
    _assert_sd_equal(model.state_dict(), want)
    assert model.visual.transformer.resblocks[0].attn.heads == 1
    assert not hasattr(model.visual.transformer.resblocks[0], "mlp")
    assert not hasattr(model.transformer.resblocks[1], "attn")
    assert model.vision_heads == (1, 0) and model.cfg.vision_width == 96

    tm["hidden_z"] = (tm["hidden_z"] != 0).astype(np.float32)
    model, _ = prune_clip(port.state_dict(), port.cfg, vm, tm)
    images, text = pair_inputs()
    for g, w in zip(port_features(model, images, text),
                    port_features(port, images, text, vm, tm)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_text_hidden_gate_is_folded_by_prune_but_not_applied_by_the_forward():
    """A JAX-side inconsistency the port keeps (ROADMAP.md Queue 3): the
    text tower's gated forward does not multiply its embeddings by a soft
    hidden_z (`cream_tpu/models/clip.py` TextTower), while `prune_clip`
    folds hidden_z into the token and positional embeddings, so the pruned
    text features move away from the gated ones; the image features do
    not. The port's forward and prune follow JAX's: the same gap on both
    sides (1e-5)."""
    port = narrow_clip()
    rng = np.random.default_rng(9)
    vm, tm = (gate_set(rng, 128, 2, 2, 512) for _ in range(2))
    variables = jit.convert_clip(_np_sd(port.state_dict()), 2, 2)
    pm, pv = jax_prune_clip(variables, JaxCLIPConfig(**NARROW), vm, tm)
    images, text = pair_inputs()
    jgap = [np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.jit(pm.apply)(pv, jnp.asarray(images), jnp.asarray(text)),
        jax.jit(JaxCLIP(cfg=JaxCLIPConfig(**NARROW)).apply)(
            variables, jnp.asarray(images), jnp.asarray(text), _jax_gates(vm), _jax_gates(tm)))]
    model, _ = prune_clip(port.state_dict(), port.cfg, vm, tm)
    gap = [np.abs(a - b).max() for a, b in zip(port_features(model, images, text),
                                                port_features(port, images, text, vm, tm))]
    assert gap[0] < 1e-5 and jgap[0] < 1e-5
    assert gap[1] > 0.05 and jgap[1] > 0.05
    np.testing.assert_allclose(gap[1], jgap[1], atol=1e-5)


def test_reprune_of_a_ragged_model_matches_jax():
    """A pruned (ragged) model pruned again by gates that follow its ragged
    layout (deterministic masks of ragged L0 params with a quarter of the
    gates near 0): the state_dict is JAX's bit for bit, the model smaller,
    its features those of the gated ragged model."""
    port = narrow_clip()
    rng = np.random.default_rng(9)
    vm, tm = (gate_set(rng, 128, 2, 2, 512, hard=True) for _ in range(2))
    variables = jit.convert_clip(_np_sd(port.state_dict()), 2, 2)
    pm, pv = jax_prune_clip(variables, JaxCLIPConfig(**NARROW), vm, tm)
    ragged, sd = prune_clip(port.state_dict(), port.cfg, vm, tm)
    cfgs = tinyclip_pipeline.clip_l0_cfgs(ragged)
    masks = {}
    for k, c in cfgs.items():
        p, _ = l0_pair(c, seed=11 if k == "v" else 12, mean=4.0, std=4.0)
        masks[k] = l0.sample_masks(p, training=False)
    jm = {k: jax.tree_util.tree_map(lambda t: jnp.asarray(_np(t)), m, is_leaf=is_tensor)
          for k, m in masks.items()}
    _, want = _jax_prune(pv, jm["v"], jm["t"], pm.cfg)
    again, got = prune_clip(sd, ragged.cfg, masks["v"], masks["t"])
    _assert_sd_equal(got, want)
    assert tinyclip_pipeline.n_params(got) < tinyclip_pipeline.n_params(sd)
    images, text = pair_inputs()
    # the text tower's hidden gates are soft: compare the image features
    with torch.no_grad():
        want = ragged(torch.from_numpy(images), torch.from_numpy(text), masks["v"], masks["t"])
    np.testing.assert_allclose(port_features(again, images, text)[0], _np(want[0]),
                               atol=1e-5, rtol=0)


# ---- weight inheritance ----

@pytest.mark.parametrize("depths", [(2, 2), (4, 2)])
def test_weight_inherit_matches_jax(depths):
    """A 128-wide teacher of `depths[0]` layers a tower into a 64-wide
    student of `depths[1]` (one head: head-aware in_proj slices): the port's
    state_dict is JAX's `weight_inherit` bit for bit."""
    big_cfg = CLIPConfig(**{**NARROW, "vision_layers": depths[0], "text_layers": depths[0]})
    small_cfg = CLIPConfig(**{**NARROW, "vision_width": 64, "text_width": 64,
                              "vision_layers": depths[1], "text_layers": depths[1],
                              "text_heads": 1})
    teacher = narrow_clip(cfg=big_cfg)
    student = CLIP(small_cfg, device="cpu")
    got = weight_inherit(student.state_dict(), teacher.state_dict())
    jt = jit.convert_clip(_np_sd(teacher.state_dict()), depths[0], depths[0])["params"]
    js = jit.convert_clip(_np_sd(student.state_dict()), depths[1], depths[1])["params"]
    want = clip_state_dict_from_jax({"params": jax_weight_inherit(js, jt)})
    _assert_sd_equal(got, want)
    student.load_state_dict(got)
    if depths == (4, 2):       # interval_front: student block 1 is teacher block 2
        np.testing.assert_array_equal(
            _np(got["transformer.resblocks.1.mlp.c_fc.bias"]),
            _np(teacher.state_dict()["transformer.resblocks.2.mlp.c_fc.bias"])[:256])


# ---- the L0 distillation step ----

STEP_CFG = dict(embed_dim=64, vision_width=128, vision_layers=2, vision_patch=16,
                image_size=32, text_width=128, text_layers=2, text_heads=2,
                context_length=8, vocab_size=1000)
STEP_ARGS = dict(lr=1e-3, l0_lr=0.1, l0_init_mean=2.0, sparsity_warmup=2,
                 contrastive_weight=1.0, prune_text=True, seed=0)


class _RecordingJax:
    """`jax` as JAX's pipeline module sees it, with `jit` recording every
    output of the jitted step (trainable, opt, loss, vision sparsity)."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def run(*args):
            out = jitted(*args)
            self.outputs.append(out)
            return out
        return run


def jax_run_stage_steps(variables, batches, n, tmp_path, monkeypatch):
    """JAX's `run_stage` for `n` steps of stage 0 (ended by --stop-after):
    its step outputs."""
    rec = _RecordingJax()
    monkeypatch.setattr(jax_pipeline, "jax", rec)
    args = argparse.Namespace(**STEP_ARGS, steps=n, save_every=0, stop_after=n,
                              out=str(tmp_path))
    cfg = JaxCLIPConfig(**STEP_CFG)
    assert jax_pipeline.run_stage(JaxCLIP(cfg=cfg), variables, cfg, 0.25, batches, args,
                                  0) is None
    monkeypatch.undo()
    return rec.outputs


def step_uniforms(n, l0_params) -> list[dict]:
    """The uniforms of JAX's run_stage steps 0..n-1 at stage 0: the step key
    is split off key(seed), and both towers' masks draw from that one key."""
    rng, out = jax.random.key(STEP_ARGS["seed"]), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append({k: torch_tree(jax_uniforms(sub, p)) for k, p in l0_params.items()})
    return out


def _jax_adam(opt, group: str):
    """(mu, nu, count) of one group of JAX's multi_transform Adam."""
    st = opt.inner_states[group].inner_state[0]
    return st.mu[group], st.nu[group], int(st.count)


def _port_named(tree: dict, group: str) -> dict:
    """A JAX trainable-shaped subtree -> the port's names for that group."""
    if group == "model":
        return clip_state_dict_from_jax({"params": tree})
    return {f"{k}.{n}": torch.from_numpy(np.array(v)) for k, p in tree.items()
            for n, v in l0.named_l0(p).items()}


@torch.no_grad()
def _load_jax_state(trainer, tr, opt, step: int) -> None:
    """The port trainer set to JAX's state: weights, gates, multipliers,
    both optimizers' moments and counts, the step."""
    trainer.student.load_state_dict(_port_named(tr["model"], "model"))
    for k, t in trainer.named_l0().items():
        t.copy_(_port_named(tr["l0"], "l0")[k])
    for group, tx in (("model", trainer.opt_model), ("l0", trainer.opt_l0)):
        mu, nu, count = _jax_adam(opt, group)
        mu, nu = _port_named(mu, group), _port_named(nu, group)
        tx.count = count
        tx.slots = {n: {"mu": mu[n].clone(), "nu": nu[n].clone()} for n in mu}
    trainer.steps = step


def _grads(tx, prev: dict) -> dict:
    """The grads of the last update, read off Adam's first moments:
    mu = b1 * mu_prev + (1 - b1) * g."""
    return {n: (s["mu"].numpy() - tx.b1 * prev.get(n, 0.0)) / (1 - tx.b1)
            for n, s in tx.slots.items()}


def test_narrow_l0_distill_three_steps_match_jax_run_stage(tmp_path, monkeypatch):
    """Three steps of the L0 distillation step (the CLI's defaults: Adam
    1e-3 on the weights and 0.1 on the gates and multipliers; gates from
    log-alpha 2, as the smoke run starts them) against JAX's run_stage fed
    the same uniforms.

    Before the first step: the L0 grads (loga and multipliers, through the
    model and the lagrangian) against jax.grad of the same loss (1e-6).
    The port's own three steps: after each, the loss (1e-5 relative), both
    towers' expected sparsity and the multipliers (1e-5); the weights and
    loga within 2 * lr per step (Adam's first updates are ~lr * sign(g),
    and an element whose grad sits at float noise moves either way).
    Each step again from JAX's state before it (weights, gates, both
    optimizers' moments and counts): the loss, the grads read off the
    first moments (1e-4 of each tensor's largest: the multipliers' grads
    are the gap to the target, an fp32 difference), and every weight, loga
    and multiplier within 1e-5, except the elements whose grad on either
    side is below 1e-5 of its tensor's largest, held to 2 * lr (a
    k-projection bias's grad is 0 up to float noise: the softmax ignores
    it): under 0.5% of the elements."""
    model = CLIP(CLIPConfig(**STEP_CFG), device="cpu")
    model.load_state_dict(seeded_state_dict(model, 3))
    variables = jit.convert_clip(_np_sd(model.state_dict()), 2, 2)
    batches = [tuple(jnp.asarray(x.numpy()) for x in b)
               for b in tinyclip_pipeline.synthetic_pairs(4, 32, 8, 2, seed=0)]
    outputs = jax_run_stage_steps(variables, batches, 3, tmp_path, monkeypatch)
    assert len(outputs) == 3
    lrs = {"model": STEP_ARGS["lr"], "l0": STEP_ARGS["l0_lr"]}

    def new_trainer():
        m = CLIP(CLIPConfig(**STEP_CFG), device="cpu")
        m.load_state_dict(model.state_dict())
        return tinyclip_pipeline.L0Distill(m, target_sparsity=0.25, **{
            k: v for k, v in STEP_ARGS.items() if k != "seed"})

    def port_state(trainer) -> dict:
        return {"model": trainer.student.state_dict(), "l0": trainer.named_l0()}

    trainer = new_trainer()
    jcfgs = {k: jax_cfg(c) for k, c in trainer.cfgs.items()}
    uniforms = step_uniforms(3, {k: jax_l0.init_l0_params(c) for k, c in jcfgs.items()})
    # the JAX step's shared key: the text tower's noise is the vision tower's
    np.testing.assert_array_equal(_np(uniforms[0]["v"]["hidden_z"]),
                                  _np(uniforms[0]["t"]["hidden_z"]))
    torch_batches = [tuple(torch.from_numpy(np.array(x)) for x in b) for b in batches]

    images, text = torch_batches[0]
    loss, _ = trainer.loss(images, text, uniforms=uniforms[0])
    named = trainer.named_l0()
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    key = jax.random.split(jax.random.key(STEP_ARGS["seed"]))[1]
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jax_l0_step_loss(
        JaxCLIPConfig(**STEP_CFG), variables["params"], variables["params"], p, jcfgs,
        batches[0],
        {"v": key, "t": key}, 0)))(
        {k: jax_l0.init_l0_params(c, STEP_ARGS["l0_init_mean"]) for k, c in jcfgs.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(jloss), float(outputs[0][2]), rtol=1e-6)
    for k, g in grads.items():
        tower, name = k.split(".", 1)
        np.testing.assert_allclose(_np(g), np.asarray(l0.named_l0(jgrads[tower])[name]),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert float(grads["v.hidden_loga"].abs().max()) > 1e-4      # the model's share flows

    for i, (tr, _, jloss, jsv) in enumerate(outputs):
        loss, sparsity = trainer.step(*torch_batches[i % 2], uniforms=uniforms[i])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(sparsity["v"]), float(jsv), atol=1e-5)
        for tower, p in trainer.l0.items():
            for lam in ("lambda_1", "lambda_2"):
                np.testing.assert_allclose(float(p[lam]), float(tr["l0"][tower][lam]),
                                           atol=1e-5)
            np.testing.assert_allclose(
                float(l0.expected_sparsity(p, trainer.cfgs[tower]).detach()),
                float(jax_l0.expected_sparsity(tr["l0"][tower], jcfgs[tower])), atol=1e-5)
        for group, got in port_state(trainer).items():
            want = _port_named(tr[group], group)
            for k, v in got.items():
                np.testing.assert_allclose(_np(v), _np(want[k]), rtol=0,
                                           atol=2 * lrs[group] * (i + 1),
                                           err_msg=f"step {i} {k}")
    assert float(trainer.l0["v"]["lambda_1"]) > 10.0       # the multipliers ascend

    excused = total = 0
    before = None
    forced = new_trainer()
    for i, (tr, opt, jloss, _) in enumerate(outputs):
        if before is not None:
            _load_jax_state(forced, *before, i)
        txs = {"model": forced.opt_model, "l0": forced.opt_l0}
        prev = {g: {n: s["mu"].numpy().copy() for n, s in tx.slots.items()}
                for g, tx in txs.items()}
        loss, _ = forced.step(*torch_batches[i % 2], uniforms=uniforms[i])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for group, got in port_state(forced).items():
            got_g = _grads(txs[group], prev[group])
            jprev = {} if before is None else {
                n: v.numpy() for n, v in _port_named(_jax_adam(before[1], group)[0],
                                                     group).items()}
            want_g = {n: (v.numpy() - 0.9 * jprev.get(n, 0.0)) / 0.1
                      for n, v in _port_named(_jax_adam(opt, group)[0], group).items()}
            want = _port_named(tr[group], group)
            for k, v in got.items():
                scale = np.abs(want_g[k]).max()
                np.testing.assert_allclose(got_g[k], want_g[k], atol=1e-4 * scale, rtol=0,
                                           err_msg=f"step {i} grad {k}")
                noise = np.maximum(np.abs(got_g[k]), np.abs(want_g[k])) < 1e-5 * scale
                excused += int((noise & (want_g[k] != 0)).sum())
                total += want_g[k].size
                err = np.abs(_np(v) - _np(want[k]))
                assert err[~noise].max(initial=0) <= 1e-5, (i, k, err[~noise].max())
                assert err.max() <= 2 * lrs[group], (i, k)
        before = (tr, opt)
    assert excused < 0.005 * total, (excused, total)


def jax_l0_step_loss(model_cfg, params, teacher_params, l0_params, jcfgs, batch, keys,
                     step, target=0.25, warmup=STEP_ARGS["sparsity_warmup"]):
    """run_stage's loss (cream_tpu/cli/tinyclip_pipeline.py: the student at
    `params` with sampled masks, the teacher at `teacher_params`, the soft
    and contrastive losses, each tower's lagrangian), each tower's masks
    from its own key in `keys` (run_stage passes one key to both)."""
    model = JaxCLIP(cfg=model_cfg)
    img, txt = batch
    masks = {k: jax_l0.sample_masks(keys[k], l0_params[k], jcfgs[k]) for k in jcfgs}
    img_f, txt_f, scale = model.apply({"params": params}, img, txt,
                                      image_masks=masks["v"], text_masks=masks["t"])
    t_img, t_txt, t_scale = model.apply({"params": teacher_params}, img, txt)
    loss = jax_losses.clip_soft_loss(img_f, txt_f, scale, jax.lax.stop_gradient(t_img),
                                     jax.lax.stop_gradient(t_txt), t_scale)
    loss = loss + STEP_ARGS["contrastive_weight"] * jax_losses.clip_contrastive_loss(
        img_f, txt_f, scale)
    for k in ("v", "t"):
        loss = loss + jax_l0.lagrangian_loss(l0_params[k], jcfgs[k], target, step, warmup)[0]
    return loss


def test_teacher_is_a_frozen_copy_and_bf16_gate_grads_reach_fp32_loga():
    """The teacher holds its own tensors (a student update leaves it, and
    the soft loss, where they were); in a bf16 model the gates' grads reach
    the fp32 loga."""
    model = narrow_clip(torch.bfloat16)
    trainer = tinyclip_pipeline.L0Distill(model, lr=1e-3, l0_lr=0.1, target_sparsity=0.25,
                                          sparsity_warmup=2, l0_init_mean=2.0)
    t0 = {k: v.clone() for k, v in trainer.teacher.state_dict().items()}
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        trainer.teacher.parameters(), trainer.student.parameters()))
    images, text = (torch.from_numpy(x) for x in pair_inputs())
    gen = torch.Generator().manual_seed(0)
    loss, _ = trainer.loss(images, text, generator=gen)
    named = trainer.named_l0()
    grads = torch.autograd.grad(loss, list(named.values()))
    for (k, t), g in zip(named.items(), grads):
        assert t.dtype == g.dtype == torch.float32, k
    assert all(float(g.abs().max()) > 0 for k, g in zip(named, grads)
               if k.endswith(("hidden_loga", "heads_loga", "intermediate_loga")))
    trainer.step(images, text, generator=gen)
    trainer.step(images, text, generator=gen)
    for k, v in trainer.teacher.state_dict().items():
        assert torch.equal(v, t0[k]), k
    assert not torch.equal(trainer.student.visual.proj, t0["visual.proj"])
    assert not any(p.requires_grad for p in trainer.teacher.parameters())


def test_jax_towers_share_mask_noise_and_the_port_draws_them_apart():
    """The JAX-side fault (ROADMAP.md Queue 3): JAX's run_stage and bench
    step pass one key to `sample_masks` for both towers, so at
    TinyCLIP-39M/16 (both towers 512 wide, 8 heads) the text tower's
    hidden_z noise equals the vision tower's and its heads_z and
    intermediate_z noise the first 6 rows of the vision tower's. The port
    draws each tower's noise from the generator in turn (the reference's
    l0 modules draw from the torch RNG apiece): independent draws."""
    c = create_model(GOLDEN_MODEL, device="meta").cfg
    cfgs = {"v": jax_pipeline.tower_l0_cfg(c.vision_width, c.vision_layers,
                                           c.vision_width // 64),
            "t": jax_pipeline.tower_l0_cfg(c.text_width, c.text_layers, c.text_heads)}
    params = {k: jax_l0.init_l0_params(cfg) for k, cfg in cfgs.items()}
    key = jax.random.key(3)
    jv, jt = (jax_l0.sample_masks(key, params[k], cfgs[k]) for k in ("v", "t"))
    np.testing.assert_array_equal(np.asarray(jv["hidden_z"]), np.asarray(jt["hidden_z"]))
    uv, ut = (jax_uniforms(key, params[k]) for k in ("v", "t"))
    for name in ("hidden_z", "heads_z", "intermediate_z"):
        np.testing.assert_array_equal(uv[name][:c.text_layers]
                                      if uv[name].ndim == 2 else uv[name], ut[name])
    model = CLIP(c, device="meta")
    port_cfgs = tinyclip_pipeline.clip_l0_cfgs(model)
    assert port_cfgs == {k: l0.L0Config(**{f: getattr(v, f) for f in v.__dataclass_fields__})
                         for k, v in cfgs.items()}
    p = {k: l0.init_l0_params(cfg, init_mean=0.0) for k, cfg in port_cfgs.items()}
    gen = torch.Generator().manual_seed(3)
    mv, mt = (l0.sample_masks(p[k], generator=gen) for k in ("v", "t"))
    assert not torch.equal(mv["hidden_z"], mt["hidden_z"])
    assert float((mv["heads_z"][:6] - mt["heads_z"]).abs().max()) > 0.1


def test_tinyclip_train_timing_refuses_a_cpu_model():
    with pytest.raises(RuntimeError, match="CUDA"):
        tinyclip_train_throughput(narrow_clip(), 2)


# ---- the pipeline CLI ----

PIPE = ["--device", "cpu", "--synthetic", "--sparsities", "0.25", "0.333", "--steps", "6",
        "--batch-size", "4", "--image-size", "32", "--vision-width", "128",
        "--vision-layers", "2", "--text-width", "128", "--text-layers", "2",
        "--context", "8", "--l0-lr", "0.5", "--l0-init-mean", "2.0"]


def test_manual_inherit_reports_jax_param_counts(tmp_path):
    """--manual-inherit shrinks widths and depths and front-slices: the
    param counts of each stage are JAX main's."""
    args = PIPE[2:] + ["--manual-inherit"]
    got = tinyclip_pipeline.main(["--device", "cpu", *args, "--out", str(tmp_path / "p")])
    jax_pipeline.main(["--cpu", *args, "--out", str(tmp_path / "j")])
    want = json.loads((tmp_path / "j" / "report.json").read_text())
    assert [r.get("params") for r in got] == [r.get("params") for r in want]
    assert [r.get("vision_width") for r in got] == [r.get("vision_width") for r in want]
    assert np.isfinite(got[-1]["final_pair_similarity"])


def test_l0_pipeline_shrinks_both_towers_and_writes_loadable_stages(tmp_path):
    """Two L0 stages: each fuse shrinks both towers; each stage's file
    loads into the ragged model `zoo.load.load_pruned_clip` builds."""
    from cream_tpu_torch.zoo.load import load_pruned_clip
    report = tinyclip_pipeline.main(PIPE + ["--out", str(tmp_path)])
    params = [r["params"] for r in report if "params" in r]
    assert params[0] > params[1] > params[2]
    assert report[1]["vision_width"] < 128 and report[1]["text_width"] < 128
    assert report[2]["vision_width"] <= report[1]["vision_width"]
    assert report[2]["text_width"] <= report[1]["text_width"]
    cfg = CLIPConfig(embed_dim=64, vision_width=128, vision_layers=2, vision_patch=16,
                     image_size=32, text_width=128, text_layers=2, text_heads=2,
                     context_length=8)
    model, sd = load_pruned_clip(cfg, str(tmp_path / "stage_1.pt"), device="cpu")
    model.load_state_dict(sd)
    assert tinyclip_pipeline.n_params(sd) == params[2]


def test_killed_stage_resumes_bit_exact(tmp_path):
    """A run killed after 4 steps of stage 0 (a mid-stage checkpoint every
    2) and restarted ends where the unbroken run ends, bit for bit."""
    common = PIPE[:PIPE.index("--sparsities")] + ["--sparsities", "0.25", "--steps", "8"] + \
        PIPE[PIPE.index("--batch-size"):]
    a = tinyclip_pipeline.main(common + ["--out", str(tmp_path / "a")])
    assert tinyclip_pipeline.main(common + ["--out", str(tmp_path / "b"), "--save-every",
                                            "2", "--stop-after", "4"]) is None
    assert (tmp_path / "b" / "mid_stage_0.pt").exists()
    b = tinyclip_pipeline.main(common + ["--out", str(tmp_path / "b"), "--save-every", "2"])
    assert not (tmp_path / "b" / "mid_stage_0.pt").exists()
    assert a == b
    sa, sb = (torch.load(tmp_path / d / "stage_0.pt") for d in ("a", "b"))
    assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_pipeline_refuses_without_synthetic_and_without_cuda(tmp_path):
    with pytest.raises(SystemExit):
        tinyclip_pipeline.main(["--device", "cpu", "--out", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tinyclip_pipeline.main(["--synthetic", "--out", str(tmp_path)])


# ---- full width: TinyCLIP-39M/16 against the stored JAX golden ----

GOLDEN_STEP = dict(l0_init_mean=2.0, step=500, target=0.25, warmup=1000)


def jax_train_golden() -> dict:
    """One fp32 JAX L0 distillation step of TinyCLIP-39M/16 at B=2: the
    bench's gates (hidden, heads, intermediate on both towers) from
    log-alpha 2, step 500 of a 1,000-step warmup toward 0.25, each tower's
    masks from its own key; the loss, the global and per-tensor grad norms
    (the port's names), the L0 grads, and the uniforms the masks drew."""
    port = create_model(GOLDEN_MODEL, device="cpu")
    c = port.cfg
    variables = jit.convert_clip(_np_sd(seeded_state_dict(port, 0)), c.vision_layers,
                                 c.text_layers)
    images = chip_smoke.clip_golden_images(1)
    text = golden_text(np.random.default_rng(2))
    jcfgs = {k: jax_cfg(v) for k, v in tinyclip_pipeline.clip_l0_cfgs(port).items()}
    l0_params = {k: jax_l0.init_l0_params(v, GOLDEN_STEP["l0_init_mean"])
                 for k, v in jcfgs.items()}
    kv, kt = jax.random.split(jax.random.key(0))
    fn = lambda p, lp: jax_l0_step_loss(
        jax_create_model(GOLDEN_MODEL).cfg, p, variables["params"], lp, jcfgs,
        (jnp.asarray(images), jnp.asarray(text)), {"v": kv, "t": kt},
        GOLDEN_STEP["step"], GOLDEN_STEP["target"], GOLDEN_STEP["warmup"])
    loss, (gp, gl) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(variables["params"],
                                                                      l0_params)
    grads = {k: _np(v) for k, v in clip_state_dict_from_jax({"params": gp}).items()}
    names = sorted(grads)
    out = {"loss": np.asarray(loss), "names": np.asarray(names),
           "grad_norms": np.asarray([np.linalg.norm(grads[n]) for n in names], np.float32),
           "grad_norm": np.asarray(np.sqrt(sum((grads[n].astype(np.float64) ** 2).sum()
                                               for n in names)), np.float32),
           "text": text, "input_seed": np.int64(1), "weight_seed": np.int64(0),
           **{k: np.asarray(v) for k, v in GOLDEN_STEP.items()}}
    for k, key in (("v", kv), ("t", kt)):
        out.update({f"u_{k}_{m}": u for m, u in jax_uniforms(key, l0_params[k]).items()})
        out.update({f"l0grad_{k}.{n}": np.asarray(v)
                    for n, v in l0.named_l0(gl[k]).items()})
    return out


def test_full_width_tinyclip_train_step_matches_golden():
    """The fp32 B=2 L0 distillation step of TinyCLIP-39M/16 on the CPU
    against the stored JAX golden: the loss (2e-5 relative: JAX's fp32 sum
    of the 24,576 MLP gate scores puts its expected sparsity 1.1e-6 off
    the float64 value, the port's 1.4e-8), the global and every per-tensor
    grad norm (1e-4: the soft loss's grad is the student's softmax less
    the teacher's, an fp32 difference of close rows; 1e-7 of the global
    norm for grads at float noise), every L0 grad (1e-4 of its largest
    magnitude)."""
    g = np.load(GOLDEN)
    loss, grads, l0_grads = chip_smoke.clip_train_golden_step(g, "cpu")
    np.testing.assert_allclose(float(loss), float(g["loss"]), rtol=2e-5)
    assert sorted(grads) == list(g["names"])
    got = np.asarray([float(grads[n].norm()) for n in g["names"]])
    np.testing.assert_allclose(float(np.sqrt((got.astype(np.float64) ** 2).sum())),
                               float(g["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(got, g["grad_norms"], rtol=1e-4,
                               atol=1e-7 * float(g["grad_norm"]))
    errs = chip_smoke.l0_grad_errors(g, l0_grads)
    assert len(errs) == 10 and max(errs.values()) <= 1e-4, errs
    assert all(np.abs(g[f"l0grad_{k}"]).max() > 0 for k in errs)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    np.savez_compressed(GOLDEN, **jax_train_golden())
    print(f"wrote {GOLDEN}")
