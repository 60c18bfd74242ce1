"""cream_tpu_torch's tensor × data parallelism of the CLIP towers on the CPU:
4 gloo ranks at (data 2, model 2) against the JAX package on the conftest's
virtual CPU devices and against the unsplit port model.

One 4-rank run (`ranks`, started once on a thread and read by every test
that needs it; the ranks import torch only and write npz files) does, on a
narrow CLIP (4 heads of 64 a tower, width 256, 2 layers, context 16) whose
full weights every rank draws from one seed and cuts to its shard
(`models.clip.split_clip`):
  a. the forward of the global batch of 8 (4 rows a data rank), the
     features gathered over the data group; the same under a soft gate set
     on both towers;
  b. with remat on, the contrastive loss's grads, averaged over the data
     group and gathered over the model group, and their global norm;
  c. one Adam(1e-4) contrastive step (`train.steps.make_contrastive_step`),
     the weights gathered, each rank's own shard kept; a checkpoint of the
     split state (saved whole) and its restore.
The JAX side runs JAX's own test of the sharded CLIP (`tests/test_clip.py`,
`TestTensorParallel`): the replicated and the `CLIP_TP_RULES`-sharded
forward and the sharded Adam step on a (data 2, model 2) mesh.
"""
import concurrent.futures
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cream_tpu.core.mesh import CLIP_TP_RULES as JAX_TP_RULES
from cream_tpu.core.mesh import create_mesh, partition_by_rules as jax_partition_by_rules
from cream_tpu.distill.clip_losses import clip_contrastive_loss as jax_contrastive
from cream_tpu.models.clip import CLIP as JaxCLIP
from cream_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from cream_tpu.zoo import import_torch as jit
from cream_tpu_torch.core import mesh, tensor_parallel as tp
from cream_tpu_torch.core.dryrun import dryrun_multichip, launch_ranks
from cream_tpu_torch.core.tensor_parallel import ModelShard
from cream_tpu_torch.models.clip import CLIP, CLIPConfig, split_clip
from cream_tpu_torch.train import optim
from cream_tpu_torch.train.steps import contrastive_loss_and_grads
from cream_tpu_torch.zoo.load import seeded_state_dict

from torch_threads import one_torch_thread_module  # noqa: F401

DATA, MODEL = 2, 2
BATCH, LR, WEIGHT_SEED = 8, 1e-4, 0
TP_CLIP = dict(embed_dim=64, vision_width=256, vision_layers=2, vision_patch=16,
               image_size=64, text_width=256, text_layers=2, text_heads=4,
               context_length=16, vocab_size=1000)
HEADS, MLP = 4, 1024

# the ranks' program: torch only
_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from cream_tpu_torch.core import checkpoint, mesh
    from cream_tpu_torch.core.tensor_parallel import (ModelShard, current_shard, gather_tree,
                                                      split_group)
    from cream_tpu_torch.models.clip import CLIP, CLIPConfig, split_clip
    from cream_tpu_torch.train import optim
    from cream_tpu_torch.train.state import TrainState
    from cream_tpu_torch.train.steps import (contrastive_loss_and_grads,
                                             data_parallel_mean, make_contrastive_step)
    from cream_tpu_torch.zoo.load import seeded_state_dict

    inp, out = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    mesh.init_distributed("cpu", model=int(sys.argv[3]))
    d = dict(np.load(inp))
    cfg = CLIPConfig(**{k[4:]: int(v) for k, v in d.items() if k.startswith("cfg|")})
    r, dr, D = mesh.rank(), mesh.data_rank(), mesh.data_size()
    n = d["images"].shape[0] // D
    images = torch.from_numpy(d["images"][dr * n:(dr + 1) * n])
    text = torch.from_numpy(d["text"][dr * n:(dr + 1) * n])
    gates = [{k.split("|")[1]: torch.from_numpy(v) for k, v in d.items()
              if k.startswith(tower + "|")} for tower in ("vision", "text")]
    res = {"layout": np.asarray([mesh.data_rank(), mesh.model_rank(), mesh.data_size(),
                                 mesh.model_size()])}

    def split(remat=False):
        full = CLIP(cfg, remat=remat, device="cpu")
        full.load_state_dict(seeded_state_dict(full, int(d["seed"])))
        return split_clip(full, current_shard())

    model = split()
    with torch.no_grad():
        for tag, g in (("plain", ()), ("gated", gates)):
            img, txt, scale = model(images, text, *g)
            res[f"{tag}|image"] = mesh.all_gather_rows(img).numpy()
            res[f"{tag}|text"] = mesh.all_gather_rows(txt).numpy()

    remat = split(remat=True)
    loss, grads = contrastive_loss_and_grads(remat, images, text)
    data_parallel_mean(grads, {})
    res["remat|loss"] = float(loss)
    groups = [split_group(p) for p in remat.parameters()]
    res["remat|grad_norm"] = float(optim.global_norm(grads.values(), groups))
    for k, v in gather_tree(grads, mesh.model_group()).items():
        res[f"remat|grad|{k}"] = v.numpy()

    state = TrainState(model, optim.make_adamw(float(d["lr"]), weight_decay=0.0,
                                               clip_grad=None))
    state, metrics = make_contrastive_step()(state, images, text)
    res["step|loss"] = float(metrics["loss"])
    res["step|grad_norm"] = float(metrics["grad_norm"])
    for k, v in model.state_dict().items():
        res[f"own|{k}"] = v.numpy().copy()
    for k, v in gather_tree(model.state_dict(), mesh.model_group()).items():
        res[f"step|{k}"] = v.numpy().copy()

    ckpt = f"{out}/ckpt"
    checkpoint.save_checkpoint(ckpt, state.step, state)   # every rank; rank 0 writes
    mesh.barrier()
    fresh = TrainState(split(), optim.make_adamw(float(d["lr"]), weight_decay=0.0,
                                                 clip_grad=None))
    checkpoint.restore_checkpoint(ckpt, fresh)
    res["restored_equal"] = all(
        torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                          model.state_dict().values())) and all(
        torch.equal(state.tx.slots[k]["nu"], fresh.tx.slots[k]["nu"]) for k in state.tx.slots)
    refused = []
    for group in (mesh.data_group(), torch.distributed.group.WORLD):
        try:
            ModelShard(mesh.model_rank(), mesh.model_size(), group)
            refused.append(False)
        except ValueError:
            refused.append(True)
    res["foreign_groups_refused"] = np.asarray(refused)
    np.savez(f"{out}/rank{r}.npz", **res)
    mesh.barrier()
    torch.distributed.destroy_process_group()
""")


def tokens(rng, batch: int, length: int, vocab: int) -> np.ndarray:
    """SOT, random ids, EOT (the highest id), zero padding."""
    out = np.zeros((batch, length), np.int64)
    for i in range(batch):
        n = int(rng.integers(3, length - 1))
        out[i, 0] = vocab - 2
        out[i, 1:n] = rng.integers(1, vocab - 2, n - 1)
        out[i, n] = vocab - 1
    return out


def soft_gates(rng, layers: int, heads: int, mlp: int, width: int) -> dict:
    """Every gate set, soft values with some zeros."""
    g = {"hidden_z": rng.uniform(0.3, 1.5, width), "heads_z": rng.uniform(0.3, 1.5, (layers, heads)),
         "mha_z": rng.uniform(0.3, 1.5, layers),
         "intermediate_z": rng.uniform(0.3, 1.5, (layers, mlp)),
         "ffn_z": rng.uniform(0.3, 1.5, layers)}
    g["hidden_z"][: width // 8] = 0
    g["heads_z"][0, 1] = 0
    g["intermediate_z"][:, ::5] = 0
    return {k: v.astype(np.float32) for k, v in g.items()}


def inputs() -> dict:
    rng = np.random.default_rng(11)
    c = TP_CLIP
    d = {"images": rng.standard_normal((BATCH, c["image_size"], c["image_size"], 3)).astype(
             np.float32),
         "text": tokens(rng, BATCH, c["context_length"], c["vocab_size"]),
         "seed": np.int64(WEIGHT_SEED), "lr": np.float64(LR)}
    d.update({f"cfg|{k}": np.int64(v) for k, v in c.items()})
    for tower, width, layers, heads in (("vision", 256, 2, HEADS), ("text", 256, 2, HEADS)):
        d.update({f"{tower}|{k}": v
                  for k, v in soft_gates(rng, layers, heads, MLP, width).items()})
    return d


class _Ranks:
    """The 4-rank run and `dryrun_multichip(4, "cpu")`, started on threads;
    `result()` and `dryrun()` wait for them."""

    def __init__(self, tmp: Path):
        self.tmp, self.inputs = tmp, inputs()
        np.savez(tmp / "in.npz", **self.inputs)
        (tmp / "worker.py").write_text(_WORKER)
        self._pool = concurrent.futures.ThreadPoolExecutor(2)
        self._run = self._pool.submit(
            launch_ranks, DATA * MODEL,
            [str(tmp / "worker.py"), str(tmp / "in.npz"), str(tmp), str(MODEL)], 300.0)
        self._dry = self._pool.submit(dryrun_multichip, 4, "cpu", 300.0)
        self._res = None

    def result(self) -> list[dict]:
        if self._res is None:
            self._run.result()
            self._res = [dict(np.load(self.tmp / f"rank{r}.npz")) for r in range(DATA * MODEL)]
        return self._res

    def dryrun(self) -> dict:
        return self._dry.result()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("tp_ranks"))
    yield r
    r._pool.shutdown()


def full_model(remat=False) -> CLIP:
    m = CLIP(CLIPConfig(**TP_CLIP), remat=remat, device="cpu")
    m.load_state_dict(seeded_state_dict(m, WEIGHT_SEED))
    return m


def _np_sd(sd) -> dict:
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def jax_side(ranks):
    """JAX's test of the sharded CLIP on the port's seeded weights: the
    replicated forward, the forward and one Adam step with the parameters
    sharded by `CLIP_TP_RULES` over a (data 2, model 2) mesh."""
    d = ranks.inputs
    jm = JaxCLIP(cfg=JaxCLIPConfig(**TP_CLIP))
    v = jit.convert_clip(_np_sd(full_model().state_dict()), 2, 2)
    img, txt = jnp.asarray(d["images"]), jnp.asarray(d["text"].astype(np.int32))
    replicated = jax.jit(jm.apply)(v, img, txt)

    m22 = create_mesh({"data": DATA, "model": MODEL}, devices=jax.devices()[:DATA * MODEL])
    param_sh = jax_partition_by_rules(v["params"], JAX_TP_RULES, m22)
    data_sh = NamedSharding(m22, P("data"))
    p = jax.device_put(v["params"], param_sh)
    img, txt = jax.device_put(img, data_sh), jax.device_put(txt, data_sh)
    sharded = jax.jit(lambda p, i, t: jm.apply({"params": p}, i, t))(p, img, txt)
    tx = optax.adam(LR)
    opt = jax.jit(tx.init)(p)

    @jax.jit
    def step(p, opt, img, txt):
        def loss_fn(p):
            i_f, t_f, scale = jm.apply({"params": p}, img, txt)
            return jax_contrastive(i_f, t_f, scale).mean()
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), loss, g

    p1, loss, grads = step(p, opt, img, txt)
    k = p1["visual"]["transformer"]["resblocks_0"]["attn"]["in_proj"]["kernel"]
    assert k.sharding.spec == P(None, "model")
    return SimpleNamespace(replicated=[np.asarray(o) for o in replicated],
                           sharded=[np.asarray(o) for o in sharded],
                           params=_leaves(jax.device_get(p1)), loss=float(loss),
                           grads=_leaves(jax.device_get(grads)))


def _port_features(model, d, gates=()):
    with torch.no_grad():
        out = model(torch.from_numpy(d["images"]), torch.from_numpy(d["text"]), *gates)
    return [o.numpy() for o in out]


def _gates(d, tower):
    return {k.split("|")[1]: torch.from_numpy(v) for k, v in d.items()
            if k.startswith(tower + "|")}


def test_layout_is_jax_mesh_reshape(ranks):
    """Rank r is data index r // 2 and model index r % 2, as JAX's
    create_mesh({"data": 2, "model": 2}) reshapes its devices."""
    want = np.arange(DATA * MODEL).reshape(DATA, MODEL)
    for r, res in enumerate(ranks.result()):
        dr, mr, ds, ms = res["layout"]
        assert (ds, ms) == (DATA, MODEL) and want[dr, mr] == r


def test_tp_dp_forward_matches_jax_replicated_and_sharded(ranks, jax_side):
    """The (data 2, model 2) forward's image and text features, gathered
    over the data group, equal JAX's replicated forward and JAX's forward
    under CLIP_TP_RULES on a (2, 2) mesh: atol 2e-5, rtol 1e-4 (fp32),
    on every rank."""
    for res in ranks.result():
        for i, tag in enumerate(("image", "text")):
            got = res[f"plain|{tag}"]
            np.testing.assert_allclose(got, jax_side.replicated[i], atol=2e-5, rtol=1e-4)
            np.testing.assert_allclose(got, jax_side.sharded[i], atol=2e-5, rtol=1e-4)


def test_tp_dp_step_matches_jax_sharded_step(ranks, jax_side):
    """One Adam(1e-4) contrastive step at (data 2, model 2) against JAX's
    step on parameters sharded by CLIP_TP_RULES: the loss within 1e-5; the
    grads (averaged over the data group, gathered over the model group)
    per tensor within 1e-4 of JAX's (L2, plus 1e-7 of the global norm);
    every updated parameter (the shards gathered, `convert_clip` into JAX's
    tree) within 1e-5. Adam's first update is lr * g / (|g| + 1e-8): where
    JAX's grad is within 10x Adam's eps of 0 (k's in_proj bias, whose grad
    is 0 in exact arithmetic as the softmax ignores a per-row constant, and
    a few elements elsewhere) a grad difference of fp32 noise moves it by up
    to 2 * lr, the bound held there."""
    gn = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                     for g in jax_side.grads.values()))
    noisy = 0
    for res in ranks.result():
        np.testing.assert_allclose(res["step|loss"], jax_side.loss, rtol=0, atol=1e-5)
        sd = {k[5:]: v for k, v in res.items() if k.startswith("step|") and "loss" not in k
              and "grad_norm" not in k}
        got = _leaves(jit.convert_clip(sd, 2, 2)["params"])
        grads = _leaves(jit.convert_clip({k[11:]: v for k, v in res.items()
                                          if k.startswith("remat|grad|")}, 2, 2)["params"])
        assert set(got) == set(jax_side.params) == set(grads)
        for k, w in jax_side.params.items():
            g = jax_side.grads[k]
            err = np.linalg.norm(grads[k] - g)
            assert err <= 1e-4 * np.linalg.norm(g) + 1e-7 * gn, (k, err)
            near_zero = np.abs(g) <= 1e-7
            np.testing.assert_allclose(got[k][~near_zero], w[~near_zero], rtol=0, atol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose(got[k][near_zero], w[near_zero], rtol=0,
                                       atol=2 * LR, err_msg=k)
            noisy += int((np.abs(got[k] - w) > 1e-5).sum())
    # at most the four blocks' k biases of 256 and a few more a rank
    assert noisy <= 4 * (4 * 256 + 32), noisy


def test_replicated_params_bit_identical_across_model_peers(ranks):
    """After the step, every replicated parameter is the same bits on the
    two model peers of each data rank, and on every rank; each split one
    differs between peers (their own shards)."""
    res = ranks.result()
    specs = mesh.partition_by_rules([k[4:] for k in res[0] if k.startswith("own|")],
                                    mesh.CLIP_TP_RULES)
    assert sum(s is not None for s in specs.values()) == 4 * 6
    for name, spec in specs.items():
        k = f"own|{name}"
        if spec is None:
            for r in res[1:]:
                np.testing.assert_array_equal(r[k], res[0][k], err_msg=name)
        else:
            assert not np.array_equal(res[0][k], res[1][k]), name
            np.testing.assert_array_equal(res[0][k], res[2][k], err_msg=name)


def test_tp_gated_forward_equals_unsplit_port(ranks):
    """heads_z and intermediate_z sliced to each rank's heads and channels,
    hidden_z, mha_z and ffn_z after the model group's sum: the split
    model's gated features equal the unsplit port model's (fp32, 2e-6)."""
    d = ranks.inputs
    want = _port_features(full_model(), d, (_gates(d, "vision"), _gates(d, "text")))
    for res in ranks.result():
        np.testing.assert_allclose(res["gated|image"], want[0], atol=2e-6, rtol=0)
        np.testing.assert_allclose(res["gated|text"], want[1], atol=2e-6, rtol=0)


def test_tp_remat_grads_equal_unsplit_port(ranks):
    """With remat on (the recomputed forward repeats the model group's
    sums), the contrastive grads averaged over the data group and gathered
    over the model group equal the unsplit port model's grads of the
    global batch's loss: per tensor within 1e-4 of its norm (plus 1e-7 of
    the global norm); the loss within 1e-6."""
    d = ranks.inputs
    model = full_model(remat=True)
    loss, grads = contrastive_loss_and_grads(model, torch.from_numpy(d["images"]),
                                             torch.from_numpy(d["text"]))
    gn = float(optim.global_norm(grads.values()))
    for res in ranks.result():
        np.testing.assert_allclose(res["remat|loss"], float(loss), rtol=1e-6)
        for k, w in grads.items():
            err = np.linalg.norm(res[f"remat|grad|{k}"] - w.numpy())
            assert err <= 1e-4 * np.linalg.norm(w.numpy()) + 1e-7 * gn, (k, err)


def test_clip_by_global_norm_under_tp_equals_unsplit_norm(ranks):
    """The step's grad norm with each shard counted once (summed over the
    model group) equals the unsplit grads' norm (1e-6), where a norm of the
    rank's own shards alone would not."""
    d = ranks.inputs
    _, grads = contrastive_loss_and_grads(full_model(), torch.from_numpy(d["images"]),
                                          torch.from_numpy(d["text"]))
    want = float(optim.global_norm(grads.values()))
    for res in ranks.result():
        np.testing.assert_allclose(res["remat|grad_norm"], want, rtol=1e-6)
        np.testing.assert_allclose(res["step|grad_norm"], want, rtol=1e-6)
    own = {k: torch.from_numpy(v) for k, v in ranks.result()[0].items()
           if k.startswith("remat|grad|")}
    assert abs(float(optim.global_norm(own.values())) - want) <= 1e-6 * want
    half = tp.shard_state_dict(grads, 0, MODEL)
    assert float(optim.global_norm(half.values())) < want * (1 - 1e-3)
    clipped = optim.clip_by_global_norm(grads, want / 2)
    np.testing.assert_allclose(float(optim.global_norm(clipped.values())), want / 2,
                               rtol=1e-6)


def test_split_checkpoint_saves_whole_and_restores_the_shard(ranks):
    """The split state's checkpoint holds the full state dict (it loads into
    the unsplit model on one card: the gathered weights), and restoring it
    into a split state gives each rank its shard and its Adam slots."""
    from cream_tpu_torch.core.checkpoint import restore_params
    res = ranks.result()
    sd = restore_params(str(ranks.tmp / "ckpt"))
    model = full_model()
    model.load_state_dict(sd)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), res[0][f"step|{k}"], err_msg=k)
    assert all(bool(r["restored_equal"]) for r in res)


@pytest.mark.parametrize("size", [2, 4])
def test_shard_then_gather_state_dict_is_exact(size):
    """shard_state_dict at every model rank, then gather_state_dict: the
    same tensors bit for bit; the training-state tree (weights, Adam slots
    by name) round-trips too; the shards have the split shapes."""
    sd = full_model().state_dict()
    shards = [tp.shard_state_dict(sd, r, size) for r in range(size)]
    back = tp.gather_state_dict(shards)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    blk = "visual.transformer.resblocks.1"
    assert shards[1][f"{blk}.attn.in_proj_weight"].shape == (3 * 256 // size, 256)
    assert shards[1][f"{blk}.mlp.c_proj.weight"].shape == (256, MLP // size)
    q = sd[f"{blk}.attn.in_proj_weight"].reshape(3, HEADS, 64, 256)
    np.testing.assert_array_equal(
        shards[1][f"{blk}.attn.in_proj_weight"].reshape(3, HEADS // size, 64, 256).numpy(),
        q[:, HEADS // size:2 * HEADS // size].numpy())
    tree = {"step": 3, "model": sd, "tx": {"count": 3, "slots": {
        k: {"mu": v + 1, "nu": v * 2} for k, v in sd.items()}}}
    parts = [tp.shard_state_dict(tree, r, size) for r in range(size)]
    assert parts[1]["tx"]["slots"][f"{blk}.mlp.c_fc.weight"]["nu"].shape == (MLP // size, 256)
    for r in range(size):
        for k in sd:
            assert torch.equal(parts[r]["model"][k], shards[r][k]), k


def test_split_model_builds_the_shard_shapes_and_marks_them():
    """A model built with a shard holds the split shapes under the full
    names, the split parameters marked for the optimizer's norm and exactly
    those CLIP_TP_RULES splits (a shard without a group spans no model
    group, so no norm sums them); without one nothing is marked."""
    m = CLIP(CLIPConfig(**TP_CLIP), device="meta", model_shard=ModelShard(1, 4))
    sd = m.state_dict()
    assert sd["transformer.resblocks.0.attn.in_proj_bias"].shape == (3 * 64,)
    assert sd["transformer.resblocks.0.mlp.c_fc.weight"].shape == (MLP // 4, 256)
    specs = mesh.partition_by_rules(sd, mesh.CLIP_TP_RULES)
    assert {n for n, p in m.named_parameters() if tp.is_split(p)} == \
        {n for n, s in specs.items() if s is not None}
    assert optim.split_groups(dict(m.named_parameters())) == {}
    assert optim.split_groups(dict(full_model().named_parameters())) == {}


def test_a_shard_over_a_group_other_than_the_mesh_model_group_raises(ranks):
    """The split model's group has one source, `core.mesh`'s layout: a
    shard over the data group (as many ranks as the model axis, but not
    the model group) or over the world (4 ranks for a model axis of 2)
    raises on every rank."""
    for res in ranks.result():
        assert res["foreign_groups_refused"].tolist() == [True, True]


@pytest.mark.parametrize("cfg,size,layer", [
    (dict(text_heads=2), 4, "transformer.resblocks.0.attn heads"),
    (dict(vision_width=640, text_width=512, text_heads=8), 4,
     "visual.transformer.resblocks.0.attn heads"),
    (dict(text_heads=4), 3, "transformer.resblocks.0.attn heads")])
def test_a_model_size_that_does_not_divide_the_heads_raises(cfg, size, layer):
    """JAX's 2-head test CLIP at model 4, a 10-head vision tower at 4, 4
    heads at 3: the model raises, naming the layer; the state dict cut
    refuses the same."""
    c = CLIPConfig(**{**TP_CLIP, **cfg})
    with pytest.raises(ValueError, match=layer.replace(".", r"\.")):
        CLIP(c, device="meta", model_shard=ModelShard(0, size))
    sd = CLIP(c, device="meta").state_dict()
    with pytest.raises(ValueError, match="does not split"):
        tp.shard_state_dict(sd, 0, size)


def test_a_ragged_mlp_width_that_does_not_divide_raises():
    with pytest.raises(ValueError, match=r"visual\.transformer\.resblocks\.1\.mlp width"):
        CLIP(CLIPConfig(**TP_CLIP), vision_mlp_widths=(1024, 1023), device="meta",
             model_shard=ModelShard(0, 2))


def test_dryrun_multichip_on_four_cpu_ranks(ranks):
    """All three checks of the dry run on 4 gloo ranks: the data-parallel
    TinyViT-5M step, the contrastive gradient through the gather, and the
    CLIP split by heads at JAX's layout for 4 (data 1, model 4): a finite
    loss and each rank's in_proj grad of the shard's shape."""
    res = ranks.dryrun()
    assert res["step"] == 1 and np.isfinite(res["loss"])
    assert np.isfinite(res["contrastive"]["grad"]).all()
    t = res["tensor_parallel"]
    assert t["layout"] == (1, 4) and np.isfinite(t["loss"])
    assert t["in_proj_grad_shapes"] == [(3 * 256 // 4, 256)] * 4


def test_one_card_layout_is_the_identity():
    """Without a group: no model axis, rank 0 of 1 on both axes; a model
    axis without a group raises."""
    assert mesh.model_group() is None and tp.current_shard() is None
    assert (mesh.model_rank(), mesh.model_size(), mesh.data_rank(), mesh.data_size()) == \
        (0, 1, 0, 1)
    with pytest.raises(ValueError, match="needs a process group"):
        mesh.init_distributed("cpu", model=2)

