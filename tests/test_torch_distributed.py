"""cream_tpu_torch's data parallelism on the CPU: gloo ranks against the JAX
package's `data` mesh and against one rank.

Two ranks run as gloo processes (`core.dryrun.launch_ranks`, torchrun's
environment on a free port); they import torch only and write npz files.
The JAX side runs here, on the conftest's virtual CPU devices. One 2-rank
run (`ranks`, started once and read by every test that needs it) does:
  a. 3 data-parallel steps of a narrow TinyViT (fp32, global batch 8, drop
     path 0) on seeded batches, the grads each step applied recorded;
  b. one such step on a batch whose rank-1 half is x 3 + 2 (other
     statistics than rank 0's);
  c. the same step with BatchNorm's moments per rank (the fault that a
     step which averages grads alone makes);
  d. 2 SGD steps at drop path 0.2;
  e. `cli.eval` on a synthetic set; f. `cli.search_evolution`; g. the
     zero-shot classifier of a narrow CLIP.
A one-rank group runs part d as well. The one-rank references of e-g run
here, without a group, with one torch thread as the ranks have.
"""
import concurrent.futures
import inspect
import json
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cream_tpu.core import prng as jax_prng
from cream_tpu.core.mesh import create_mesh
from cream_tpu.data.imagenet import SyntheticDataset as JaxSyntheticDataset
from cream_tpu.data.imagenet import train_loader as jax_train_loader
from cream_tpu.distill.clip_losses import clip_contrastive_loss as jax_contrastive
from cream_tpu.models.tinyvit import TinyViT as JaxTinyViT
from cream_tpu.train import TrainState as JaxTrainState
from cream_tpu.train import losses as jax_losses
from cream_tpu.train import make_train_step as jax_make_train_step
from cream_tpu.train import optim as jax_optim
from cream_tpu.zoo.import_torch import convert_tinyvit
import cream_tpu.cli.train as jax_cli_train
from cream_tpu_torch.cli import eval as cli_eval
from cream_tpu_torch.cli import search_evolution
from cream_tpu_torch.cli.train import steps_per_epoch
from cream_tpu_torch.core import mesh, prng, profiling
from cream_tpu_torch.core.dryrun import dryrun_multichip, launch_ranks
from cream_tpu_torch.data.imagenet import SyntheticDataset, train_loader
from cream_tpu_torch.models.clip import CLIP, CLIPConfig
from cream_tpu_torch.models.tinyvit import TinyViT
from cream_tpu_torch.train import losses, optim
from cream_tpu_torch.train.state import TrainState
from cream_tpu_torch.train.steps import make_train_step, step_generator
from cream_tpu_torch.train.zero_shot import build_zero_shot_classifier
from cream_tpu_torch.zoo.load import seeded_state_dict

from test_torch_train import IMG, LR, NARROW, _jax_tree, _leaves
from torch_threads import one_torch_thread_module  # noqa: F401

GLOBAL_BATCH, WORLD = 8, 2
DEPTHS = NARROW["depths"]
CLIP_NARROW = dict(embed_dim=64, vision_width=128, vision_layers=2, vision_patch=16,
                   image_size=64, text_width=128, text_layers=2, text_heads=2,
                   context_length=16, vocab_size=1000)
CLASSNAMES = ["cat", "dog", "bird", "fish", "horse"]
TEMPLATES = ["a photo of a {}.", "a {} in the wild.", "itap of a {}."]
EVAL_ARGV = ["--device", "cpu", "model.name=tiny_vit_5m_224", "model.dtype=float32",
             "model.img_size=64", "data.img_size=64", "data.dataset=synthetic",
             "data.batch_size=12", "data.num_workers=1"]
EVO_ARGV = ["--device", "cpu", "--space", "tiny", "--allow-random", "--param-min", "4e6",
            "--param-max", "9e6", "--population", "4", "--epochs", "1",
            "--max-eval-batches", "3", "model.dtype=float32", "model.num_classes=10",
            "model.img_size=32", "data.img_size=32", "data.dataset=synthetic",
            "data.batch_size=8", "data.num_workers=1"]

# the ranks' program: torch only; `tokens` is repeated in `_tokens` below
_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    from cream_tpu_torch.cli import eval as cli_eval
    from cream_tpu_torch.cli import search_evolution
    from cream_tpu_torch.core import mesh
    from cream_tpu_torch.models.clip import CLIP, CLIPConfig
    from cream_tpu_torch.models.tinyvit import TinyViT
    from cream_tpu_torch.nn import layers
    from cream_tpu_torch.train import losses, optim
    from cream_tpu_torch.train.state import TrainState
    from cream_tpu_torch.train.steps import make_train_step
    from cream_tpu_torch.train.zero_shot import build_zero_shot_classifier
    from cream_tpu_torch.zoo.load import seeded_state_dict

    inp, out, cfg = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    mesh.init_distributed("cpu")
    assert mesh.data_group() is not None
    torch.set_num_threads(1)
    r, W = mesh.rank(), mesh.world_size()
    d = np.load(inp)
    res = {}

    def rows(a):
        b = a.shape[0] // W
        return torch.from_numpy(a[r * b:(r + 1) * b])

    def narrow(dp):
        m = TinyViT(img_size=cfg["img"], device="cpu", drop_path_rate=dp, **cfg["narrow"])
        m.load_state_dict(seeded_state_dict(m, 5))
        mesh.broadcast_module(m)
        return m

    def run(tag, m, batches, tx, ema=0.0, seed=0):
        state = TrainState(m, tx, ema_decay=ema)
        step, apply = make_train_step(loss_fn=losses.soft_target_ce), state.apply_gradients
        for i, k in enumerate(batches):
            grads = {}
            def record(g):
                grads.update({n: v.clone() for n, v in g.items()})
                return apply(g)
            state.apply_gradients = record
            state, metrics = step(state, {"image": rows(d["x" + k]), "label": rows(d["y" + k])},
                                  seed)
            res[f"{tag}|loss{i}"] = float(metrics["loss"])
            res[f"{tag}|gn{i}"] = float(metrics["grad_norm"])
            for n, v in grads.items():
                res[f"{tag}|grad{i}|{n}"] = v.numpy()
            if i == 0:
                for n, v in m.state_dict().items():
                    res[f"{tag}|sd0|{n}"] = v.numpy().copy()
        for n, v in m.state_dict().items():
            res[f"{tag}|final|{n}"] = v.numpy().copy()

    def adamw(m, lr):
        return optim.make_adamw(lr, weight_decay=0.05, clip_grad=5.0,
                                params=dict(m.named_parameters()))

    def sgd(m):
        return optim.make_sgd(0.01, momentum=0.9, weight_decay=1e-4,
                              params=dict(m.named_parameters()))

    m = narrow(0.2)
    run("d", m, ["0", "1"], sgd(m), seed=7)
    if W == 1:                                  # the one-rank group: part d alone
        np.savez(f"{out}/rank{r}.npz", **res)
        sys.exit(0)
    m = narrow(0.0)
    run("a", m, ["0", "1", "2"], adamw(m, optim.cosine_schedule(*cfg["lr"])), ema=0.9)
    m = narrow(0.0)
    run("b", m, ["s"], adamw(m, 1e-3))
    layers.data_group = lambda: None            # BatchNorm's moments per rank
    m = narrow(0.0)
    run("c", m, ["s"], adamw(m, 1e-3))
    layers.data_group = mesh.data_group

    acc = cli_eval.main(cfg["eval_argv"])
    res.update({f"e|{k}": v for k, v in acc.items() if k != "seconds"})
    top = search_evolution.main(cfg["evo_argv"] + ["--out", f"{out}/evo.json"])
    with open(f"{out}/evo_top{r}.json", "w") as fh:
        json.dump(top, fh)

    def tokens(texts, n=cfg["clip"]["context_length"]):
        ids = np.zeros((len(texts), n), np.int64)
        for i, t in enumerate(texts):
            body = [b % 997 + 1 for b in t.encode()][:n - 1]
            ids[i, :len(body) + 1] = body + [999]
        return ids

    clip = CLIP(CLIPConfig(**cfg["clip"]), device="cpu")
    clip.load_state_dict(seeded_state_dict(clip, 3))
    with torch.no_grad():
        res["g|classifier"] = build_zero_shot_classifier(
            clip.encode_text, tokens, cfg["classnames"], cfg["templates"], batch_size=2,
            device="cpu").numpy()
    np.savez(f"{out}/rank{r}.npz", **res)
    mesh.barrier()
    torch.distributed.destroy_process_group()
""")


def _tokens(texts, n=CLIP_NARROW["context_length"]):
    ids = np.zeros((len(texts), n), np.int64)
    for i, t in enumerate(texts):
        body = [b % 997 + 1 for b in t.encode()][:n - 1]
        ids[i, :len(body) + 1] = body + [999]
    return ids


def _batch(seed, batch=GLOBAL_BATCH, num_classes=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, IMG, IMG, 3)).astype(np.float32)
    return x, np.eye(num_classes, dtype=np.float32)[rng.integers(0, num_classes, batch)]


def _batches() -> dict:
    d = {}
    for i in range(3):
        d[f"x{i}"], d[f"y{i}"] = _batch(30 + i)
    xs, d["ys"] = _batch(40)
    half = GLOBAL_BATCH // WORLD
    d["xs"] = np.concatenate([xs[:half], xs[half:] * 3 + 2])
    return d


class _Ranks:
    """The 2-rank run and a one-rank group's run of part d, started on
    threads; `result()` waits for them."""

    def __init__(self, tmp: Path):
        self.tmp, self.batches = tmp, _batches()
        np.savez(tmp / "in.npz", **self.batches)
        (tmp / "worker.py").write_text(_WORKER)
        (tmp / "one").mkdir()
        cfg = json.dumps({"img": IMG, "narrow": NARROW, "lr": list(LR.values()),
                          "clip": CLIP_NARROW, "classnames": CLASSNAMES,
                          "templates": TEMPLATES, "eval_argv": EVAL_ARGV,
                          "evo_argv": EVO_ARGV})
        self._pool = concurrent.futures.ThreadPoolExecutor(2)
        self._futures = [self._pool.submit(
            launch_ranks, n, [str(tmp / "worker.py"), str(tmp / "in.npz"), str(out), cfg],
            300.0) for n, out in ((WORLD, tmp), (1, tmp / "one"))]
        self._res = None

    def result(self) -> list[dict]:
        """The two ranks' results, then the one-rank group's."""
        if self._res is None:
            for f in self._futures:
                f.result()
            self._pool.shutdown()
            self._res = [dict(np.load(self.tmp / f"rank{r}.npz")) for r in range(WORLD)]
            self._res.append(dict(np.load(self.tmp / "one" / "rank0.npz")))
        return self._res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _Ranks(tmp_path_factory.mktemp("ranks"))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tagged(res: dict, prefix: str) -> dict[str, torch.Tensor]:
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in res.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's narrow TinyViT on the seeded weights, its AdamW (the cosine
    schedule, clip 5, EMA 0.9) and train step jitted over a 2-device `data`
    mesh, and the raw grads' function, each compiled once for the module."""
    jm = JaxTinyViT(drop_path_rate=0.0, **NARROW)
    m = _narrow()
    v = convert_tinyvit({k: t.numpy().copy() for k, t in m.state_dict().items()},
                        depths=DEPTHS)
    tx = jax_optim.make_adamw(jax_optim.cosine_schedule(*LR.values()), weight_decay=0.05,
                              clip_grad=5.0, params=v["params"])
    mesh2 = create_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    step = jax_make_train_step(jm, loss_fn=jax_losses.soft_target_ce, donate=False,
                               mesh=mesh2)

    @jax.jit
    def grads(params, batch_stats, x, y):
        def loss(p):
            logits, _ = jm.apply({"params": p, "batch_stats": batch_stats}, x, train=True,
                                 mutable=["batch_stats"])
            return jax_losses.soft_target_ce(logits, y)
        return jax.grad(loss)(params)

    def state():
        # replicated over the mesh, as the step returns it: one compile
        return jax.device_put(
            JaxTrainState.create(params=v["params"], tx=tx, batch_stats=v["batch_stats"],
                                 ema_decay=0.9), NamedSharding(mesh2, P()))
    return SimpleNamespace(model=m, state=state, step=step, grads=grads)


def _narrow(dp=0.0):
    m = TinyViT(img_size=IMG, device="cpu", drop_path_rate=dp, **NARROW)
    m.load_state_dict(seeded_state_dict(m, 5))
    return m


def _grads_in_jax_layout(m, grads: dict) -> dict:
    return _leaves(_jax_tree(m, grads, DEPTHS)["params"])


def _stats_in_jax_layout(sd: dict) -> dict:
    m = _narrow()
    m.load_state_dict(sd)
    return _leaves(_jax_tree(m, dict(m.named_parameters()), DEPTHS)["batch_stats"])


def _grad_errors(got: dict, want: dict, gn: float, tol: float) -> dict:
    """Per tensor: the L2 error over its bound, `tol` of the tensor's norm
    plus 1e-7 of the global grad norm (a grad that is zero up to float
    noise, a bias right before a train-mode BN, is held at that floor, as
    `test_torch_train` holds it); within tolerance where <= 1."""
    assert set(got) == set(want)
    return {k: np.linalg.norm(got[k] - want[k]) / (tol * np.linalg.norm(want[k]) + 1e-7 * gn)
            for k in want}


def _stat_errors(got: dict, want: dict) -> dict:
    return {k: np.max(np.abs(got[k] - np.asarray(w)) / (np.abs(np.asarray(w)) + 1e-2))
            for k, w in want.items()}


def test_two_rank_step_matches_the_jax_mesh_step(ranks, jax_side):
    """3 AdamW steps (cosine schedule, clip 5, EMA 0.9) of a narrow TinyViT
    on 2 gloo ranks against JAX's `make_train_step` jitted over a 2-device
    `data` mesh on the same global batches: loss 1e-4, grad norm 1e-4 and
    per-tensor grads 1e-3 each step, BN running stats after step 1 1e-5;
    both ranks end with the same state."""
    d, j = ranks.batches, jax_side
    jstate, want = j.state(), []
    for i in range(3):
        x, y = jnp.asarray(d[f"x{i}"]), jnp.asarray(d[f"y{i}"])
        jgrads = _leaves(j.grads(jstate.params, jstate.batch_stats, x, y))
        jstate, jmetrics = j.step(jstate, {"image": x, "label": y}, jax.random.key(0))
        want.append((jmetrics, jgrads, _leaves(jstate.batch_stats)))
    r0, r1, _ = ranks.result()
    for i, (jmetrics, jgrads, jstats) in enumerate(want):
        np.testing.assert_allclose(r0[f"a|loss{i}"], float(jmetrics["loss"]), rtol=1e-4)
        np.testing.assert_allclose(r0[f"a|gn{i}"], float(jmetrics["grad_norm"]), rtol=1e-4)
        errs = _grad_errors(_grads_in_jax_layout(j.model, _tagged(r0, f"a|grad{i}|")), jgrads,
                            float(jmetrics["grad_norm"]), 1e-3)
        assert max(errs.values()) <= 1, max(errs.items(), key=lambda kv: kv[1])
        if i == 0:
            stats = _stats_in_jax_layout(_tagged(r0, "a|sd0|"))
            for k, w in jstats.items():
                np.testing.assert_allclose(stats[k], w, rtol=1e-5, atol=1e-7, err_msg=k)
    for k, v in _tagged(r0, "a|final|").items():
        np.testing.assert_array_equal(v.numpy(), r1[f"a|final|{k}"], err_msg=k)


def test_per_rank_batch_norm_misses_where_the_global_one_matches(ranks, jax_side):
    """One step on a global batch whose rank-1 half is x 3 + 2: the 2-rank
    step matches JAX's mesh step (loss 1e-4, per-tensor grads 1e-3, BN
    stats 1e-5), and a step that averages the grads but keeps BatchNorm's
    moments per rank misses all three by far more than those tolerances."""
    d, j = ranks.batches, jax_side
    jstate = j.state()
    x, y = jnp.asarray(d["xs"]), jnp.asarray(d["ys"])
    jgrads = _leaves(j.grads(jstate.params, jstate.batch_stats, x, y))
    jstate, jmetrics = j.step(jstate, {"image": x, "label": y}, jax.random.key(0))
    jloss, gn = float(jmetrics["loss"]), float(jmetrics["grad_norm"])
    jstats = _leaves(jstate.batch_stats)
    r0, _, _ = ranks.result()
    errors = {}
    for tag in ("b", "c"):
        errors[tag] = (
            abs(r0[f"{tag}|loss0"] - jloss) / jloss,
            max(_grad_errors(_grads_in_jax_layout(j.model, _tagged(r0, f"{tag}|grad0|")),
                             jgrads, gn, 1e-3).values()),
            max(_stat_errors(_stats_in_jax_layout(_tagged(r0, f"{tag}|sd0|")),
                             jstats).values()))
    assert errors["b"][0] <= 1e-4 and errors["b"][1] <= 1 and errors["b"][2] <= 1e-5, \
        errors["b"]
    assert errors["c"][0] > 1e-2 and errors["c"][1] > 100 and errors["c"][2] > 1e-1, \
        errors["c"]


def test_two_rank_drop_path_steps_equal_one_rank(ranks):
    """Drop path 0.2, 2 SGD steps (momentum 0.9): the 2-rank step (draws for
    the global batch, each rank its rows) is the one-rank step on the
    concatenated batch, the one rank a group of its own so that both take
    the global BatchNorm: loss and grad norm within 1e-6 each step, the
    final weights and BN stats within 1e-6. The first step's per-tensor
    grads within 1e-5 (L2, with `_grad_errors`' floor): the fast variance
    E[x^2] - E[x]^2 in fp32 moves by its partial sums' order (2 ranks' sums
    added against one sum), and the first conv's grad, through every block,
    by up to ~5e-6."""
    r0, r1, one = ranks.result()
    for i in range(2):
        np.testing.assert_allclose(r0[f"d|loss{i}"], one[f"d|loss{i}"], rtol=1e-6)
        np.testing.assert_allclose(r0[f"d|gn{i}"], one[f"d|gn{i}"], rtol=1e-6)
    want = {k: v.numpy() for k, v in _tagged(one, "d|grad0|").items()}
    errs = _grad_errors({k: r0[f"d|grad0|{k}"] for k in want}, want, float(one["d|gn0"]), 1e-5)
    assert max(errs.values()) <= 1, max(errs.items(), key=lambda kv: kv[1])
    for k, v in _tagged(one, "d|final|").items():
        for r in (r0, r1):
            np.testing.assert_allclose(r[f"d|final|{k}"], v.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_two_rank_drop_path_step_is_the_one_card_step(ranks, one_thread):
    """The same 2 steps on one card without a group (native BatchNorm, its
    own variance): the drop-path masks are the ranks', so loss and grad
    norm agree to the two BatchNorms' rounding (1e-5)."""
    d = ranks.batches
    m = _narrow(0.2)
    state = TrainState(m, optim.make_sgd(0.01, momentum=0.9, weight_decay=1e-4,
                                         params=dict(m.named_parameters())))
    step = make_train_step(loss_fn=losses.soft_target_ce)
    r0 = ranks.result()[0]
    for i in range(2):
        state, metrics = step(state, {"image": torch.from_numpy(d[f"x{i}"]),
                                      "label": torch.from_numpy(d[f"y{i}"])}, 7)
        np.testing.assert_allclose(r0[f"d|loss{i}"], float(metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r0[f"d|gn{i}"], float(metrics["grad_norm"]), rtol=1e-5)


def test_two_rank_drop_path_draws_the_global_batch():
    """The draw a rank takes is its rows of the draw for the global batch
    (`ops.common.uniform_rows` outside a group is the draw itself)."""
    from cream_tpu_torch.ops.common import uniform_rows
    g1, g2 = step_generator(7, 0, "cpu"), step_generator(7, 0, "cpu")
    full = torch.rand((8, 1, 1), generator=g1)
    np.testing.assert_array_equal(uniform_rows((8, 1, 1), g2).numpy(), full.numpy())


def test_eval_counts_summed_over_ranks_equal_one_rank(ranks, one_thread):
    """cli.eval on 2 ranks (each its strided slice, its last batch padded,
    the counts summed): the one-rank n and accuracies."""
    want = cli_eval.main(EVAL_ARGV)
    r0, r1, _ = ranks.result()
    for r in (r0, r1):
        assert int(r["e|n"]) == want["n"] == 64
        assert float(r["e|acc1"]) == want["acc1"] and float(r["e|acc5"]) == want["acc5"]
        np.testing.assert_allclose(float(r["e|loss"]), want["loss"], rtol=1e-6)


def test_evolution_on_two_ranks_equals_one_rank(ranks, one_thread, tmp_path):
    """cli.search_evolution on 2 ranks (each scoring its strided share of a
    candidate's batches, the counts summed): the one-rank candidates,
    scores, best config and searcher state; rank 0 wrote the file."""
    top = search_evolution.main(EVO_ARGV + ["--out", str(tmp_path / "evo.json")])
    ranks.result()
    got = json.loads((ranks.tmp / "evo.json").read_text())
    want = json.loads((tmp_path / "evo.json").read_text())
    # `visited` is a set, listed in the order of each process's salted hash
    assert set(got["state"].pop("visited")) == set(want["state"].pop("visited"))
    assert got == want and len(want["state"]["history"]) >= 4
    for r in range(WORLD):
        assert json.loads((ranks.tmp / f"evo_top{r}.json").read_text()) == \
            json.loads(json.dumps(top))


def test_zero_shot_classifier_on_two_ranks_equals_one_rank(ranks, one_thread):
    """The prompts of each chunk split over 2 ranks (15 rows in chunks of 6
    and 3, padded to even), encoded and gathered: the one-rank classifier
    within 1e-6."""
    clip = CLIP(CLIPConfig(**CLIP_NARROW), device="cpu")
    clip.load_state_dict(seeded_state_dict(clip, 3))
    with torch.no_grad():
        want = build_zero_shot_classifier(clip.encode_text, _tokens, CLASSNAMES, TEMPLATES,
                                          batch_size=2, device="cpu").numpy()
    assert want.shape == (CLIP_NARROW["embed_dim"], len(CLASSNAMES))
    for r in ranks.result()[:WORLD]:
        np.testing.assert_allclose(r["g|classifier"], want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(WORLD, device="cpu")


def test_dryrun_multichip_on_two_cpu_ranks(dryrun):
    """Both checks of the dry run pass on 2 gloo ranks: one data-parallel
    TinyViT-5M step (step 1, finite loss) and the contrastive gradient
    through the gather (finite)."""
    assert dryrun["step"] == 1 and np.isfinite(dryrun["loss"])
    assert np.isfinite(dryrun["grad_norm"]) and np.isfinite(dryrun["contrastive"]["grad"]).all()


def test_dryrun_contrastive_grad_matches_jax_shard_map(dryrun):
    """The dry run's contrastive loss and its gradient through the gloo
    gather against JAX's `clip_contrastive_loss(axis_name="data")` under
    `shard_map` on a 2-device mesh, differentiated through
    `all_gather`: 1e-5."""
    from jax import shard_map

    c = dryrun["contrastive"]
    m2 = create_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    txt = jnp.asarray(c["text"])

    def local(a, b):
        return jax_contrastive(a, b, jnp.float32(c["scale"]), axis_name="data")
    f = shard_map(local, mesh=m2, in_specs=(P("data"), P("data")), out_specs=P())
    loss, grad = jax.jit(jax.value_and_grad(lambda a: f(a, txt)))(jnp.asarray(c["image"]))
    np.testing.assert_allclose(c["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(c["grad"], np.asarray(grad), rtol=0,
                               atol=1e-5 * float(np.abs(grad).max()))


@pytest.mark.parametrize("name", ["dropout", "drop_path", "mixup", "", "données"])
def test_stable_hash_is_jax_bit_for_bit(name):
    assert prng._stable_hash(name) == jax_prng._stable_hash(name)


def test_rng_stream_keys_like_jax():
    """A key is a pure function of (seed, name, indices), as JAX's: two
    streams of one seed give the same draws, and two keys give the same
    draws exactly where JAX's two keys are equal."""
    keys = [("dropout", ()), ("dropout", (0,)), ("dropout", (1,)), ("drop_path", (0,)),
            ("dropout", (0, 1)), ("dropout", (1, 0))]

    def draws(seed, name, idx):
        return torch.rand(4, generator=prng.RngStream(seed).key(name, *idx)).numpy()

    def jax_key(seed, name, idx):
        return tuple(np.asarray(jax.random.key_data(jax_prng.RngStream(seed).key(name, *idx)))
                     .ravel().tolist())

    for a in keys:
        np.testing.assert_array_equal(draws(3, *a), draws(3, *a))
        for b in keys:
            same = bool(np.array_equal(draws(3, *a), draws(3, *b)))
            assert same == (jax_key(3, *a) == jax_key(3, *b)), (a, b)
    assert not np.array_equal(draws(3, *keys[1]), draws(4, *keys[1]))
    gen = prng.seeded_generator([3, prng._stable_hash("dropout"), 1, 0])
    np.testing.assert_array_equal(draws(3, "dropout", (0,)), torch.rand(4, generator=gen))


def test_step_generator_bits_unchanged():
    """step_generator seeds as it did: SeedSequence([seed, step]), 63 bits."""
    s = np.random.SeedSequence([5, 9]).generate_state(2, np.uint32)
    want = torch.rand(3, generator=torch.Generator().manual_seed(
        int(s[0]) << 31 | int(s[1]) >> 1))
    np.testing.assert_array_equal(torch.rand(3, generator=step_generator(5, 9, "cpu")), want)


def test_step_timer_excludes_warmup():
    timer = profiling.StepTimer(warmup=2, device="cpu")
    for _ in range(5):
        with timer:
            sum(range(1000))
    assert len(timer.times) == 3 and timer.mean == pytest.approx(sum(timer.times) / 3)
    assert profiling.StepTimer().mean == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tb")) as prof:
        with torch.profiler.record_function("traced_block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    trace = json.loads((tmp_path / "tb" / "trace-rank0.json").read_text())
    assert any(e.get("name") == "traced_block" for e in trace["traceEvents"])


@pytest.mark.parametrize("world", [1, 2, 3])
def test_steps_per_epoch_counts_the_rank_slice_and_jax_counts_every_rank(world):
    """An epoch's steps are the batches of one rank's slice, on both
    packages' loaders; the JAX CLI counts `len // batch_size` whatever the
    process count, so under W processes its cosine schedule runs W times
    longer than the steps it takes (ROADMAP Queue 3)."""
    n, bs = 40, 4
    got = len(list(train_loader(SyntheticDataset(n=n, img_size=8, num_classes=3), bs, 0,
                                img_size=8, num_workers=1, shard=(world - 1, world))))
    jax_batches = len(list(jax_train_loader(JaxSyntheticDataset(n=n, img_size=8,
                                                                num_classes=3), bs, 0,
                                            img_size=8, num_workers=1,
                                            shard=(world - 1, world))))
    assert steps_per_epoch(n, bs, world) == got == jax_batches == n // world // bs
    src = inspect.getsource(jax_cli_train.main)
    assert "steps_per_epoch = max(len(train_ds) // cfg.data.batch_size, 1)" in src
    assert (max(n // bs, 1) == jax_batches) == (world == 1)


def test_init_distributed_picks_nccl_on_cuda_and_gloo_on_cpu(monkeypatch):
    """torchrun's environment: NCCL on cuda:LOCAL_RANK (set as the current
    card), gloo only for the CPU; a failed NCCL start raises, with no gloo
    in its place; without the environment nothing starts."""
    calls = []
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(mesh.torch.cuda, "set_device", lambda d: calls.append(("set", d)))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_distributed("cuda") is False and calls == []
    for k, v in {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1"}.items():
        monkeypatch.setenv(k, v)
    mesh.init_distributed("cuda")
    assert calls[0] == ("set", torch.device("cuda", 1))
    assert calls[1][0] == "nccl" and calls[1][1]["device_id"] == torch.device("cuda", 1)
    assert (calls[1][1]["rank"], calls[1][1]["world_size"]) == (1, 2)
    mesh.init_distributed("cpu")
    assert calls[2][0] == "gloo"

    def refuse(backend, **kw):
        calls.append(backend)
        raise RuntimeError("no NCCL")
    monkeypatch.setattr(mesh.dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="no NCCL"):
        mesh.init_distributed("cuda")
    assert calls[-1] == "nccl"
    with pytest.raises(ValueError):
        mesh.init_distributed("meta")


def test_one_card_helpers_are_the_identity():
    """Without a group: rank 0 of 1, sums and means untouched, the shard the
    whole order."""
    assert mesh.data_group() is None and (mesh.rank(), mesh.world_size()) == (0, 1)
    t = torch.arange(4.0)
    assert mesh.all_reduce_sum(t) is t and t.tolist() == [0, 1, 2, 3]
    mesh.all_reduce_mean_([t])
    assert t.tolist() == [0, 1, 2, 3]
    np.testing.assert_array_equal(mesh.process_shard(5), np.arange(5))
    np.testing.assert_array_equal(mesh.process_shard(7, 1, 3), [1, 4])
    assert mesh.global_rows(4) == (4, 0, 4)


@pytest.mark.parametrize("sizes,limit,want", [
    ([3, 3, 3], 24, [[3, 3], [3]]), ([10, 1], 8, [[10], [1]]), ([1, 1, 1, 1], 1000, [[1] * 4]),
    ([], 8, [])])
def test_grad_buckets(sizes, limit, want):
    """The all-reduce's buckets: runs of at most `limit` fp32 bytes, a
    larger tensor alone, every tensor once in order."""
    ts = [torch.zeros(s) for s in sizes]
    got = [[t.numel() for t in b] for b in mesh._buckets(ts, limit)]
    assert got == want
