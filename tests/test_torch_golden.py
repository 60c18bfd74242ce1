"""cream_tpu_torch.cli.golden against cream_tpu.cli.golden on the CPU: the
input battery bit for bit, and a dump of the port's model on a released-
layout .pth (written here from seeded weights) against the JAX CLI's dump
of the same file."""
import numpy as np
import pytest
import torch

from cream_tpu.cli import golden as jax_golden
from cream_tpu_torch.cli import golden
from cream_tpu_torch.models import create_model
from cream_tpu_torch.zoo.load import seeded_state_dict

# the narrowest registered classifier the JAX CLI can import (widths 64,
# 128, 192; 2.3 M params)
MODEL, N = "efficientvit_m0", 4


@pytest.mark.parametrize("n,img,seed", [(4, 32, 0), (2, 224, 0), (3, 17, 5)])
def test_battery_is_jax_bit_for_bit(n, img, seed):
    got, want = golden.battery(n, img, seed), jax_golden.battery(n, img, seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, img, img, 3)
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """A .pth of seeded weights in the released layout; the port's CLI dump
    of it (`--dump`) and the JAX CLI's."""
    tmp = tmp_path_factory.mktemp("golden")
    m = create_model(MODEL, device="cpu")
    torch.save(seeded_state_dict(m, 0), tmp / "ckpt.pth")
    common = ["--model", MODEL, "--torch-ckpt", str(tmp / "ckpt.pth"), "--n", str(N)]
    ours = golden.main(common + ["--device", "cpu", "--dump", str(tmp / "ours.npz")])
    jax_golden.main(common + ["--dump", str(tmp / "jax.npz")])
    return tmp, ours


def test_dump_matches_the_jax_cli(dumps):
    """The port's logits on the battery equal the JAX CLI's within 1e-4;
    the file carries the JAX CLI's keys."""
    tmp, ours = dumps
    got, want = np.load(tmp / "ours.npz"), np.load(tmp / "jax.npz")
    assert set(got.files) == set(want.files) == {"logits", "model", "img", "n"}
    assert str(got["model"]) == MODEL and int(got["n"]) == N and int(got["img"]) == 224
    np.testing.assert_array_equal(got["logits"], ours)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=1e-4)


def test_compare_reports_the_jax_cli_figures(dumps, capsys):
    tmp, _ = dumps
    got = golden.main(["--compare", str(tmp / "ours.npz"), str(tmp / "jax.npz")])
    want = jax_golden.compare(str(tmp / "ours.npz"), str(tmp / "jax.npz"))
    assert got == want
    assert got["maxdiff"] <= 1e-4 and got["top1_agree"] == 1.0 and got["top5_overlap"] == 1.0
    assert "top1 agreement = 1.000" in capsys.readouterr().out


def test_compare_fails_on_disagreement(dumps):
    """Flipped top-1 classes fail the comparison; other shapes are refused."""
    tmp, ours = dumps
    flipped = ours.copy()
    flipped[0] = -flipped[0]
    np.savez(tmp / "flipped.npz", logits=flipped)
    with pytest.raises(SystemExit, match="top-1 agreement"):
        golden.compare(str(tmp / "ours.npz"), str(tmp / "flipped.npz"))
    assert golden.compare(str(tmp / "ours.npz"), str(tmp / "flipped.npz"),
                          top1_tol=0.5)["top1_agree"] == pytest.approx(0.75)
    np.savez(tmp / "short.npz", logits=ours[:2])
    with pytest.raises(SystemExit, match="shapes differ"):
        golden.compare(str(tmp / "ours.npz"), str(tmp / "short.npz"))


def test_dump_needs_its_arguments():
    with pytest.raises(SystemExit, match="need --model"):
        golden.main(["--model", MODEL])
    with pytest.raises(SystemExit, match="cells-json"):
        golden.dump_ours("cdarts_retrain_imagenet", "x.pth", "x.npz", 224, 1, device="cpu")
    with pytest.raises(SystemExit, match="subnet-yaml"):
        golden.dump_ours("autoformer_supernet_tiny", "x.pth", "x.npz", 224, 1, device="cpu")
