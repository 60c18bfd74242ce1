"""cream_tpu_torch's train CLI on the CPU: TinyViT-5M on the synthetic set at
a 64-pixel image size (stage 1's 16x16 map takes the padded-window path),
batch 2, so one epoch is 32 steps and takes seconds; and EfficientViT-M0,
the JAX CLI's docstring example, at the same small size.
"""
import pytest
import torch

from cream_tpu_torch.cli import train
from cream_tpu_torch.core.checkpoint import latest_step, restore_checkpoint
from cream_tpu_torch.data.imagenet import SyntheticDataset
from torch_threads import one_torch_thread_module  # noqa: F401

BASE = ["model.name=tiny_vit_5m_224", "model.dtype=float32", "model.img_size=64",
        "data.img_size=64", "data.dataset=synthetic", "data.batch_size=2",
        "data.num_workers=2", "train.warmup_epochs=0"]


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    opts = BASE + [f"output={tmp_path}"]
    ckpt = tmp_path / "tiny_vit_5m_224" / "default" / "ckpt"
    acc = train.main(["--device", "cpu", *opts, "train.epochs=1"])
    assert 0.0 <= acc <= 100.0
    # max(4 * batch, 64) synthetic images: 32 steps of 2
    assert len(SyntheticDataset(64)) // 2 == 32 and latest_step(str(ckpt)) == 32
    out = capsys.readouterr().out
    assert "epoch 0 [0/32]" in out and "epoch 0 done" in out

    # a second run with two epochs resumes after epoch 0, here with
    # one-hot targets (mixup and cutmix off) and an EMA
    train.main(["--device", "cpu", *opts, "train.epochs=2", "aug.mixup=0",
                "aug.cutmix=0", "train.ema_decay=0.9"])
    out = capsys.readouterr().out
    assert "auto-resumed from step 32 (epoch 1)" in out
    assert "epoch 0 [" not in out and "epoch 1 done" in out
    assert latest_step(str(ckpt)) == 64
    _, extra, _ = restore_checkpoint(str(ckpt), {})
    assert extra["epoch"] == 1

    # nothing left to train: a third run resumes and stops
    train.main(["--device", "cpu", *opts, "train.epochs=2"])
    assert "auto-resumed from step 64 (epoch 2)" in capsys.readouterr().out
    assert latest_step(str(ckpt)) == 64


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    opts = ["--device", "cpu", *BASE, f"output={tmp_path}", "train.epochs=1"]
    # image folders are read now (tests/test_torch_image_folder.py); a
    # missing one raises before anything is written
    with pytest.raises(FileNotFoundError):
        train.main([*opts, "data.dataset=imagenet", f"data.data_path={tmp_path / 'absent'}"])
    with pytest.raises(NotImplementedError, match="distill"):
        train.main([*opts, "distill.enabled=true"])
    assert not (tmp_path / "tiny_vit_5m_224").exists()


def test_train_cli_nan_budget(tmp_path, monkeypatch):
    """A non-finite loss counts against train.nan_budget; past it the run
    stops."""
    real = train.soft_target_ce
    monkeypatch.setattr(train, "soft_target_ce",
                        lambda logits, y: real(logits, y) * torch.nan)
    with pytest.raises(FloatingPointError):
        train.main(["--device", "cpu", *BASE, f"output={tmp_path}",
                    "train.epochs=1", "train.nan_budget=2"])


@pytest.mark.parametrize("dw_kernel", [None, "fused"])
def test_train_cli_trains_efficientvit(tmp_path, capsys, dw_kernel):
    """The JAX CLI's example `model.name=efficientvit_m0 data.dataset=synthetic
    train.epochs=1`, at 64 pixels and batch 2: EfficientViT takes no drop
    path rate, so none is passed unless the config sets one."""
    opts = ["--device", "cpu", "model.name=efficientvit_m0", "data.dataset=synthetic",
            "train.epochs=1", "model.dtype=float32", "model.img_size=64", "data.img_size=64",
            "data.batch_size=2", "data.num_workers=2", "train.warmup_epochs=0",
            f"output={tmp_path}"]
    if dw_kernel:
        opts.append(f'model.extra={{"dw_kernel": "{dw_kernel}"}}')
    acc = train.main(opts)
    assert 0.0 <= acc <= 100.0
    assert latest_step(str(tmp_path / "efficientvit_m0" / "default" / "ckpt")) == 32
    assert "epoch 0 done" in capsys.readouterr().out
    with pytest.raises(ValueError, match="drop path"):
        train.main([*opts, "model.drop_path_rate=0.1"])
