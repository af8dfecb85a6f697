"""tpusr_torch's SRGAN training CLI on the CPU, held to tpusr's.

A tiny DIV2K train tree (four 256^2 HR images and their x8 LRs); the
tiny-model flags (--residual_blocks 2 --hr_patch_size 64 --batch_size 2);
``--device cpu``. Checked: tpusr's output file set and log keys with finite
losses, on both trainers; --resume restoring the step; a
--pre_trained_models_path pair that tpusr's exporters wrote; the parser's
flags and defaults against tpusr's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpusr.cli import train_gan as jax_cli
from tpusr.io.checkpoint import (export_torch_discriminator as jax_export_d,
                                 export_torch_generator as jax_export_g,
                                 save_torch_pth as jax_save_pth)
from tpusr.models.srgan import Discriminator as JaxD
from tpusr.models.srgan import Generator as JaxG
from tpusr_torch.cli import eval_gan, train_gan
from tpusr_torch.engine.gan import GANTrainConfig, create_gan_state
from tpusr_torch.io.checkpoint import load_train_state
from tpusr_torch.io.weights import load_flax_discriminator, load_flax_generator

TINY = ["--residual_blocks", "2", "--hr_patch_size", "64", "--batch_size",
        "2", "--device", "cpu"]
LOG_KEYS = ["Average PSNR during training", "Average SSIM during training",
            "Average LPIPS during training", "Final Generator loss",
            "Final Discriminator loss", "Number of images used for training",
            "Train runtime"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("div2k")
    rng = np.random.default_rng(0)
    hr_dir, lr_dir = root / "DIV2K_train_HR", root / "DIV2K_train_LR_x8"
    hr_dir.mkdir()
    lr_dir.mkdir()
    for i in range(1, 5):
        hr = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
        Image.fromarray(hr).save(hr_dir / f"{i:04d}.png")
        Image.fromarray(hr).resize((32, 32), Image.BICUBIC).save(
            lr_dir / f"{i:04d}x8.png")
    valid = root / "DIV2K_valid_HR"
    valid.mkdir()
    (root / "DIV2K_valid_LR_x8").mkdir()
    for d in ("HR", "LR_x8"):
        src = hr_dir if d == "HR" else lr_dir
        name = "0001.png" if d == "HR" else "0001x8.png"
        Image.open(src / name).save(root / f"DIV2K_valid_{d}" / name)
    return str(root)


def _run(tree, out, *extra):
    os.makedirs(out, exist_ok=True)
    return train_gan.run(["--data_dir", tree, "--out_dir", str(out),
                          "--pre_train_epochs", "1", "--fine_tune_epochs",
                          "1", "--train_log_freq", "1", *TINY, *extra])


def _log(out_dir):
    """The last phase's log: the one with the run's totals."""
    logs = [dict(line.split(": ", 1) for line in open(
        os.path.join(out_dir, f)).read().splitlines())
        for f in os.listdir(out_dir) if f.endswith("_log.txt")]
    return max(logs, key=len)


@pytest.mark.parametrize("host_loop", ["False", "True"])
def test_cli_writes_tpusr_file_set(tree, tmp_path, host_loop):
    out_dir = _run(tree, tmp_path / "out", "--host_loop", host_loop)
    assert out_dir.startswith(str(tmp_path / "out" / "trained" / "GANx8"))
    files = set(os.listdir(out_dir))
    for prefix in ("pre_trained", "fine_tuned"):
        assert {f"{prefix}_state", f"{prefix}_srgan_G.pth",
                f"{prefix}_srgan_D.pth"} <= files
    assert len([f for f in files if f.endswith("_log.txt")]) == 2
    log = _log(out_dir)
    assert list(log) == LOG_KEYS
    for key in ("Final Generator loss", "Final Discriminator loss"):
        assert np.isfinite(float(log[key]))
    assert np.isfinite(eval(log["Average PSNR during training"])[0])
    # the generator .pth serves the eval CLI
    metrics = eval_gan.run([
        "--data_dir", tree, "--out_dir", str(tmp_path), "--model_path",
        os.path.join(out_dir, "pre_trained_srgan_G.pth"),
        "--residual_blocks", "2", "--device", "cpu"])
    assert np.isfinite(metrics["avg_psnr"])


def test_resume_restores_the_step(tree, tmp_path, capsys):
    out_dir = _run(tree, tmp_path / "a", "--checkpoint_every", "1")
    ckpt = os.path.join(out_dir, "ckpt_epoch1")
    cfg = GANTrainConfig(hr_patch=64, batch_size=2, residual_blocks_count=2)
    state = load_train_state(ckpt, create_gan_state(cfg, 1e-4, device="cpu"))
    assert state.step == 2  # 4 images / batch 2, one epoch
    capsys.readouterr()
    _run(tree, tmp_path / "b", "--resume", ckpt)
    assert "at step 2" in capsys.readouterr().out


def test_pretrained_pair_from_tpusr(tree, tmp_path):
    """tpusr's exported .pth pair starts the fine-tune phase with its
    weights and statistics."""
    kg, kd = jax.random.split(jax.random.key(3))
    vg = jax.jit(JaxG(factor=8, residual_blocks_count=2).init)(
        kg, jnp.zeros((1, 8, 8, 3)))
    vd = jax.jit(JaxD().init)(kd, jnp.zeros((1, 64, 64, 3)))
    pre = tmp_path / "pre"
    jax_save_pth(jax_export_g(vg["params"], vg["batch_stats"], 2, 3),
                 str(pre / "pre_trained_srgan_G.pth"))
    jax_save_pth(jax_export_d(vd["params"], vd["batch_stats"], hr_patch=64),
                 str(pre / "pre_trained_srgan_D.pth"))
    cfg = GANTrainConfig(hr_patch=64, batch_size=2, residual_blocks_count=2)
    state = train_gan.load_pretrained(
        str(pre), create_gan_state(cfg, 1e-4, device="cpu"), cfg)
    want = create_gan_state(cfg, 1e-4, device="cpu")
    load_flax_generator(want.G, vg["params"], vg["batch_stats"])
    load_flax_discriminator(want.D, vd["params"], vd["batch_stats"])
    for net in ("G", "D"):
        got_sd = getattr(state, net).state_dict()
        for k, v in getattr(want, net).state_dict().items():
            torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0, msg=k)
    out_dir = _run(tree, tmp_path / "out", "--pre_trained_models_path",
                   str(pre))
    assert not os.path.exists(os.path.join(out_dir, "pre_trained_state"))
    assert np.isfinite(float(_log(out_dir)["Final Generator loss"]))


def test_orbax_directories_are_refused(tmp_path):
    """Only a directory that is not an orbax checkpoint (no _METADATA), or
    a zarr3 one, is refused, with its reason; tpusr's and the port's orbax
    directories resume (tests/test_torch_orbax.py)."""
    cfg = GANTrainConfig(hr_patch=64, batch_size=2, residual_blocks_count=2)
    state = create_gan_state(cfg, 1e-4, device="cpu")
    (tmp_path / "pre_trained_state").mkdir()
    with pytest.raises(ValueError, match="no _METADATA"):
        train_gan.load_pretrained(str(tmp_path), state, cfg)
    with pytest.raises(ValueError, match="no _METADATA"):
        load_train_state(str(tmp_path / "pre_trained_state"), state)
    (tmp_path / "pre_trained_state" / "_METADATA").write_text(
        '{"tree_metadata": {}, "use_ocdbt": false, "use_zarr3": true}')
    with pytest.raises(ValueError, match="zarr3"):
        train_gan.load_pretrained(str(tmp_path), state, cfg)
    with pytest.raises(FileNotFoundError, match="neither"):
        train_gan.load_pretrained(str(tmp_path / "none"), state, cfg)


def test_data_parallel_is_not_ported(tree, tmp_path, capsys):
    """--data_parallel True, launched plainly on the CPU: one rank (the
    one-rank group make_mesh sets up), the whole training and tpusr's file
    set; two ranks run in tests/test_torch_parallel.py."""
    import torch.distributed as dist

    try:
        out_dir = _run(tree, tmp_path / "out", "--data_parallel", "True")
        assert "Data-parallel over 1 devices" in capsys.readouterr().out
        files = set(os.listdir(out_dir))
        assert {"pre_trained_state", "fine_tuned_srgan_G.pth",
                "fine_tuned_srgan_D.pth"} <= files
        assert np.isfinite(float(_log(out_dir)["Final Generator loss"]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_parser_matches_tpusr():
    def flags(parser):
        return {a.dest: (a.default, a.type, a.choices, a.required)
                for a in parser._actions if a.dest != "help"}

    ours, theirs = flags(train_gan.build_parser()), flags(
        jax_cli.build_parser())
    assert ours.pop("device") == ("cuda", str, None, False)
    assert ours.keys() == theirs.keys()
    for k, (default, typ, choices, required) in theirs.items():
        o = ours[k]
        assert (o[0], o[2], o[3]) == (default, choices, required), k
        assert getattr(o[1], "__name__", o[1]) == getattr(typ, "__name__",
                                                          typ), k
