"""The port's SRGAN eval CLI against tpusr's, end to end on the CPU.

A tiny DIV2K valid tree (a square image and a ragged one) and a 2-block
x8 generator .pth from tpusr's export go through both CLIs. The metrics
agree within 1e-4 (the generators agree within 1e-5 per pixel,
tests/test_torch_srgan.py); the LR noise is the host's numpy stream in
both packages, so the noisy runs agree too.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_srgan import random_variables
from tpusr.cli import eval_gan as jax_cli
from tpusr.io import checkpoint as jck
from tpusr_torch.cli import eval_gan as cli


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("div2k")
    hr_dir, lr_dir = root / "DIV2K_valid_HR", root / "DIV2K_valid_LR_x8"
    hr_dir.mkdir()
    lr_dir.mkdir()
    rng = np.random.default_rng(0)
    for name, (h, w) in (("0801", (256, 320)), ("0802", (200, 136))):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([np.sin(xx / 9.0), np.cos(yy / 7.0),
                        np.sin((xx + yy) / 13.0)], -1) * 100 + 128
        img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(
            np.uint8)
        Image.fromarray(img).save(hr_dir / f"{name}.png")
        Image.fromarray(img).resize((w // 8, h // 8), Image.BICUBIC).save(
            lr_dir / f"{name}x8.png")
    params, stats = random_variables(8, 2, seed=6)
    pth = str(root / "G.pth")
    jck.save_torch_pth(jck.export_torch_generator(params, stats, 2, 3), pth)
    return root, pth


def _run(run, root, pth, out, extra=()):
    out.mkdir()
    metrics = run(["--data_dir", str(root), "--out_dir", str(out),
                   "--model_path", pth, "--residual_blocks", "2",
                   "--save_images", "True", *extra])
    (stamp,) = os.listdir(out / "out" / "GANx8")
    return metrics, out / "out" / "GANx8" / stamp


@pytest.mark.parametrize("noise", [
    (), ("--noise_type", "gauss", "--noise_param", "0.05"),
    ("--noise_type", "saltpepper", "--noise_param", "0.05")])
def test_cli_agrees_with_tpusr(tree, tmp_path, noise):
    root, pth = tree
    want, jax_dir = _run(jax_cli.run, root, pth, tmp_path / "jax", noise)
    got, run_dir = _run(cli.run, root, pth, tmp_path / "port",
                        ("--device", "cpu", *noise))
    assert got["Number of images evaluated over"] == 2
    for k in ("avg_psnr", "avg_ssim"):
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    assert np.isnan(got["avg_lpips"])
    pngs = sorted(os.listdir(run_dir / "images"))
    assert pngs == sorted(os.listdir(jax_dir / "images")) == [
        "0801.png", "0802.png"]
    assert Image.open(run_dir / "images" / "0802.png").size == (64, 96)
    (log,) = [f for f in os.listdir(run_dir) if f.endswith("_log.txt")]
    keys = [line.split(":")[0] for line in open(run_dir / log)]
    assert keys[:5] == ["avg_psnr", "avg_ssim", "avg_lpips",
                        "Number of images evaluated over", "Eval runtime"]


@pytest.mark.parametrize("flag", ["--tiles", "--spatial_shards"])
def test_cli_refuses_unported_flags(tree, tmp_path, flag):
    """--tiles 3 (exact overlap-and-discard tiling, one process) and
    --spatial_shards 2 (two row slabs with halo exchange; launched plainly
    on the CPU the CLI spawns its two gloo ranks, rank 0 writes) write
    the PNGs a plain run writes. The shards' image is tall enough for
    their edge-exact geometry: an 80-row LR in slabs of 40 = 2 halo (a
    shorter one falls back to zero-filled edge halos, with a warning, as
    in tpusr)."""
    root, pth = tree
    names = ("0801.png", "0802.png")
    if flag == "--spatial_shards":
        root = tmp_path / "tall"
        for d in ("HR", "LR_x8"):
            (root / f"DIV2K_valid_{d}").mkdir(parents=True)
        img = np.random.default_rng(1).integers(0, 256, (1280, 64, 3),
                                                dtype=np.uint8)
        Image.fromarray(img).save(root / "DIV2K_valid_HR" / "0901.png")
        Image.fromarray(img).resize((8, 160), Image.BICUBIC).save(
            root / "DIV2K_valid_LR_x8" / "0901x8.png")
        names = ("0901.png",)
    _, plain = _run(cli.run, root, pth, tmp_path / "plain",
                    ("--device", "cpu"))
    got, split = _run(cli.run, root, pth, tmp_path / "split",
                      ("--device", "cpu", flag, "3" if flag == "--tiles"
                       else "2"))
    if flag == "--spatial_shards":
        assert got is None  # the spawned ranks ran the evaluation
        assert any(f.endswith("_log.txt") for f in os.listdir(split))
    else:
        assert got["Number of images evaluated over"] == 2
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(split / "images" / name)),
            np.asarray(Image.open(plain / "images" / name)))


def test_cli_needs_a_card_for_cuda(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without one")
    root, pth = tree
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run(["--data_dir", str(root), "--out_dir", str(tmp_path),
                 "--model_path", pth, "--residual_blocks", "2"])


@pytest.mark.parametrize("train,legacy_scale", [(False, False),
                                                (True, False), (True, True)])
def test_gan_dataset_matches_tpusr(tree, train, legacy_scale):
    """The same (seed, epoch, index) numpy streams: identical pairs,
    patches and noise."""
    from tpusr.data.div2k import GANDIV2KDataset as JaxDataset
    from tpusr_torch.data.div2k import GANDIV2KDataset

    root, _ = tree
    kw = dict(LR_dir=str(root / "DIV2K_valid_LR_x8"),
              HR_dir=str(root / "DIV2K_valid_HR"), scale_factor=8,
              noise_type={"type": "Gaussian", "std": 0.05},
              LR_patch_size=(6, 4), train=train, seed=3,
              legacy_scale=legacy_scale)
    ours, theirs = GANDIV2KDataset(**kw), JaxDataset(**kw)
    ours.set_epoch(2)
    theirs.set_epoch(2)
    for idx in range(len(ours)):
        for a, b in zip(ours[idx], theirs[idx]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.base_pair(idx), theirs.base_pair(idx)):
            np.testing.assert_array_equal(a, b)
    if train:
        lr, hr, _ = ours[0]
        assert lr.shape == (4, 6, 3) and hr.shape == (32, 48, 3)
