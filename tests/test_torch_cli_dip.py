"""The port's DIP CLI end to end on the CPU, on a tiny DIV2K-layout tree."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from tpusr_torch.cli import dip as cli

TINY = ["--num_scales", "3", "--skip_n33d", "16", "--skip_n33u", "16",
        "--input_depth", "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _write_div2k(root, names=("0001", "0002"), hr=128):
    rng = np.random.default_rng(0)
    hr_dir = root / "DIV2K_train_HR"
    lr_dir = root / "DIV2K_train_LR_x8"
    hr_dir.mkdir()
    lr_dir.mkdir()
    yy, xx = np.mgrid[0:hr, 0:hr]
    for i, name in enumerate(names):
        img = np.stack([np.sin(xx / (5.0 + i)), np.cos(yy / 7.0),
                        np.sin((xx + yy) / 9.0)], -1) * 100 + 128
        img = np.clip(img + rng.normal(0, 3, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(hr_dir / f"{name}.png")
        Image.fromarray(img.astype(np.uint8)).resize(
            (hr // 8, hr // 8), Image.BICUBIC).save(lr_dir / f"{name}x8.png")


def test_cli_writes_tree_pngs_and_log(tmp_path, capsys):
    data, out = tmp_path / "data", tmp_path / "out"
    data.mkdir()
    out.mkdir()
    _write_div2k(data)
    metrics = cli.run(["--data_dir", str(data), "--out_dir", str(out),
                       "--num_iter", "4", "--train_log_freq", "2",
                       "--save_output", "True", "--num_images", "2",
                       "--noise_type", "gauss", "--noise_param", "0.05",
                       "--device", "cpu", *TINY])
    printed = capsys.readouterr().out
    assert "Iteration 3/4: PSNR:" in printed

    (stamp,) = os.listdir(out / "out" / "DIPx8")
    run_dir = out / "out" / "DIPx8" / stamp / "Gaussian" / "0.05"
    pngs = sorted(os.listdir(run_dir / "images"))
    assert pngs == sorted(f"{n}_{k}.png" for n in ("0001", "0002")
                          for k in ("resolved", "LR", "HR"))
    assert Image.open(run_dir / "images" / "0001_resolved.png").size == (64, 64)
    (log,) = [f for f in os.listdir(run_dir) if f.endswith("_log.txt")]
    keys = [line.split(":")[0] for line in open(run_dir / log)]
    assert keys == ["Average PSNR per epoch", "Average SSIM per epoch",
                    "Average LPIPS per epoch", "runtime",
                    "Average final PSNR", "Average final SSIM",
                    "Average final LPIPS", "Number of images evaluated over",
                    "type", "std"]
    assert metrics["Number of images evaluated over"] == 2
    assert np.isfinite(metrics["Average final PSNR"])
    assert np.isnan(metrics["Average final LPIPS"])
    assert metrics["Average PSNR per epoch"].shape == (2,)


@pytest.mark.parametrize("flag", [["--optimizer", "lbfgs"],
                                  ["--input_method", "meshgrid"],
                                  ["--opt_over", "net,down"],
                                  ["--bucket", "64"],
                                  ["--batch_images", "2"],
                                  ["--profile_dir", "p"]])
def test_cli_refuses_unported_flags(tmp_path, capsys, flag):
    with pytest.raises(SystemExit) as exc:
        cli.run(["--data_dir", str(tmp_path), "--out_dir", str(tmp_path),
                 "--device", "cpu", *flag])
    assert exc.value.code == 1
    assert "not yet ported" in capsys.readouterr().out


def test_cli_main_needs_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without one")
    _write_div2k(tmp_path, names=("0001",))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(str(tmp_path / "DIV2K_train_LR_x8"),
                 str(tmp_path / "DIV2K_train_HR"), str(tmp_path), 8, 1,
                 cli.DIPConfig(num_iter=1), False, None, False)
