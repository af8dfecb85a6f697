"""The port's DIP CLI end to end on the CPU, on a tiny DIV2K-layout tree."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_lpips import npz  # noqa: F401  (fixture)
from tpusr_torch.cli import dip as cli
from tpusr_torch.models.lpips import LPIPS_WEIGHTS_ENV

TINY = ["--num_scales", "3", "--skip_n33d", "16", "--skip_n33u", "16",
        "--input_depth", "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _write_div2k(root, names=("0001", "0002"), hr=128):
    """HR PNGs of hr x hr (or hr = (h, w)) with their x8 LR PNGs."""
    h, w = (hr, hr) if isinstance(hr, int) else hr
    rng = np.random.default_rng(0)
    hr_dir = root / "DIV2K_train_HR"
    lr_dir = root / "DIV2K_train_LR_x8"
    hr_dir.mkdir()
    lr_dir.mkdir()
    yy, xx = np.mgrid[0:h, 0:w]
    for i, name in enumerate(names):
        img = np.stack([np.sin(xx / (5.0 + i)), np.cos(yy / 7.0),
                        np.sin((xx + yy) / 9.0)], -1) * 100 + 128
        img = np.clip(img + rng.normal(0, 3, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(hr_dir / f"{name}.png")
        Image.fromarray(img.astype(np.uint8)).resize(
            (w // 8, h // 8), Image.BICUBIC).save(lr_dir / f"{name}x8.png")


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
                                  ["--input_method", "meshgrid",
                                   "--input_depth", "2"],
                                  ["--opt_over", "net,input,down"],
                                  ["--bucket", "16"],
                                  ["--batch_images", "2", "--bucket", "16"],
                                  ["--profile_dir", "p"]])
def test_cli_refuses_unported_flags(tmp_path, capsys, flag):
    """Each flag the port once refused now runs the CLI: an HR of 112 x 144
    (56 x 72 after the loader's /2, not a multiple of the 16 bucket), the
    tree, PNGs at the image's own size and the log."""
    data, out = tmp_path / "data", tmp_path / "out"
    data.mkdir()
    out.mkdir()
    n = 2 if "--batch_images" in flag else 1
    _write_div2k(data, names=("0001", "0002")[:n], hr=(112, 144))
    flag = [str(tmp_path / "p") if f == "p" else f for f in flag]
    metrics = cli.run(["--data_dir", str(data), "--out_dir", str(out),
                       "--num_iter", "2", "--train_log_freq", "1",
                       "--save_output", "True", "--num_images", str(n),
                       "--device", "cpu", *TINY, *flag])
    printed = capsys.readouterr().out
    assert "Iteration 2/2: PSNR:" in printed
    (stamp,) = os.listdir(out / "out" / "DIPx8")
    run_dir = out / "out" / "DIPx8" / stamp
    for name in ("0001", "0002")[:n]:
        png = Image.open(run_dir / "images" / f"{name}_resolved.png")
        assert png.size == (72, 56)
    (log,) = [f for f in os.listdir(run_dir) if f.endswith("_log.txt")]
    assert "Average final PSNR" in open(run_dir / log).read()
    assert metrics["Number of images evaluated over"] == n
    assert np.isfinite(metrics["Average final PSNR"])
    assert np.all(np.isfinite(metrics["Average PSNR per epoch"]))
    if "--batch_images" in flag:
        assert "Batch of 2 images runtime" in printed
    if "--profile_dir" in flag:
        (trace,) = os.listdir(tmp_path / "p")
        assert os.path.getsize(tmp_path / "p" / trace) > 0


@pytest.mark.parametrize("argv,message", [
    (["--bucket", "12"], "multiple of the scale factor"),
    (["--batch_images", "2"], "requires --bucket")])
def test_cli_rejects_bad_bucket_flags(tmp_path, capsys, argv, message):
    with pytest.raises(SystemExit) as exc:
        cli.run(["--data_dir", str(tmp_path), "--out_dir", str(tmp_path),
                 "--device", "cpu", *argv])
    assert exc.value.code == 1
    assert message in capsys.readouterr().out


def test_cli_logs_the_lpips_curve_with_weights(tmp_path, npz, monkeypatch):
    """With LPIPS weights the per-epoch LPIPS curve is numbers, not NaN."""
    monkeypatch.setenv(LPIPS_WEIGHTS_ENV, npz)
    data, out = tmp_path / "data", tmp_path / "out"
    data.mkdir()
    out.mkdir()
    _write_div2k(data, names=("0001",))
    metrics = cli.run(["--data_dir", str(data), "--out_dir", str(out),
                       "--num_iter", "4", "--train_log_freq", "2",
                       "--device", "cpu", *TINY])
    assert np.all(np.isfinite(metrics["Average LPIPS per epoch"]))
    assert np.isfinite(metrics["Average final LPIPS"])


def test_cli_main_needs_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without one")
    _write_div2k(tmp_path, names=("0001",))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(str(tmp_path / "DIV2K_train_LR_x8"),
                 str(tmp_path / "DIV2K_train_HR"), str(tmp_path), 8, 1,
                 cli.DIPConfig(num_iter=1), False, None, False)


def test_profiling_helpers(tmp_path):
    """maybe_trace writes a trace only when given a directory; a span
    opened while it records is on."""
    from tpusr_torch.utils import profiling

    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(str(tmp_path / "t")):
        with profiling.span("test.unit") as rec:
            torch.ones(4).sum()
    assert len(os.listdir(tmp_path / "t")) == 1
    assert rec.name == "test.unit" and rec.profiled
