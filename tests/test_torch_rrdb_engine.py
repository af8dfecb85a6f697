"""ESRGAN's RRDBNet on the port's eval path, on the CPU.

``GANTrainConfig(generator='rrdb')`` -> ``build_generator`` ->
``generator_forward(train=False)`` against the benchmark's plain reference
(``srbench/reference/rrdb.py``) on seeded weights at the published widths
(nf 64, gc 32) with two RRDBs, x4, LR 12 x 20; the weights go in through
``import_esrgan_rrdbnet`` from ESRGAN's names and from BasicSR's; the
published parameter count; the ``rrdb.*`` spans; what RRDB refuses (a
training forward, the spatial paths); and the eval CLI with ``--generator
rrdb`` on a tiny DIV2K x4 tree.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from srbench.reference import rrdb as reference
from tpusr_torch.cli import eval_gan as cli
from tpusr_torch.engine import gan
from tpusr_torch.io import checkpoint
from tpusr_torch.parallel import spatial
from tpusr_torch.utils.profiling import observe

NB = 2
CFG = {"in_nc": 3, "out_nc": 3, "nf": 64, "nb": NB, "gc": 32, "scale": 4}
# bf16 rounds every stored activation to 8 significant bits: over six dense
# blocks and the HR convs the output moves by 0.7-1.0 % of its largest
# value (five seeds); fp8-e4m3 operands (4 bits) move it by 8.6-11.5 %
BF16_MAX_GAP = 0.03  # of max |reference|


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    return reference.make_weights(CFG, 7, "cpu")


@pytest.fixture(scope="module")
def lr():
    return torch.rand((1, 12, 20, 3),
                      generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def want(weights, lr):
    return reference.forward(weights, lr, CFG)


def _config(**kw):
    return gan.GANTrainConfig(**{"generator": "rrdb", "factor": 4,
                                 "rrdb_blocks": NB, **kw})


def _program(sd, **kw):
    config = _config(**kw)
    net = gan.build_generator(config, "cpu")
    net.load_state_dict(checkpoint.import_esrgan_rrdbnet(sd, NB),
                        strict=True)
    return net, config


def _forward(net, lr, config):
    with torch.inference_mode():
        return gan.generator_forward(net, lr, config, train=False)


def _basicsr(sd):
    """ESRGAN's names -> BasicSR / Real-ESRGAN's."""
    out = {}
    for k, v in sd.items():
        for old, new in (("RRDB_trunk.", "body."), (".RDB", ".rdb"),
                         ("trunk_conv", "conv_body"), ("upconv", "conv_up"),
                         ("HRconv", "conv_hr")):
            k = k.replace(old, new)
        out[k] = v
    return out


@pytest.mark.parametrize("dtype,fusion,limit", [
    # f32 on the CPU: the plain kernels and F.conv2d differ from the
    # reference only in summation order
    ("float32", "auto", 1e-5), ("float32", "off", 1e-5),
    ("bfloat16", "auto", None)])
def test_the_engine_matches_the_reference(weights, lr, want, dtype, fusion,
                                          limit):
    net, config = _program(weights, dtype=dtype, conv_fusion=fusion)
    got = _forward(net, lr, config)
    assert got.shape == (1, 48, 80, 3) and got.dtype == torch.float32
    gap = float((got - want).abs().max())
    if limit is None:
        limit = BF16_MAX_GAP * float(want.abs().max())
        control = reference.forward(weights, lr, CFG, low="fp8")
        assert float((control - want).abs().max()) > limit
    assert gap <= limit, gap


@pytest.mark.parametrize("names", ["esrgan", "basicsr"])
@pytest.mark.parametrize("wrap", [None, "params_ema", "params"])
def test_the_importer_takes_the_published_names(weights, lr, want, names,
                                                wrap):
    sd = weights if names == "esrgan" else _basicsr(weights)
    if wrap is not None:
        sd = {wrap: sd}
    assert checkpoint.infer_rrdb_arch(sd) == (NB, 2)
    net, config = _program(sd)
    assert float((_forward(net, lr, config) - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("names", ["esrgan", "basicsr"])
@pytest.mark.parametrize("case", ["missing", "extra"])
def test_the_importer_names_a_missing_or_extra_key(weights, names, case):
    sd = dict(weights if names == "esrgan" else _basicsr(weights))
    key = "conv_last.bias" if case == "missing" else "conv_last.scale"
    if case == "missing":
        del sd[key]
    else:
        sd[key] = torch.ones(3)
    with pytest.raises(KeyError, match=key):
        checkpoint.import_esrgan_rrdbnet(sd, NB)


def test_an_srgan_state_dict_is_no_rrdbnet():
    with pytest.raises(ValueError, match="not an RRDBNet"):
        checkpoint.infer_rrdb_arch({"conv1.weight": torch.zeros(1)})


def test_the_published_parameter_count():
    """ESRGAN's RRDBNet(3, 3, 64, 23, gc=32), x4: 16,697,987 parameters in
    the reference and in the port built through the engine."""
    full = {**CFG, "nb": 23}
    assert reference.parameter_count(full) == 16_697_987
    net = gan.build_generator(_config(rrdb_blocks=23), "cpu")
    assert sum(p.numel() for p in net.parameters()) == 16_697_987


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                     marks=pytest.mark.cuda)])
def test_the_rrdb_spans_nest_in_the_forward(weights, lr, dev):
    """rrdb.trunk and rrdb.upsample on every device; rrdb.pack on a card,
    the only device where the forward packs kernel C's units."""
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the units are packed only there")
    config = _config(dtype="bfloat16")
    net = gan.build_generator(config, dev)
    net.load_state_dict(checkpoint.import_esrgan_rrdbnet(weights, NB),
                        strict=True)
    kept = []
    handle = observe(None, kept.append)
    try:
        _forward(net, lr.to(dev), config)
    finally:
        handle.remove()
    by_name = {r.name: r for r in kept}
    packs = ["rrdb.pack"] if dev == "cuda" else []
    assert [r.name for r in kept] == packs + ["rrdb.trunk", "rrdb.upsample",
                                              "gan.generator_forward"]
    top = by_name["gan.generator_forward"]
    assert all(r.parent == top.id and r.call == top.id for r in kept[:-1])
    if packs:
        assert by_name["rrdb.pack"].fields == {"blocks": 3 * NB,
                                               "bytes": 3 * NB * 239_616 * 2}
    assert by_name["rrdb.trunk"].fields == {"blocks": NB}
    assert by_name["rrdb.upsample"].fields == {"octaves": 2}


def test_rrdb_does_not_train(weights, lr):
    net, config = _program(weights)
    with pytest.raises(ValueError, match="eval only"):
        gan.generator_forward(net, lr, config, train=True)
    with pytest.raises(ValueError, match="only 'srgan' trains"):
        gan.create_gan_state(config, 1e-4, device="cpu")


@pytest.mark.parametrize("forward", ["tiled", "sharded"])
def test_the_spatial_paths_take_srgan_alone(weights, lr, forward):
    net, config = _program(weights)
    fn = {"tiled": spatial.tiled_generator_forward,
          "sharded": spatial.sharded_generator_forward}[forward]
    with pytest.raises(ValueError, match="SRGAN generator only"):
        fn(net, lr, config)


@pytest.fixture(scope="module")
def tree(tmp_path_factory, weights):
    """A DIV2K valid tree with the x4 LR set, and an ESRGAN-named .pth."""
    root = tmp_path_factory.mktemp("div2k_x4")
    hr_dir, lr_dir = root / "DIV2K_valid_HR", root / "DIV2K_valid_LR_x4"
    hr_dir.mkdir()
    lr_dir.mkdir()
    rng = np.random.default_rng(0)
    for name, (h, w) in (("0801", (96, 128)), ("0802", (80, 64))):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([np.sin(xx / 9.0), np.cos(yy / 7.0),
                        np.sin((xx + yy) / 13.0)], -1) * 100 + 128
        img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(
            np.uint8)
        Image.fromarray(img).save(hr_dir / f"{name}.png")
        Image.fromarray(img).resize((w // 4, h // 4), Image.BICUBIC).save(
            lr_dir / f"{name}x4.png")
    pth = str(root / "RRDB_ESRGAN_x4.pth")
    checkpoint.save_torch_pth(weights, pth)
    return root, pth


def test_the_eval_cli_runs_rrdb(tree, tmp_path):
    root, pth = tree
    out = tmp_path / "out"
    out.mkdir()
    metrics = cli.run(["--data_dir", str(root), "--out_dir", str(out),
                       "--model_path", pth, "--generator", "rrdb",
                       "--factor", "4", "--save_images", "True",
                       "--device", "cpu"])
    assert metrics["Number of images evaluated over"] == 2
    assert np.isfinite(metrics["avg_psnr"])
    assert np.isfinite(metrics["avg_ssim"])
    (stamp,) = os.listdir(out / "out" / "GANx4")
    run_dir = out / "out" / "GANx4" / stamp
    assert sorted(os.listdir(run_dir / "images")) == ["0801.png",
                                                      "0802.png"]
    # the LR is shrunk by 2 on load, as the reference's pipeline does
    assert Image.open(run_dir / "images" / "0801.png").size == (64, 48)
    (log,) = [f for f in os.listdir(run_dir) if f.endswith("_log.txt")]
    line = next(x for x in open(run_dir / log) if x.startswith("avg_psnr"))
    assert np.isfinite(float(line.split(":")[1]))


@pytest.mark.parametrize("flag", ["--tiles", "--spatial_shards"])
def test_the_eval_cli_refuses_rrdb_tiles(tree, tmp_path, flag):
    root, pth = tree
    with pytest.raises(SystemExit):
        cli.run(["--data_dir", str(root), "--out_dir", str(tmp_path),
                 "--model_path", pth, "--generator", "rrdb", "--factor",
                 "4", flag, "2", "--device", "cpu"])
