"""SwinIR on the port's eval path, on the CPU.

``GANTrainConfig(generator='swinir')`` -> ``build_generator`` ->
``generator_forward(train=False)`` against the benchmark's plain reference
(``srbench/reference/swinir.py``) on seeded weights at a small size that
keeps the head dimension of 30: embed 60, 2 heads, depths [2, 2], window
8, LR 20 x 28 (reflect-padded to 24 x 32, so the last window row is half
padding and the shifted layers' masks cut windows); the window kernel's
plain twin against the reference's attention; the importer from the
published names (bare, ``params``, ``params_ema``, with the buffers a
published file carries); the tail RRDBNet and SwinIR share; the
reference's faults; the ``swinir.*`` spans; what SwinIR refuses; and the
eval CLI with ``--generator swinir``.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from srbench.reference import swinir as reference
from tpusr_torch.cli import eval_gan as cli
from tpusr_torch.engine import gan
from tpusr_torch.io import checkpoint
from tpusr_torch.models import layers, rrdb, swinir
from tpusr_torch.models.rrdb import RRDBNet
from tpusr_torch.models.srgan import Generator
from tpusr_torch.ops import window_attention as wa
from tpusr_torch.parallel import spatial
from tpusr_torch.utils.profiling import observe

CFG = {"in_chans": 3, "embed_dim": 60, "depths": [2, 2], "num_heads": [2, 2],
       "window_size": 8, "mlp_ratio": 2.0, "upscale": 4, "num_feat": 64,
       "img_range": 1.0, "img_size": 64,
       "rgb_mean": [0.4488, 0.4371, 0.4040]}
ARCH = {"embed_dim": 60, "depths": (2, 2), "num_heads": (2, 2)}
F32_LIMIT = 1e-5  # of max |reference|: f32 summation order alone
# bf16 rounds every stored activation and operand to 8 significant bits:
# over four Swin layers and the HR convs the output moves by ~0.1 % of its
# largest value (0.099 % here); fp8-e4m3 operands (the control) by ~1 %
BF16_LIMIT = 3e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    return reference.make_weights(CFG, 7, "cpu")


@pytest.fixture(scope="module")
def lr():
    return torch.rand((1, 20, 28, 3),
                      generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def want(weights, lr):
    return reference.forward(weights, lr, CFG)


def _config(**kw):
    return gan.GANTrainConfig(**{"generator": "swinir", "factor": 4, **kw})


def _program(sd, **kw):
    config = _config(**kw)
    net = gan.build_generator(config, "cpu", **ARCH)
    net.load_state_dict(checkpoint.import_swinir(sd), strict=True)
    return net, config


def _forward(net, lr, config):
    with torch.inference_mode():
        return gan.generator_forward(net, lr, config, train=False)


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype,fusion,limit", [
    ("float32", "auto", F32_LIMIT), ("float32", "off", F32_LIMIT),
    ("bfloat16", "auto", BF16_LIMIT), ("bfloat16", "off", BF16_LIMIT)])
def test_the_engine_matches_the_reference(weights, lr, want, dtype, fusion,
                                          limit):
    net, config = _program(weights, dtype=dtype, conv_fusion=fusion)
    got = _forward(net, lr, config)
    assert got.shape == (1, 80, 112, 3) and got.dtype == torch.float32
    assert _gap(got, want) <= limit, _gap(got, want)
    if dtype == "bfloat16":  # the control is outside the limit
        control = reference.forward(weights, lr, CFG, low="fp8")
        assert _gap(control, want) > limit


@pytest.mark.parametrize("shift", [0, 4])
def test_the_plain_twin_matches_the_references_attention(shift):
    """The window kernel's plain twin on (B, H*W, 3C) qkv in image order
    against the reference's WindowAttention on its own rolled windows
    (qkv a random Linear, proj the identity)."""
    g = torch.Generator().manual_seed(5)
    b, (h, w), c, heads, ws = 2, (16, 24), 60, 2, 8
    x = torch.randn((b, h * w, c), generator=g)
    p = {"t.attn.qkv.weight": torch.randn((3 * c, c), generator=g) / 8,
         "t.attn.qkv.bias": torch.randn(3 * c, generator=g),
         "t.attn.proj.weight": torch.eye(c), "t.attn.proj.bias":
             torch.zeros(c),
         "t.attn.relative_position_bias_table":
             torch.randn(((2 * ws - 1) ** 2, heads), generator=g)}
    got = wa.window_attention(
        F.linear(x, p["t.attn.qkv.weight"], p["t.attn.qkv.bias"]),
        p["t.attn.relative_position_bias_table"], (h, w), heads, shift)
    img = torch.roll(x.view(b, h, w, c), (-shift, -shift), (1, 2))
    windows = reference.window_partition(img, ws).view(-1, ws * ws, c)
    mask = reference.calculate_mask((h, w), ws, shift) if shift else None
    out = reference._attention(p, "t", windows, heads, ws, mask, True,
                               reference._Ops(None))
    out = reference.window_reverse(out.view(-1, ws, ws, c), ws, h, w)
    out = torch.roll(out, (shift, shift), (1, 2)).reshape(b, h * w, c)
    assert _gap(got, out) <= F32_LIMIT


@pytest.mark.parametrize("wrap", [None, "params_ema", "params"])
def test_the_importer_takes_the_published_names(weights, lr, want, wrap):
    sd = reference.published_state_dict(weights, CFG)
    assert sum(k.endswith("attn_mask") for k in sd) == 2  # shifted layers
    assert sum(k.endswith("relative_position_index") for k in sd) == 4
    if wrap is not None:
        sd = {wrap: sd}
    assert checkpoint.infer_swinir_arch(sd) == {
        "upscale": 4, "in_chans": 3, "embed_dim": 60, "depths": (2, 2),
        "num_heads": (2, 2), "mlp_ratio": 2.0, "num_feat": 64}
    net, config = _program(sd)
    assert _gap(_forward(net, lr, config), want) <= F32_LIMIT


@pytest.mark.parametrize("buffer", ["relative_position_index", "attn_mask"])
def test_the_importer_holds_the_buffers_to_their_recomputation(weights,
                                                               buffer):
    sd = dict(reference.published_state_dict(weights, CFG))
    key = f"layers.0.residual_group.blocks.1.attn.{buffer}" \
        if buffer == "relative_position_index" \
        else f"layers.0.residual_group.blocks.1.{buffer}"
    sd[key] = sd[key].clone()
    sd[key][0, 0] += 1
    with pytest.raises(ValueError, match=key):
        checkpoint.import_swinir(sd)


def test_an_rrdbnet_state_dict_is_no_swinir():
    with pytest.raises(ValueError, match="not a SwinIR"):
        checkpoint.infer_swinir_arch({"conv_first.weight": torch.zeros(1)})


def test_the_published_parameter_count():
    """SwinIR-M x4 (embed 180, 6 x 6 layers, 6 heads, mlp 2, nearest+conv,
    1conv): 11,715,559 parameters in the reference and in the port built
    through the engine at its defaults."""
    full = {**CFG, "embed_dim": 180, "depths": [6] * 6, "num_heads": [6] * 6}
    assert reference.parameter_count(full) == 11_715_559
    net = gan.build_generator(_config(), "cpu")
    assert sum(p.numel() for p in net.parameters()) == 11_715_559
    names = {k for k, _ in net.named_parameters()}
    assert names == {n for n, *_ in reference.weight_specs(full)}


def test_the_shared_tail_gives_rrdbnet_bit_identical_outputs(monkeypatch):
    """RRDBNet through ``layers.nearest_conv_tail`` against its tail as it
    was written before the tail was shared, bit for bit; both nets call
    the shared tail once a forward."""
    net = RRDBNet(nf=16, nb=1, gc=8, device="cpu",
                  generator=torch.Generator().manual_seed(2))
    x = torch.rand((1, 3, 6, 10), generator=torch.Generator().manual_seed(4))
    lrelu = layers.activation("LeakyReLU")
    with torch.no_grad():
        fea = net.conv_first(x.contiguous(memory_format=torch.channels_last))
        fea = fea + net.trunk_conv(net.rrdb0(fea))
        for i in (1, 2):
            fea = F.interpolate(fea, scale_factor=2, mode="nearest")
            fea = lrelu(getattr(net, f"upconv{i}")(fea))
        before = net.conv_last(lrelu(net.conv_hr(fea))).float()
        calls = []
        real = layers.nearest_conv_tail
        for mod in (rrdb, swinir):
            monkeypatch.setattr(mod, "nearest_conv_tail",
                                lambda *a: calls.append(a[-1]) or real(*a))
        assert torch.equal(net(x), before)
        small = swinir.SwinIR(**ARCH, device="cpu")
        small(torch.rand(1, 3, 8, 8))
    assert calls == ["rrdb.upsample", "swinir.upsample"]


@pytest.mark.parametrize("fault", [("mask", "all"), ("shift", "all"),
                                   ("bias", 0), ("bias", 3), "fp8"])
def test_each_reference_fault_moves_the_output(weights, lr, want, fault):
    got = reference.forward(weights, lr, CFG, low="fp8") if fault == "fp8" \
        else reference.forward(weights, lr, CFG, fault=fault)
    assert _gap(got, want) > 100 * F32_LIMIT


@pytest.mark.parametrize("fusion,layers_n,fused", [("auto", 4, 3),
                                                   ("off", 4, 0)])
def test_routing(monkeypatch, weights, lr, fusion, layers_n, fused):
    """The window kernel's wrapper once a Swin layer (its plain chain under
    'off'), kernel A's for the tail's three 64 -> 64 convs alone: the convs
    at embed_dim channels, conv_first and conv_last stay on cuDNN (the
    launch counters move only on the card, so the calls are counted
    here)."""
    calls = {"attention": 0, "plain": 0, "fused": 0}
    real_wa, real_a = swinir.window_attention, layers.fused_conv3x3

    def attention(*a):
        calls["attention"] += 1
        calls["plain"] += a[-1]
        return real_wa(*a)

    def conv(*a, **k):
        calls["fused"] += 1
        return real_a(*a, **k)

    monkeypatch.setattr(swinir, "window_attention", attention)
    monkeypatch.setattr(layers, "fused_conv3x3", conv)
    net, config = _program(weights, conv_fusion=fusion)
    _forward(net, lr, config)
    assert calls == {"attention": layers_n, "fused": fused,
                     "plain": layers_n if fusion == "off" else 0}


def test_the_swinir_spans_nest_in_the_forward(weights, lr):
    net, config = _program(weights, dtype="bfloat16")
    kept = []
    handle = observe(None, kept.append)
    try:
        _forward(net, lr, config)
    finally:
        handle.remove()
    assert [r.name for r in kept] == ["swinir.body", "swinir.upsample",
                                      "gan.generator_forward"]
    top = kept[-1]
    assert all(r.parent == top.id and r.call == top.id for r in kept[:-1])
    # 24 x 32 after the pad: 3 x 4 windows a layer
    assert kept[0].fields == {"groups": 2, "layers": 4, "windows": 12,
                              "shift": 4}
    assert kept[1].fields == {"octaves": 2}


def test_the_models_carry_their_facts():
    """What the engine and the CLI read of each model class."""
    facts = {cls: (cls.output_range, cls.eval_only, cls.tiles,
                   cls.lr_tag(4)) for cls in gan.GENERATORS.values()}
    assert facts == {Generator: ((-1.0, 1.0), False, True, "x8"),
                     RRDBNet: ((0.0, 1.0), True, False, "x4"),
                     swinir.SwinIR: ((0.0, 1.0), True, False, "x4")}


def test_swinir_does_not_train_or_tile(weights, lr):
    net, config = _program(weights)
    with pytest.raises(ValueError, match="eval only"):
        gan.generator_forward(net, lr, config, train=True)
    with pytest.raises(ValueError, match="only 'srgan' trains"):
        gan.create_gan_state(config, 1e-4, device="cpu")
    for fn in (spatial.tiled_generator_forward,
               spatial.sharded_generator_forward):
        with pytest.raises(ValueError, match="SRGAN generator only"):
            fn(net, lr, config)


def test_an_unknown_generator_fails_at_build():
    with pytest.raises(ValueError, match="not in srgan/rrdb/swinir"):
        gan.build_generator(gan.GANTrainConfig(generator="swin"), "cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory, weights):
    """A DIV2K valid tree with the x4 LR set, and a SwinIR .pth as the
    published files hold it (``params_ema``, with the buffers)."""
    root = tmp_path_factory.mktemp("div2k_x4_swinir")
    hr_dir, lr_dir = root / "DIV2K_valid_HR", root / "DIV2K_valid_LR_x4"
    hr_dir.mkdir()
    lr_dir.mkdir()
    rng = np.random.default_rng(1)
    for name, (h, w) in (("0801", (96, 128)), ("0802", (80, 64))):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([np.sin(xx / 9.0), np.cos(yy / 7.0),
                        np.sin((xx + yy) / 13.0)], -1) * 100 + 128
        img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(
            np.uint8)
        Image.fromarray(img).save(hr_dir / f"{name}.png")
        Image.fromarray(img).resize((w // 4, h // 4), Image.BICUBIC).save(
            lr_dir / f"{name}x4.png")
    pth = str(root / "SwinIR-M_x4_tiny.pth")
    torch.save({"params_ema": reference.published_state_dict(weights, CFG)},
               pth)
    return root, pth


def test_the_eval_cli_runs_swinir(tree, tmp_path):
    root, pth = tree
    out = tmp_path / "out"
    out.mkdir()
    metrics = cli.run(["--data_dir", str(root), "--out_dir", str(out),
                       "--model_path", pth, "--generator", "swinir",
                       "--factor", "4", "--save_images", "True",
                       "--device", "cpu"])
    assert metrics["Number of images evaluated over"] == 2
    assert np.isfinite(metrics["avg_psnr"])
    (stamp,) = os.listdir(out / "out" / "GANx4")
    run_dir = out / "out" / "GANx4" / stamp
    assert sorted(os.listdir(run_dir / "images")) == ["0801.png",
                                                      "0802.png"]
    # the LR is shrunk by 2 on load, as the reference's pipeline does
    assert Image.open(run_dir / "images" / "0802.png").size == (32, 40)


@pytest.mark.parametrize("flag", ["--tiles", "--spatial_shards"])
def test_the_eval_cli_refuses_swinir_tiles(tree, tmp_path, flag):
    root, pth = tree
    with pytest.raises(SystemExit):
        cli.run(["--data_dir", str(root), "--out_dir", str(tmp_path),
                 "--model_path", pth, "--generator", "swinir", "--factor",
                 "4", flag, "2", "--device", "cpu"])


def test_the_eval_cli_refuses_another_scale(tree, tmp_path):
    root, pth = tree
    with pytest.raises(ValueError, match="another scale"):
        cli.run(["--data_dir", str(root), "--out_dir", str(tmp_path),
                 "--model_path", pth, "--generator", "swinir", "--factor",
                 "2", "--device", "cpu"])
