"""ESRGAN's RRDBNet forward in plain PyTorch, from the published equations
(Wang et al., arXiv:1809.00219; github.com/xinntao/ESRGAN
``RRDBNet_arch.py``, ``RRDBNet(3, 3, 64, 23, gc=32)``), imported from no
part of the program:

  dense block on x (nf channels): c_k = lrelu(conv3x3([x, c_1..c_k-1]))
  for k = 1..4 (gc channels each), c_5 = conv3x3([x, c_1..c_4]) (nf),
  y = x + 0.2 c_5;  RRDB(x) = x + 0.2 DB3(DB2(DB1(x)));
  fea = conv_first(x); fea += trunk_conv(nb RRDBs (fea));
  per octave [nearest x2, conv3x3, lrelu]; lrelu(HRconv); conv_last

with zero 'same' padding, LeakyReLU slope 0.2, biases on every conv, no
BatchNorm and no output non-linearity (ESRGAN's test script clamps only
to write a PNG). ``make_weights`` draws every weight in ESRGAN's published
names and OIHW layout from a seed on the device, U(+-1/sqrt(fan_in)); the
benchmark loads the same into the program through its importer.

``forward`` runs in f32 with TF32 off. ``low='fp8'`` rounds both operands
of every conv to float8 e4m3 with a per-tensor scale (the control of a
bf16 cell). ``fault`` puts one of the faults the cell must catch in the
program's place: ``('block', n)`` leaves out the n-th of the 3 nb dense
blocks (counted over the trunk, from 0), ``('scale', i)`` drops RRDB i's
outer 0.2 (x + out).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from srbench.reference.skipnet import exact_f32
from srbench.reference.srgan_train import _fp8

SLOPE, BETA = 0.2, 0.2  # LeakyReLU slope, residual scaling


def octaves(cfg: dict) -> int:
    """The x2 stages of a x``scale`` net."""
    return int(cfg["scale"]).bit_length() - 1


def weight_specs(cfg: dict) -> list[tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every weight and bias, in ESRGAN's names,
    OIHW."""
    nf, gc = cfg["nf"], cfg["gc"]
    specs = []

    def conv(name, ci, co):
        specs.append((f"{name}.weight", (co, ci, 3, 3), 9 * ci))
        specs.append((f"{name}.bias", (co,), 9 * ci))

    conv("conv_first", cfg["in_nc"], nf)
    for i in range(cfg["nb"]):
        for j in range(1, 4):
            for k in range(1, 6):
                conv(f"RRDB_trunk.{i}.RDB{j}.conv{k}", nf + (k - 1) * gc,
                     gc if k < 5 else nf)
    conv("trunk_conv", nf, nf)
    for n in range(1, octaves(cfg) + 1):
        conv(f"upconv{n}", nf, nf)
    conv("HRconv", nf, nf)
    conv("conv_last", nf, cfg["out_nc"])
    return specs


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _ in weight_specs(cfg))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight and bias from ``seed``: one uniform draw on the device,
    cut into the leaves, each U(+-1/sqrt(fan_in))."""
    specs = weight_specs(cfg)
    sizes = [math.prod(s) for _, s, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    return {name: ((2 * u - 1) / math.sqrt(fan_in)).reshape(shape)
            for (name, shape, fan_in), u in zip(specs, flat.split(sizes))}


def _conv(p, name, x, low):
    w = p[f"{name}.weight"]
    if low == "fp8":
        x, w = _fp8(x), _fp8(w)
    return F.conv2d(x, w, p[f"{name}.bias"], padding=1)


def _lrelu(x):
    return F.leaky_relu(x, SLOPE)


def _dense_block(p, name, x, low):
    feats = [x]
    for k in range(1, 5):
        feats.append(_lrelu(_conv(p, f"{name}.conv{k}", torch.cat(feats, 1),
                                  low)))
    return x + BETA * _conv(p, f"{name}.conv5", torch.cat(feats, 1), low)


def forward(p: dict, lr_nhwc: torch.Tensor, cfg: dict,
            low: str | None = None,
            fault: tuple[str, int] | None = None) -> torch.Tensor:
    """NHWC LR in [0, 1] -> NHWC f32, unbounded; TF32 off."""
    if low not in (None, "fp8"):
        raise ValueError(f"low {low!r} not in None/'fp8'")
    kind, at = fault if fault is not None else (None, -1)
    with torch.no_grad(), exact_f32():
        x = lr_nhwc.permute(0, 3, 1, 2).float()
        fea = _conv(p, "conv_first", x, low)
        trunk = fea
        for i in range(cfg["nb"]):
            out = trunk
            for j in range(1, 4):
                if (kind, at) != ("block", 3 * i + j - 1):
                    out = _dense_block(p, f"RRDB_trunk.{i}.RDB{j}", out, low)
            beta = 1.0 if (kind, at) == ("scale", i) else BETA
            trunk = trunk + beta * out
        fea = fea + _conv(p, "trunk_conv", trunk, low)
        for n in range(1, octaves(cfg) + 1):
            fea = F.interpolate(fea, scale_factor=2, mode="nearest")
            fea = _lrelu(_conv(p, f"upconv{n}", fea, low))
        y = _conv(p, "conv_last", _lrelu(_conv(p, "HRconv", fea, low)), low)
    return y.permute(0, 2, 3, 1)

