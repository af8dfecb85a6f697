"""The SRGAN x8 generator's forward in plain PyTorch, from the published
description (Ledig et al., arXiv:1609.04802; the reference repo's
models/GAN/generator.py at x8), imported from no part of the program:

  conv 9x9 3 -> 64, PReLU -> 16 x [conv 3x3, BN, PReLU, conv 3x3, BN,
  + x] -> conv 3x3, BN, + the head's output -> 3 x [conv 3x3 64 -> 256,
  pixel shuffle x2, PReLU] -> conv 9x9 64 -> 3 -> tanh

with zero 'same' padding and BatchNorm in eval mode (running statistics).
``make_weights`` draws every weight and running statistic from a seed on
the card in one call; the benchmark loads the same into the program.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from srbench.reference.skipnet import exact_f32

BN_EPS = 1e-5


def weight_specs(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every weight and statistic, under the
    generator's module names."""
    c = cfg["n_features"]
    specs = []

    def conv(name, ci, co, k):
        specs.append((f"{name}.weight", (co, ci, k, k), "conv", k * k * ci))
        specs.append((f"{name}.bias", (co,), "conv", k * k * ci))

    def bn(name):
        for part in ("weight", "bias", "running_mean", "running_var"):
            specs.append((f"{name}.{part}", (c,), part, 0))

    def prelu(name):
        specs.append((f"{name}.alpha", (1,), "alpha", 0))

    conv("conv1", 3, c, 9)
    prelu("prelu1")
    for i in range(cfg["residual_blocks_count"]):
        conv(f"res{i}.conv1", c, c, 3)
        bn(f"res{i}.bn1")
        prelu(f"res{i}.prelu1")
        conv(f"res{i}.conv2", c, c, 3)
        bn(f"res{i}.bn2")
    conv("conv2", c, c, 3)
    bn("bn1")
    for i in range(cfg["n_shuffles"]):
        conv(f"ps{i}.conv1", c, 4 * c, 3)
        prelu(f"ps{i}.prelu1")
    conv("conv3", c, 3, 9)
    return specs


# kind -> (low, high) of a uniform draw; convs U(+-1/sqrt(fan_in))
RANGES = {"weight": (0.8, 1.2), "bias": (-0.1, 0.1),
          "running_mean": (-0.2, 0.2), "running_var": (0.5, 1.5),
          "alpha": (0.1, 0.3)}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight and running statistic from ``seed``: one uniform draw
    on the card, cut into the leaves."""
    specs = weight_specs(cfg)
    sizes = [math.prod(s) for _, s, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, kind, fan_in), u in zip(specs, flat.split(sizes)):
        if kind == "conv":
            lo, hi = -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in)
        else:
            lo, hi = RANGES[kind]
        out[name] = (lo + (hi - lo) * u).reshape(shape)
    return out


def _conv(p, name, x):
    w = p[f"{name}.weight"]
    return F.conv2d(x, w.to(x.dtype), p[f"{name}.bias"].to(x.dtype),
                    padding=w.shape[-1] // 2)


def _bn(p, name, x):
    inv = torch.rsqrt(p[f"{name}.running_var"] + BN_EPS)
    scale = (p[f"{name}.weight"] * inv).view(1, -1, 1, 1)
    shift = (p[f"{name}.bias"] - p[f"{name}.running_mean"] * inv
             * p[f"{name}.weight"]).view(1, -1, 1, 1)
    return x * scale.to(x.dtype) + shift.to(x.dtype)


def _prelu(p, name, x):
    a = p[f"{name}.alpha"].to(x.dtype)
    return torch.where(x >= 0, x, a * x)


def forward(p: dict, lr_nhwc: torch.Tensor, cfg: dict,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC LR in [0, 1] -> NHWC f32 in [-1, 1]; TF32 off. ``dtype``
    bf16 computes the convs in bf16 (the control)."""
    autocast = (torch.autocast(device_type=lr_nhwc.device.type, dtype=dtype)
                if dtype != torch.float32 else contextlib.nullcontext())
    with torch.no_grad(), exact_f32(), autocast:
        x = lr_nhwc.permute(0, 3, 1, 2).float()
        x0 = _prelu(p, "prelu1", _conv(p, "conv1", x))
        z = x0
        for i in range(cfg["residual_blocks_count"]):
            r = _prelu(p, f"res{i}.prelu1",
                       _bn(p, f"res{i}.bn1", _conv(p, f"res{i}.conv1", z)))
            z = z + _bn(p, f"res{i}.bn2", _conv(p, f"res{i}.conv2", r))
        z = x0 + _bn(p, "bn1", _conv(p, "conv2", z))
        for i in range(cfg["n_shuffles"]):
            z = _prelu(p, f"ps{i}.prelu1",
                       F.pixel_shuffle(_conv(p, f"ps{i}.conv1", z), 2))
        y = torch.tanh(_conv(p, "conv3", z).float())
    return y.permute(0, 2, 3, 1)
