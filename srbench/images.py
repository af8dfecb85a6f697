"""Seeded structured images made on the device.

A copy, in PyTorch, of the structured synthetic DIV2K images of
``tools/make_synth_div2k.py::make_image``: multi-octave smoothed value
noise with a 1/f amplitude spectrum, a global colour gradient and 8 to 19
anti-aliased ellipses and rectangles. White noise would be unlearnable
through an x8 downsample; these have edges, texture and smooth regions.
The random fields are drawn on the card from a ``torch.Generator`` there,
the shapes' few scalars from a numpy generator; the same seed gives the
same image.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def structured_image(seed: int, h: int, w: int, device) -> torch.Tensor:
    """(h, w, 3) f32 in [0, 1] on ``device``."""
    size = max(h, w)
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    img = torch.zeros((1, 3, size, size), device=device)
    amp_total, cells, octave = 0.0, 4, 0
    while cells <= size:
        amp = 1.0 / 1.6 ** octave
        field = torch.rand((1, 3, cells, cells), generator=gen, device=device)
        img += amp * F.interpolate(field, size=(size, size), mode="bicubic",
                                   align_corners=False).clamp(0.0, 1.0)
        amp_total += amp
        cells, octave = cells * 2, octave + 1
    img = img[0].permute(1, 2, 0) / amp_total  # (size, size, 3)
    ramp = torch.linspace(0.0, 1.0, size, device=device)
    direction = torch.as_tensor(rng.random(3) - 0.5, dtype=torch.float32,
                                device=device)
    img = img * 0.7 + 0.3 * (0.5 + ramp[None, :, None] * direction)
    yy, xx = torch.meshgrid(torch.arange(size, device=device,
                                         dtype=torch.float32),
                            torch.arange(size, device=device,
                                         dtype=torch.float32), indexing="ij")
    for _ in range(int(rng.integers(8, 20))):
        cx, cy = rng.uniform(0, size, 2)
        a, b = rng.uniform(size * 0.03, size * 0.25, 2)
        theta = rng.uniform(0, math.pi)
        color = torch.as_tensor(rng.random(3), dtype=torch.float32,
                                device=device)
        alpha = rng.uniform(0.5, 1.0)
        ct, st = math.cos(theta), math.sin(theta)
        u = (xx - cx) * ct + (yy - cy) * st
        v = -(xx - cx) * st + (yy - cy) * ct
        if rng.random() < 0.5:  # ellipse, about one pixel of anti-aliasing
            d = torch.sqrt((u / a) ** 2 + (v / b) ** 2) - 1.0
            edge = (0.5 - d * max(a, b)).clamp(0.0, 1.0)
        else:  # rectangle
            d = torch.maximum(u.abs() - a, v.abs() - b)
            edge = (0.5 - d).clamp(0.0, 1.0)
        mask = (alpha * edge)[..., None]
        img = img * (1 - mask) + color * mask
    return img.clamp(0.0, 1.0)[:h, :w].contiguous()


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8, as an image file would hold it."""
    return (img * 255).to(torch.uint8)


def downscale(img: torch.Tensor, factor: int) -> torch.Tensor:
    """(H, W, 3) -> (H / factor, W / factor, 3): antialiased bicubic, the
    DIV2K LR convention (PIL's bicubic resize)."""
    x = img.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(img.shape[0] // factor,
                               img.shape[1] // factor), mode="bicubic",
                      antialias=True, align_corners=False)
    return y[0].permute(1, 2, 0).clamp(0.0, 1.0).contiguous()
