"""Image degradation ops with explicit random generators.

Counterpart of ``tpusr/ops/degrade.py`` (reference utils/degradation.py:
5-20): plain PyTorch over NHWC or HWC tensors in the uint8 domain held as
f32 in [0, 255]. Where the JAX package takes a ``jax.random`` key these
take a ``torch.Generator`` on the image's device; the two streams differ,
so tests compare statistics. Like the JAX versions, these do not call the
fused kernels (``ops/fused_degrade.py``).
"""

from __future__ import annotations

import torch

from tpusr_torch.ops.bicubic import resize_bicubic


def add_gaussian_noise(generator: torch.Generator, image: torch.Tensor,
                       std: float = 1.0) -> torch.Tensor:
    """floor(clip(img + N(0, std * 255), 0, 255)): the reference's trailing
    uint8 cast truncates, so values are floored, not rounded."""
    noise = torch.randn(image.shape, generator=generator,
                        dtype=torch.float32, device=image.device)
    out = torch.clamp(image.to(torch.float32) + noise * (std * 255.0),
                      0.0, 255.0)
    return torch.floor(out)


def add_salt_pepper_noise(generator: torch.Generator, image: torch.Tensor,
                          s: float = 0.01, p: float = 0.01) -> torch.Tensor:
    """Per-pixel masks shared across channels: salt (255), then pepper (0),
    so a pixel drawn for both ends up pepper."""
    mask_shape = (*image.shape[:-1], 1)
    salt = torch.rand(mask_shape, generator=generator,
                      device=image.device) < s
    pepper = torch.rand(mask_shape, generator=generator,
                        device=image.device) < p
    out = torch.where(salt, 255.0, image.to(torch.float32))
    return torch.where(pepper, 0.0, out)


def degrade_pipeline(generator: torch.Generator, hr_u8: torch.Tensor,
                     factor: int, noise_type: dict | None = None):
    """HR -> degraded LR (uint8-domain f32 in and out): bicubic /factor,
    round and clip, then the optional Gaussian or salt-and-pepper noise."""
    h, w = hr_u8.shape[-3], hr_u8.shape[-2]
    lr = resize_bicubic(hr_u8.to(torch.float32), h // factor, w // factor)
    lr = torch.clamp(torch.round(lr), 0.0, 255.0)
    if noise_type is None:
        return lr
    if noise_type["type"] == "Gaussian":
        return add_gaussian_noise(generator, lr, std=noise_type["std"])
    if noise_type["type"] == "SaltAndPepper":
        return add_salt_pepper_noise(generator, lr, s=noise_type["s"],
                                     p=noise_type["p"])
    raise ValueError(f"unknown noise type {noise_type!r}")
