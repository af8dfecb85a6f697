"""Fused image degradation: in-kernel Philox, Gaussian and salt-and-pepper.

Counterpart of ``tpusr/ops/pallas_degrade.py``. Each function reads an HWC
image in the uint8 domain (cast to f32) once and writes the degraded f32
image once, drawing its random numbers inside the kernel, so no noise
tensor is ever written to memory.

Random bits: Philox4x32-10 (Random123's constants and round function),
key ``(seed mod 2**32, 0)`` for an int32 ``seed``. The counter layout, which
the kernels (``tpusr_torch/csrc/degrade.cu``) and the plain versions below
share:

  * Gaussian: flat HWC element ``e`` takes counter ``(e // 2, 0, 0, 0)``;
    an even ``e`` uses output words 0 and 1 as (u1, u2), an odd ``e`` words
    2 and 3;
  * salt and pepper: pixel ``(h, w)`` takes counter ``(h * W + w, 1, 0, 0)``;
    word 0 gives u_s and word 1 u_p, the same for every channel of the
    pixel (the channel-shared masks of the TPU kernel).

Uniforms: ``((b >> 9) | 0x3F800000)`` read as f32, minus 1, in
[0, 1 - 2**-23], as ``pallas_degrade.py::_uniform_from_bits``. The TPU's own
bits cannot be reproduced, so the port matches the TPU kernels' arithmetic
and statistics, not their streams.

The TPU layouts, the (rows, W*C) flattening and the planar (C, H, W)
transpose, exist for the TPU's lanes; the port works on contiguous HWC.

Kernels: D ``fused_add_gaussian_noise`` and E ``fused_add_salt_pepper_noise``.
Each wrapper launches its kernel for a CUDA tensor and raises on what the
kernel does not take; for a CPU tensor it runs the plain version.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

LAUNCHES = {"fused_add_gaussian_noise": 0, "fused_add_salt_pepper_noise": 0}

_SOURCE = "degrade.cu"
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------- plain versions
def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of m * b for a 32-bit constant m and int64
    words b in [0, 2**32). The 64-bit product overflows int64, so b is split
    into 16-bit halves and every partial stays below 2**49."""
    t_lo = m * (b & 0xFFFF)
    s = m * (b >> 16) + (t_lo >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (t_lo & 0xFFFF)


def philox4x32_10(counter: torch.Tensor, key) -> torch.Tensor:
    """Philox4x32-10 of int64 counters (..., 4), words in [0, 2**32), under
    ``key`` (k0, k1); returns the (..., 4) int64 output words."""
    c0, c1, c2, c3 = counter.to(torch.int64).unbind(-1)
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], -1)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) -> f32 uniforms in [0, 1 - 2**-23]: the top 23
    bits under the exponent of 1.0, minus 1. The word is below 2**31, so
    the int32 view is exact."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def gaussian_from_uniforms(img, u1, u2, std: float) -> torch.Tensor:
    """floor(clip(img + z * std * 255, 0, 255)) with the Box-Muller cosine
    z = sqrt(-2 ln max(u1, 1e-7)) cos(2 pi u2), all in f32
    (pallas_degrade.py:38-49)."""
    u1 = torch.clamp(torch.as_tensor(u1, dtype=torch.float32,
                                     device=img.device), min=1e-7)
    u2 = torch.as_tensor(u2, dtype=torch.float32, device=img.device)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return torch.floor(torch.clamp(img + z * (std * 255.0), 0.0, 255.0))


def salt_pepper_from_uniforms(img, us, up, s: float, p: float):
    """255 where us < s, then 0 where up < p: pepper wins
    (pallas_degrade.py:52-63). us and up broadcast against img."""
    us = torch.as_tensor(us, dtype=torch.float32, device=img.device)
    up = torch.as_tensor(up, dtype=torch.float32, device=img.device)
    out = torch.where(us < s, 255.0, img)
    return torch.where(up < p, 0.0, out)


def _key(seed) -> tuple[int, int]:
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not an int32 value")
    return seed % 2 ** 32, 0


def _counters(n: int, word1: int, device) -> torch.Tensor:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    return torch.stack([idx, torch.full_like(idx, word1), zero, zero], -1)


def fused_add_gaussian_noise_reference(image, seed, std: float = 1.0):
    """Plain version of kernel D on an HWC image; f32 out."""
    img = _as_image(image)
    n = img.numel()
    u = uniform_from_bits(philox4x32_10(_counters((n + 1) // 2, 0,
                                                  img.device), _key(seed)))
    u1 = u[:, 0::2].reshape(-1)[:n]  # words 0 and 2 of each pair's call
    u2 = u[:, 1::2].reshape(-1)[:n]  # words 1 and 3
    return gaussian_from_uniforms(img.reshape(-1), u1, u2,
                                  std).view(img.shape)


def fused_add_salt_pepper_noise_reference(image, seed, s: float = 0.01,
                                          p: float = 0.01):
    """Plain version of kernel E on an HWC image; f32 out."""
    img = _as_image(image)
    h, w, _ = img.shape
    u = uniform_from_bits(philox4x32_10(_counters(h * w, 1, img.device),
                                        _key(seed))).view(h, w, 4)
    return salt_pepper_from_uniforms(img, u[..., 0:1], u[..., 1:2], s, p)


# ------------------------------------------------------------ CUDA launchers
def _lib():
    from tpusr_torch.ops._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_tpusr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        cu, cf = ctypes.c_uint, ctypes.c_float
        lib.tpusr_gaussian_noise.argtypes = [ci, vp, vp, ci, cu, cf, vp]
        lib.tpusr_gaussian_noise.restype = ci
        lib.tpusr_salt_pepper_noise.argtypes = [ci, vp, vp, ci, ci, cu, cf,
                                                cf, vp]
        lib.tpusr_salt_pepper_noise.restype = ci
        lib._tpusr_typed = True
    return lib


def _as_image(image) -> torch.Tensor:
    """The f32 contiguous HWC image the functions read."""
    if image.dim() != 3 or min(image.shape) < 1:
        raise ValueError(f"fused_degrade: image must be (H, W, C) with every "
                         f"side >= 1, got {tuple(image.shape)}")
    if image.numel() >= 2 ** 31:
        raise ValueError("fused_degrade: image too large")
    return image.to(torch.float32).contiguous()


def _launch(fn, name, img, *args):
    out = torch.empty_like(img)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = fn(img.device.index or 0, ctypes.c_void_p(img.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), *args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


# ------------------------------------------------------------------ wrappers
def fused_add_gaussian_noise(image, seed, std: float = 1.0) -> torch.Tensor:
    """Gaussian degradation of an HWC uint8-domain image with an int32
    seed: kernel D on a CUDA tensor, its plain version on a CPU tensor.
    Returns the f32 HWC image."""
    img = _as_image(image)
    if img.device.type == "cpu":
        return fused_add_gaussian_noise_reference(img, seed, std)
    return _launch(_lib().tpusr_gaussian_noise, "fused_add_gaussian_noise",
                   img, img.numel(), _key(seed)[0], std * 255.0)


def fused_add_salt_pepper_noise(image, seed, s: float = 0.01,
                                p: float = 0.01) -> torch.Tensor:
    """Salt-and-pepper degradation (masks shared across channels): kernel E
    on a CUDA tensor, its plain version on a CPU tensor. Returns f32 HWC."""
    img = _as_image(image)
    if img.device.type == "cpu":
        return fused_add_salt_pepper_noise_reference(img, seed, s, p)
    h, w, c = img.shape
    return _launch(_lib().tpusr_salt_pepper_noise,
                   "fused_add_salt_pepper_noise", img, h * w, c,
                   _key(seed)[0], s, p)
