"""Antialiased strided downsampling — the DIP forward model.

Counterpart of ``tpusr/ops/resample.py`` (reference: utils/downsampler.py).
The kernel construction is a numpy copy of the JAX package's, with the
reference's quirks (gauss half distances, phase-0.5 taps at
|i+0.5-center|/factor, (w-1)x(w-1) phase-0.5 kernels, sum-1 normalization).
The lanczos/gauss/box kernels are rank-1, so the 2-D depthwise conv runs as
two strided 1-D depthwise passes; autograd gives the backward.
``conv2d_with`` takes any 2-D kernel (opt_over='down' trains one).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _lanczos_1d(taps: np.ndarray, support: float) -> np.ndarray:
    """Windowed-sinc value at distances ``taps`` (in units of the factor)."""
    t = np.abs(taps).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        val = (support * np.sin(np.pi * t) * np.sin(np.pi * t / support)
               / (np.pi * np.pi * t * t))
    return np.where(t == 0.0, 1.0, val)


def get_kernel_1d(factor: int, kernel_type: str, phase: float,
                  kernel_width: int, support: float | None = None,
                  sigma: float | None = None) -> np.ndarray:
    """1-D tap vector whose outer product (normalized) is the 2-D kernel."""
    size = kernel_width - 1 if (phase == 0.5 and kernel_type != "box") \
        else kernel_width
    if kernel_type == "box":
        if phase != 0.5:
            raise ValueError("box filter is always half-phased")
        return np.full(size, 1.0 / size, dtype=np.float64)

    idx = np.arange(1, size + 1, dtype=np.float64)
    center = (kernel_width + 1.0) / 2.0
    if kernel_type == "gauss":
        if sigma is None:
            raise ValueError("sigma is not specified")
        if phase == 0.5:
            raise ValueError("phase 1/2 for gauss not implemented")
        d = (idx - center) / 2.0
        sigma_sq = sigma * sigma
        k = np.exp(-(d * d) / (2.0 * sigma_sq))
        return k / np.sqrt(2.0 * np.pi * sigma_sq)
    if kernel_type == "lanczos":
        if support is None:
            raise ValueError("support is not specified")
        if phase == 0.5:
            d = np.abs(idx + 0.5 - center) / factor
        else:
            d = np.abs(idx - center) / factor
        return _lanczos_1d(d, float(support))
    raise ValueError(f"wrong kernel type {kernel_type!r}")


def get_kernel(factor: int, kernel_type: str, phase: float, kernel_width: int,
               support: float | None = None,
               sigma: float | None = None) -> np.ndarray:
    """2-D resampling kernel, normalized to sum 1."""
    k1 = get_kernel_1d(factor, kernel_type, phase, kernel_width, support,
                       sigma)
    k2d = np.outer(k1, k1)
    return k2d / k2d.sum()


_KERNEL_PRESETS = {
    # name -> (resolved_type, support, kernel_width_fn, sigma)
    "lanczos2": ("lanczos", 2, lambda f: 4 * f + 1, None),
    "lanczos3": ("lanczos", 3, lambda f: 6 * f + 1, None),
    "gauss12": ("gauss", None, lambda f: 7, 0.5),
    "gauss1sq2": ("gauss", None, lambda f: 9, 1.0 / np.sqrt(2.0)),
}


def resolve_kernel_spec(factor: int, kernel_type: str,
                        kernel_width: int | None = None,
                        support: float | None = None,
                        sigma: float | None = None):
    """Resolve the reference's named presets (utils/downsampler.py:14-38)."""
    if kernel_type in _KERNEL_PRESETS:
        ktype, support, width_fn, sigma = _KERNEL_PRESETS[kernel_type]
        return ktype, width_fn(factor), support, sigma
    if kernel_type in ("lanczos", "gauss", "box"):
        if kernel_width is None:
            raise ValueError("kernel_width required for generic kernel types")
        return kernel_type, kernel_width, support, sigma
    raise ValueError(f"wrong name kernel {kernel_type!r}")


class Downsampler(nn.Module):
    """Depthwise antialiased downsampler over NCHW (utils/downsampler.py:5-71).

    ``preserve_size=True`` replicate-pads first so the output is exactly
    input/factor. The separable taps are a buffer, so ``.to(device)`` moves
    them with the module.
    """

    def __init__(self, n_planes: int, factor: int, kernel_type: str,
                 phase: float = 0, kernel_width: int | None = None,
                 support: float | None = None, sigma: float | None = None,
                 preserve_size: bool = False):
        super().__init__()
        if phase not in (0, 0.5):
            raise ValueError("phase should be 0 or 0.5")
        ktype, kwidth, ksupport, ksigma = resolve_kernel_spec(
            factor, kernel_type, kernel_width, support, sigma)
        self.factor = int(factor)
        self.n_planes = int(n_planes)
        # get_kernel == outer(t, t) / (sum t)^2, so each 1-D pass uses t / sum t
        t = get_kernel_1d(factor, ktype, phase, kwidth, ksupport, ksigma)
        self.register_buffer("taps", torch.from_numpy(
            (t / t.sum()).astype(np.float32)))
        # the full 2-D kernel, the leaf that opt_over='down' trains
        self.register_buffer("kernel", torch.from_numpy(get_kernel(
            factor, ktype, phase, kwidth, ksupport, ksigma).astype(
                np.float32)), persistent=False)
        ksize = t.size
        if preserve_size:
            self.pad = ((ksize - 1) // 2 if ksize % 2 == 1
                        else (ksize - self.factor) // 2)
        else:
            self.pad = 0
        self.preserve_size = preserve_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W) -> (N, C, H', W')."""
        c = x.shape[1]
        k = self.taps.numel()
        taps = self.taps.to(x.dtype)
        if self.pad > 0:
            x = F.pad(x, (self.pad,) * 4, mode="replicate")
        y = F.conv2d(x, taps.view(1, 1, k, 1).repeat(c, 1, 1, 1),
                     stride=(self.factor, 1), groups=c)
        return F.conv2d(y, taps.view(1, 1, 1, k).repeat(c, 1, 1, 1),
                        stride=(1, self.factor), groups=c)

    def conv2d_with(self, x: torch.Tensor,
                    kernel2d: torch.Tensor) -> torch.Tensor:
        """Depthwise strided conv of x (N, C, H, W) with one 2-D kernel
        (k, k) shared by every channel, after the same edge pad as
        ``forward``. Equals ``forward`` when kernel2d == outer(taps, taps);
        gradients reach every entry of the kernel, not only a rank-1 one."""
        c, k = x.shape[1], kernel2d.shape[0]
        if self.pad > 0:
            x = F.pad(x, (self.pad,) * 4, mode="replicate")
        w = kernel2d.to(x.dtype).view(1, 1, k, k).expand(c, 1, k, k)
        return F.conv2d(x, w, stride=self.factor, groups=c)
