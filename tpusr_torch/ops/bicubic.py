"""Pillow-compatible bicubic resize as dense weight-matrix contractions.

Counterpart of ``tpusr/ops/bicubic.py``, with the same public functions and
the JAX package's NHWC or HWC layout at them. The separable filter banks
are (out, in) matrices built on the host with numpy (a copy of tpusr's
construction: Pillow's Keys cubic, a = -0.5, support 2 scaled by the
reduction factor); the resize is two contractions.

``resize_bicubic_u8`` reproduces Pillow's 8-bit fixed-point pipeline byte
for byte: coefficients round(w * 2**22), horizontal pass first, uint8
intermediate, clip8((acc + 2**21) >> 22). Both passes accumulate in
float64, on every device: every product and partial sum is an integer
below 2**53, so the sums are exact whatever their order (CUDA has no
integer matrix product), and the rounding shift then runs on int64.
"""

from __future__ import annotations

import numpy as np
import torch

_A = -0.5  # Keys cubic coefficient used by Pillow's BICUBIC filter
_SUPPORT = 2.0
_PRECISION_BITS = 32 - 8 - 2  # 22


def _cubic_filter(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x < 1.0,
        (_A + 2.0) * x3 - (_A + 3.0) * x2 + 1.0,
        np.where(x < 2.0, _A * (x3 - 5.0 * x2 + 8.0 * x - 4.0), 0.0),
    )


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) float64 bicubic matrix, PIL semantics:
    half-pixel centers, support scaled by max(in/out, 1), rows normalised
    to sum 1, taps clamped to the image."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale

    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(0, np.floor(centers - support).astype(np.int64))
    xmax = np.minimum(in_size, np.ceil(centers + support).astype(np.int64))

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        taps = np.arange(xmin[i], xmax[i], dtype=np.float64)
        w = _cubic_filter((taps + 0.5 - centers[i]) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        mat[i, xmin[i]:xmax[i]] = w
    return mat


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize an NHWC (or HWC) float tensor with PIL-BICUBIC semantics, in
    x's dtype. Values are not clipped or quantised."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    mh = torch.as_tensor(resize_matrix(h, out_h), dtype=x.dtype,
                         device=x.device)
    mw = torch.as_tensor(resize_matrix(w, out_w), dtype=x.dtype,
                         device=x.device)
    y = torch.einsum("oh,nhwc->nowc", mh, x)
    y = torch.einsum("pw,nowc->nopc", mw, y)
    return y[0] if squeeze else y


def pil_downsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Integer-factor shrink (utils/degradation.py:19-20): new size =
    floor(size / factor)."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bicubic(x, h // factor, w // factor)


def resize_matrix_u8(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) int32 coefficient matrix matching Pillow's quantisation."""
    m = resize_matrix(in_size, out_size)
    scale = float(1 << _PRECISION_BITS)
    q = np.where(m < 0, m * scale - 0.5, m * scale + 0.5)
    return q.astype(np.int32)


def _pass_u8(x: torch.Tensor, coeffs: np.ndarray, axis: int) -> torch.Tensor:
    """One fixed-point resample pass along H (axis=-3) or W (axis=-2) of an
    int64 tensor; exact float64 sums, then Pillow's rounding shift."""
    k = torch.as_tensor(coeffs, dtype=torch.float64, device=x.device)
    xf = x.to(torch.float64)
    if axis == -3:
        acc = torch.einsum("oh,...hwc->...owc", k, xf)
    else:
        acc = torch.einsum("ow,...hwc->...hoc", k, xf)
    acc = (acc.to(torch.int64) + (1 << (_PRECISION_BITS - 1))) \
        >> _PRECISION_BITS
    return torch.clamp(acc, 0, 255)


def resize_bicubic_u8(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Byte-exact PIL BICUBIC resize of a uint8 HWC / NHWC image; int32
    values in [0, 255]. Horizontal pass first, as Pillow."""
    x = x.to(torch.int64)
    h, w = x.shape[-3], x.shape[-2]
    if w != out_w:
        x = _pass_u8(x, resize_matrix_u8(w, out_w), axis=-2)
    if h != out_h:
        x = _pass_u8(x, resize_matrix_u8(h, out_h), axis=-3)
    return x.to(torch.int32)
