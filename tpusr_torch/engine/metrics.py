"""Image quality metrics (PSNR / SSIM) over NHWC tensors.

Counterpart of ``tpusr/engine/metrics.py``, with torchmetrics' conventions
as the reference uses them (DIP.py:7-8, 157-159):
  * PSNR: data_range inferred from the target (max - min) when not given;
    squared error pooled over everything.
  * SSIM: 11x11 Gaussian window, sigma 1.5, k1 0.01, k2 0.03, valid
    convolution, mean over the SSIM map; variances clamped at 0.
The window is applied as a separable depthwise conv. The ``_masked``
forms score the valid top-left region of zero-padded images (the
shape-bucketed DIP path).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float | None = None) -> torch.Tensor:
    """Peak signal-to-noise ratio, pooled over all elements."""
    pred, target = pred.float(), target.float()
    dr = target.max() - target.min() if data_range is None else data_range
    mse = (pred - target).square().mean()
    return 10.0 * torch.log10(dr * dr / mse)


def _valid_mask(shape_hw, valid_hw, device=None) -> torch.Tensor:
    """(H, W, 1) f32 mask of rows < valid_hw[0] and cols < valid_hw[1]."""
    h, w = shape_hw
    rows = torch.arange(h, device=device)[:, None] < valid_hw[0]
    cols = torch.arange(w, device=device)[None, :] < valid_hw[1]
    return (rows & cols).float()[..., None]


def psnr_masked(pred: torch.Tensor, target: torch.Tensor, valid_hw,
                data_range: float | None = None) -> torch.Tensor:
    """PSNR over the valid top-left region of padded NHWC images;
    data_range=None infers max - min over the valid region of the target."""
    pred, target = pred.float(), target.float()
    m = _valid_mask(pred.shape[1:3], valid_hw, pred.device)
    if data_range is None:
        dr = (torch.where(m > 0, target, -torch.inf).max()
              - torch.where(m > 0, target, torch.inf).min())
    else:
        dr = data_range
    n = torch.clamp(m.sum(), min=1.0) * pred.shape[0] * pred.shape[-1]
    mse = ((pred - target).square() * m).sum() / n
    return 10.0 * torch.log10(dr * dr / mse)


def _gaussian_window(kernel_size: int, sigma: float) -> np.ndarray:
    half = (kernel_size - 1) / 2.0
    x = np.arange(kernel_size, dtype=np.float64) - half
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian filter over NCHW."""
    c, k = x.shape[1], win.numel()
    y = F.conv2d(x, win.view(1, 1, k, 1).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(y, win.view(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)


def _ssim_map(pred, target, data_range, kernel_size, sigma, k1, k2):
    p = pred.float().permute(0, 3, 1, 2)
    t = target.float().permute(0, 3, 1, 2)
    win = torch.from_numpy(_gaussian_window(kernel_size, sigma)).to(p.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p, mu_t = _blur(p, win), _blur(t, win)
    mu_pp, mu_tt = _blur(p * p, win), _blur(t * t, win)
    mu_pt = _blur(p * t, win)
    # E[x^2]-E[x]^2 can dip below zero on flat regions; true variances can't
    var_p = torch.clamp(mu_pp - mu_p * mu_p, min=0.0)
    var_t = torch.clamp(mu_tt - mu_t * mu_t, min=0.0)
    cov = mu_pt - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2)
    return num / den


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Structural similarity of NHWC images, mean over the valid map."""
    return _ssim_map(pred, target, data_range, kernel_size, sigma, k1,
                     k2).mean()


def ssim_masked(pred: torch.Tensor, target: torch.Tensor, valid_hw,
                data_range: float = 1.0, kernel_size: int = 11,
                sigma: float = 1.5, k1: float = 0.01,
                k2: float = 0.03) -> torch.Tensor:
    """SSIM averaged over the valid part of the (valid-conv) SSIM map."""
    smap = _ssim_map(pred, target, data_range, kernel_size, sigma, k1, k2)
    crop = kernel_size - 1
    m = _valid_mask(smap.shape[2:4], (valid_hw[0] - crop, valid_hw[1] - crop),
                    smap.device).permute(2, 0, 1)
    n = torch.clamp(m.sum(), min=1.0) * smap.shape[0] * smap.shape[1]
    return (smap * m).sum() / n
