"""LPIPS (AlexNet variant), the learned perceptual metric of the CLIs.

Counterpart of ``tpusr/models/lpips.py`` (reference: torchmetrics'
LPIPS(net_type='alex'), DIP.py:159, eval_GAN.py:32): AlexNet features at
the five ReLU stages, per-channel unit normalisation, learned 1x1 linear
heads, spatial mean, sum over stages. Images are NHWC in [-1, 1] at the
public functions, as in tpusr.

The pretrained weights cannot be fetched here. ``TPUSR_LPIPS_WEIGHTS``
names an npz in tpusr's layout (``conv{k}.kernel`` HWIO, ``conv{k}.bias``,
``lin{i}.kernel``), which tools/convert_torch_weights.py writes. Without
one ``make_lpips()`` returns None and the CLIs log LPIPS as NaN, as tpusr
does. Plain PyTorch: no kernel.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

LPIPS_WEIGHTS_ENV = "TPUSR_LPIPS_WEIGHTS"

# AlexNet feature stack: (name, out_ch, kernel, stride, pad); maxpool(3, 2)
# after conv1 and conv2. The ReLU taps feed the LPIPS heads.
_ALEX_CONVS = [
    ("conv1", 64, 11, 4, 2),
    ("conv2", 192, 5, 1, 2),
    ("conv3", 384, 3, 1, 1),
    ("conv4", 256, 3, 1, 1),
    ("conv5", 256, 3, 1, 1),
]
_POOL_AFTER = {"conv1", "conv2"}

# LPIPS input scaling layer constants (from the lpips package).
_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)


def alexnet_taps(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """The five post-ReLU feature maps (NCHW) of an NCHW input. Conv
    weights in ``params`` are OIHW."""
    taps = []
    for name, _, _, stride, pad in _ALEX_CONVS:
        x = F.conv2d(x, params[name]["weight"].to(x.dtype),
                     params[name]["bias"].to(x.dtype), stride=stride,
                     padding=pad)
        x = torch.clamp(x, min=0.0)
        taps.append(x)
        if name in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return taps


def lpips_distance(params: dict, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """LPIPS(x, y) for NHWC images in [-1, 1], averaged over the batch."""
    shift = torch.as_tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.as_tensor(_SCALE, dtype=x.dtype, device=x.device)
    xs = ((x - shift) / scale).permute(0, 3, 1, 2)
    ys = ((y - shift) / scale).permute(0, 3, 1, 2)
    total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i, (fx, fy) in enumerate(zip(alexnet_taps(params, xs),
                                     alexnet_taps(params, ys))):
        # lpips.normalize_tensor: feat / (||feat||_C + eps), eps outside
        # the sqrt
        nx = fx / (torch.sqrt(fx.square().sum(1, keepdim=True)) + 1e-10)
        ny = fy / (torch.sqrt(fy.square().sum(1, keepdim=True)) + 1e-10)
        lin = params[f"lin{i}"]["kernel"].to(x.dtype).view(1, -1, 1, 1)
        total = total + ((nx - ny).square() * lin).sum(1).mean((1, 2))
    return total.mean()


def load_lpips_npz(path: str, device="cpu") -> dict:
    """tpusr's LPIPS npz -> {name: {'weight' OIHW, 'bias'} | {'kernel'}}."""
    data = np.load(path)
    params = {}
    for name, *_ in _ALEX_CONVS:
        params[name] = {
            "weight": torch.from_numpy(np.ascontiguousarray(
                data[f"{name}.kernel"].transpose(3, 2, 0, 1))).to(device),
            "bias": torch.from_numpy(data[f"{name}.bias"]).to(device),
        }
    for i in range(5):
        params[f"lin{i}"] = {
            "kernel": torch.from_numpy(data[f"lin{i}.kernel"]).to(device)}
    return params


def make_lpips() -> Callable | None:
    """lpips(x, y) over NHWC tensors if ``TPUSR_LPIPS_WEIGHTS`` names an
    npz, else None. The weights follow the images to their device."""
    path = os.environ.get(LPIPS_WEIGHTS_ENV, "")
    if not (path and os.path.exists(path)):
        return None
    params = {"cpu": load_lpips_npz(path)}

    def lpips(x, y):
        dev = str(x.device)
        if dev not in params:
            params[dev] = {n: {k: v.to(x.device) for k, v in p.items()}
                           for n, p in params["cpu"].items()}
        return lpips_distance(params[dev], x, y)

    return lpips
