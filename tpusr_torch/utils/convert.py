"""Layout converters at the host/device boundary (parity:
utils/common.py:62-102; counterpart of ``tpusr/utils/convert.py``).

Images cross the port's entry points as NHWC, as in the JAX package;
these helpers move host arrays to a device and back, with the device
named explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusr_torch.device import resolve_device


def hwc_to_chw(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(np.asarray(x), -1, -3)


def chw_to_hwc(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(np.asarray(x), -3, -1)


def np_to_device(x: np.ndarray, dtype: torch.dtype | None = torch.float32,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """Host HWC/NHWC array -> tensor on ``device`` (adds the batch dim if
    absent). dtype=None keeps the input's dtype (uint8 payloads that the
    engines normalise on the device move 4x fewer bytes)."""
    t = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    if dtype is not None:
        t = t.to(dtype)
    return t[None] if t.dim() == 3 else t


def device_to_np(x: torch.Tensor) -> np.ndarray:
    """NHWC tensor -> host HWC array (drops a singleton batch dim)."""
    arr = x.detach().cpu().numpy()
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    return arr
