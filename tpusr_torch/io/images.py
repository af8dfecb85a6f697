"""Image persistence — parity with utils/common.py:20-33.

A copy of tpusr/io/images.py, so the port writes the same PNG tree.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def save_image(image: np.ndarray, image_name: str, out_dir: str) -> str:
    """Save an HWC uint8 (or [0,1] float) array as <out_dir>/images/<name>.png."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    path = os.path.join(img_dir, f"{image_name}.png")
    Image.fromarray(arr).save(path)
    print(f"Saved to {path}")
    return path


def to_uint8(x: np.ndarray, from_range: str = "01") -> np.ndarray:
    """NHWC/HWC float -> HWC uint8. from_range '01' or 'pm1' (tanh output).

    The reference saves tanh output with a bare *255 cast (eval_GAN.py:53-55)
    — that clamps negatives to wrap; we map [-1,1] -> [0,1] first (documented
    fix, SURVEY.md §7 behavior catalog).
    """
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[0]
    if from_range == "pm1":
        x = (x + 1.0) / 2.0
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)
