"""DIV2K dataset pipeline for DIP — pairing, resize rules, LR noise.

Counterpart of ``tpusr/data/div2k.py`` (reference: dataset.py
get_image_pair :9-62, DIV2KDataset :69-95) on its PIL path:
  * HR ``<name>.png`` pairs with LR ``<name>x8.png``;
  * both images are bicubic-shrunk by 2, the LR once more with downsample;
  * HR is resized to exactly scale_factor x LR, or both shrink to the
    largest multiple when that would exceed the original HR in both dims;
  * optional Gaussian / salt-and-pepper noise on the LR from a numpy
    Generator seeded per (seed, index);
  * float32 HWC arrays in [0, 1].
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
from PIL import Image


@dataclasses.dataclass
class DatasetConfig:
    LR_dir: str
    HR_dir: str
    scale_factor: int
    downsample: bool = False
    noise_type: dict | None = None
    num_images: int = -1
    seed: int = 0


def _pil_shrink(img: Image.Image, factor: int = 2) -> Image.Image:
    """utils/degradation.py:19-20 parity (floor-div size, bicubic)."""
    return img.resize((img.width // factor, img.height // factor),
                      resample=Image.BICUBIC)


def _add_gaussian_noise(rng: np.random.Generator, image: np.ndarray,
                        std: float) -> np.ndarray:
    out = np.clip(image + rng.normal(scale=std * 255, size=image.shape),
                  0, 255)
    return out.astype(np.uint8)


def _add_salt_pepper_noise(rng: np.random.Generator, image: np.ndarray,
                           s: float, p: float) -> np.ndarray:
    salt = rng.random((image.shape[0], image.shape[1])) < s
    pepper = rng.random((image.shape[0], image.shape[1])) < p
    image = image.copy()
    image[salt] = 255
    image[pepper] = 0
    return image


def get_image_pair(config: DatasetConfig, hr_name: str,
                   rng: np.random.Generator):
    """Load one (LR, HR, name) triple; float32 (H, W, 3) arrays in [0,1]."""
    filename, _ = os.path.splitext(hr_name)
    hr = Image.open(os.path.join(config.HR_dir, hr_name)).convert("RGB")
    lr = Image.open(os.path.join(config.LR_dir,
                                 f"{filename}x8.png")).convert("RGB")

    lr = _pil_shrink(lr, 2)
    hr = _pil_shrink(hr, 2)
    if config.downsample:
        lr = _pil_shrink(lr, 2)

    w_lr, h_lr = lr.size
    w_hr = config.scale_factor * w_lr
    h_hr = config.scale_factor * h_lr
    if w_hr > hr.size[0] and h_hr > hr.size[1]:
        w_hr = (hr.size[0] // config.scale_factor) * config.scale_factor
        h_hr = (hr.size[1] // config.scale_factor) * config.scale_factor
        w_lr = w_hr // config.scale_factor
        h_lr = h_hr // config.scale_factor
        hr = hr.resize((w_hr, h_hr), Image.BICUBIC)
        lr = lr.resize((w_lr, h_lr), Image.BICUBIC)
    else:
        hr = hr.resize((w_hr, h_hr), Image.BICUBIC)
    lr_np = np.array(lr)
    hr_np = np.array(hr)

    if config.noise_type is not None:
        if config.noise_type["type"] == "SaltAndPepper":
            lr_np = _add_salt_pepper_noise(rng, lr_np, s=config.noise_type["s"],
                                           p=config.noise_type["p"])
        elif config.noise_type["type"] == "Gaussian":
            lr_np = _add_gaussian_noise(rng, lr_np,
                                        std=config.noise_type["std"])

    return (lr_np.astype(np.float32) / 255.0,
            hr_np.astype(np.float32) / 255.0, filename)


class DIV2KDataset:
    """dataset.py:69-95 parity; iterable of (LR, HR, name) HWC floats."""

    def __init__(self, LR_dir, scale_factor, downsample=False, noise_type=None,
                 num_images=-1, HR_dir=None, seed=0):
        self.config = DatasetConfig(
            LR_dir=LR_dir, HR_dir=HR_dir, scale_factor=scale_factor,
            downsample=downsample, noise_type=noise_type,
            num_images=num_images, seed=seed)
        self.HR_images = sorted(os.listdir(HR_dir))
        if num_images > 0:
            self.HR_images = self.HR_images[:num_images]

    def __len__(self):
        return len(self.HR_images)

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.config.seed, idx))
        return get_image_pair(self.config, self.HR_images[idx], rng)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
