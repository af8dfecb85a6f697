"""DIV2K dataset pipeline — pairing, resize rules, LR noise, GAN scaling.

Counterpart of ``tpusr/data/div2k.py`` (reference: dataset.py
get_image_pair :9-62, DIV2KDataset :69-95, GANDIV2KDataset :98-177); the
decode and resize chain runs natively (``tpusr_torch/native``) when the
loader builds, else through PIL, with identical bytes:
  * HR ``<name>.png`` pairs with LR ``<name>x8.png`` (``lr_suffix``: x8,
    the reference's; ``x4`` for DIV2K's x4 LR set);
  * both images are bicubic-shrunk by 2, the LR once more with downsample;
  * HR is resized to exactly scale_factor x LR, or both shrink to the
    largest multiple when that would exceed the original HR in both dims;
  * optional Gaussian / salt-and-pepper noise on the LR from a numpy
    Generator seeded per (seed, index);
  * float32 HWC arrays in [0, 1]; the GAN variant maps HR to [-1, 1] and
    cuts aligned random train patches.
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
    lr_suffix: str = "x8"


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
    """Load one (LR, HR, name) triple; float32 (H, W, 3) arrays in [0,1].

    The decode and resize chain runs through the native loader
    (``tpusr_torch/native``: libpng and Pillow's fixed-point bicubic in
    C++) when it builds, else through PIL; the bytes are identical.
    """
    from tpusr_torch import native

    filename, _ = os.path.splitext(hr_name)
    hr_path = os.path.join(config.HR_dir, hr_name)
    lr_path = os.path.join(config.LR_dir, f"{filename}{config.lr_suffix}.png")
    if native.available():
        lr_np, hr_np = native.load_pair(hr_path, lr_path,
                                        config.scale_factor,
                                        config.downsample)
    else:
        lr_np, hr_np = _pil_pair(config, hr_path, lr_path)

    if config.noise_type is not None:
        if config.noise_type["type"] == "SaltAndPepper":
            lr_np = _add_salt_pepper_noise(rng, lr_np, s=config.noise_type["s"],
                                           p=config.noise_type["p"])
        elif config.noise_type["type"] == "Gaussian":
            lr_np = _add_gaussian_noise(rng, lr_np,
                                        std=config.noise_type["std"])

    return (lr_np.astype(np.float32) / 255.0,
            hr_np.astype(np.float32) / 255.0, filename)


def _pil_pair(config: DatasetConfig, hr_path: str, lr_path: str):
    """The decode and resize chain through PIL: (lr_u8, hr_u8) HWC."""
    hr = Image.open(hr_path).convert("RGB")
    lr = Image.open(lr_path).convert("RGB")

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
    return np.array(lr), np.array(hr)


class DIV2KDataset:
    """dataset.py:69-95 parity; iterable of (LR, HR, name) HWC floats."""

    def __init__(self, LR_dir, scale_factor, downsample=False, noise_type=None,
                 num_images=-1, HR_dir=None, seed=0, lr_suffix="x8"):
        self.config = DatasetConfig(
            LR_dir=LR_dir, HR_dir=HR_dir, scale_factor=scale_factor,
            downsample=downsample, noise_type=noise_type,
            num_images=num_images, seed=seed, lr_suffix=lr_suffix)
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


class GANDIV2KDataset(DIV2KDataset):
    """dataset.py:98-177 parity: SRGAN scaling + aligned train patches."""

    def __init__(self, LR_dir, scale_factor, downsample=False, noise_type=None,
                 num_images=-1, HR_dir=None, LR_patch_size=None, train=False,
                 seed=0, legacy_scale=False, lr_suffix="x8"):
        super().__init__(LR_dir, scale_factor, downsample, noise_type,
                         num_images, HR_dir, seed, lr_suffix)
        self.LR_patch_size = LR_patch_size
        self.train = train
        self.legacy_scale = legacy_scale
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Re-seed patch sampling per epoch (the reference's global
        np.random draws a new crop every __getitem__; explicit here)."""
        self._epoch = epoch

    @staticmethod
    def scale_images(lr, hr, legacy_scale: bool = False):
        """LR stays [0,1], HR -> [-1,1], the intended SRGAN scaling;
        ``legacy_scale=True`` reproduces the reference's second /255
        (dataset.py:149-159)."""
        if legacy_scale:
            return lr / 255.0, (hr / 255.0) * 2.0 - 1.0
        return lr, hr * 2.0 - 1.0

    def get_train_patches(self, lr, hr, rng):
        """Aligned random crop (dataset.py:121-147): LR center uniform in
        the valid range, HR patch = LR patch x factor."""
        lr_h, lr_w = lr.shape[0], lr.shape[1]
        pw, ph = self.LR_patch_size
        f = self.config.scale_factor
        cx = rng.integers(pw // 2, lr_w - pw // 2)
        cy = rng.integers(ph // 2, lr_h - ph // 2)
        left = int(cx - pw // 2)
        top = int(cy - ph // 2)
        lr_patch = lr[top:top + ph, left:left + pw]
        hr_patch = hr[top * f:(top + ph) * f, left * f:(left + pw) * f]
        return lr_patch, hr_patch

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.config.seed, self._epoch, idx))
        lr, hr, name = get_image_pair(self.config, self.HR_images[idx], rng)
        lr, hr = self.scale_images(lr, hr, self.legacy_scale)
        if self.train:
            lr, hr = self.get_train_patches(lr, hr, rng)
        return lr, hr, name

    def base_pair(self, idx):
        """Full (uncropped, unscaled) [0,1] pair, seeded per (seed, idx)."""
        rng = np.random.default_rng((self.config.seed, idx))
        return get_image_pair(self.config, self.HR_images[idx], rng)


def batch_iterator(dataset, batch_size: int, drop_last: bool = False,
                   pad_to_full: bool = False):
    """Minimal batching loader (the reference's DataLoader defaults:
    shuffle=False, drop_last=False; train_GAN.py:175): stacked NHWC numpy
    batches and their names. ``pad_to_full`` wraps the ragged last batch
    with items from the dataset's start, as tpusr does, so every batch has
    ``batch_size`` rows."""
    n = len(dataset)
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        if drop_last and len(idxs) < batch_size:
            return
        if pad_to_full:
            idxs += [i % n for i in range(len(idxs), batch_size)]
        items = [dataset[i] for i in idxs]
        yield (np.stack([it[0] for it in items]),
               np.stack([it[1] for it in items]), [it[2] for it in items])
