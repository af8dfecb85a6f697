"""SRGAN engine: the configuration and the generator's eval forward.

Counterpart of ``tpusr/engine/gan.py`` as far as evaluation needs it
(reference eval_GAN.py:21-69). ``GANTrainConfig`` carries every field and
default of the JAX package's config as data, the training ones included,
so the two CLIs build the same configuration; the training step waits for
the training slice.
"""

from __future__ import annotations

import dataclasses
import os as _os

import torch

from tpusr_torch.models.srgan import Generator

# Defaults seeded from the environment once, at import, as tpusr does
# (gan.py:39-50); in-process callers use dataclasses.replace on the config.
_D_CONCAT_DEFAULT = _os.environ.get("TPUSR_D_CONCAT", "1") != "0"
_G_FUSE_DEFAULT = {"0": "off", "train": "train"}.get(
    _os.environ.get("TPUSR_G_FUSE", "1"), "eval")
_D_MOMENTS_DEFAULT = _os.environ.get("TPUSR_D_MOMENTS", "bf16")
_D_PARAMS_DEFAULT = _os.environ.get(
    "TPUSR_D_PARAMS", "bf16" if _D_MOMENTS_DEFAULT == "bf16" else "f32")


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    """train_GAN.py defaults (:216-219, :169, :270), as tpusr's config."""

    factor: int = 8
    batch_size: int = 8
    hr_patch: int = 192
    pre_train_epochs: int = 8000
    fine_tune_epochs: int = 4000
    pre_train_lr: float = 1e-4
    fine_tune_lr: float = 1e-5
    residual_blocks_count: int = 16
    legacy_detach: bool = False  # reproduce train_GAN.py:58 exactly
    legacy_scale: bool = False  # the reference's double-/255 scaling
    content: str = "auto"  # 'auto' | 'vgg' | 'mse'
    dtype: str | None = None  # 'bfloat16' activations (params stay f32)
    adv_weight: float = 1.0
    d_concat: bool = _D_CONCAT_DEFAULT
    # kernel-A routing of the generator's 3x3 convs: 'eval' (default) fuses
    # the eval forward only, 'train' the training forward too, 'off' none
    g_fuse: str = _G_FUSE_DEFAULT
    conv_fusion: str = "auto"  # 'auto' | 'off'
    d_moments: str = _D_MOMENTS_DEFAULT  # 'bf16' | 'f32'
    d_params: str = _D_PARAMS_DEFAULT  # 'f32' | 'bf16'


def torch_dtype(config: GANTrainConfig) -> torch.dtype | None:
    """The Generator's activation dtype for ``config.dtype``."""
    if config.dtype in (None, "float32"):
        return None
    if config.dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"dtype {config.dtype!r} not in float32/bfloat16")


def build_generator(config: GANTrainConfig, device="cuda",
                    generator: torch.Generator | None = None) -> Generator:
    """The Generator ``config`` describes, on ``device``."""
    return Generator(factor=config.factor,
                     residual_blocks_count=config.residual_blocks_count,
                     dtype=torch_dtype(config), device=device,
                     generator=generator)


def generator_forward(generator: Generator, lr_images: torch.Tensor,
                      config: GANTrainConfig,
                      train: bool = False) -> torch.Tensor:
    """Full-image generator inference (eval_GAN.py:44) over NHWC images.

    ``train=False`` normalises with the running BN statistics (the
    reference calls gan_G.eval(), eval_GAN.py:94) and sends the 3x3 convs
    through kernel A unless ``config.g_fuse == 'off'``; ``train=True`` uses
    batch statistics, discards their update, and fuses only under
    ``g_fuse == 'train'`` (tpusr's gan.py:367-397). ``conv_fusion='off'``
    keeps every conv on ``F.conv2d`` whatever g_fuse says. Precision in
    f32: kernel A multiplies in full f32; the convs left to cuDNN (the two
    9x9 ones, and the 3x3 ones when unfused) follow PyTorch's setting,
    TF32 by default, as XLA's default precision rounds the reference's f32
    convs on the TPU (to bf16 there). Returns NHWC f32 in [-1, 1].
    """
    if config.conv_fusion not in ("auto", "off"):
        raise ValueError(f"conv_fusion {config.conv_fusion!r} not in "
                         f"auto/off")
    fuse = (config.g_fuse == "train") if train else (config.g_fuse != "off")
    x = lr_images.permute(0, 3, 1, 2)  # NHWC memory = channels_last NCHW
    y = generator(x, train, fuse=fuse and config.conv_fusion == "auto",
                  update_stats=False)
    return y.permute(0, 2, 3, 1)
