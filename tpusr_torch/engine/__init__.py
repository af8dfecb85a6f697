"""tpusr_torch.engine."""

from tpusr_torch.engine.dip import DIPConfig, dip_superresolve
from tpusr_torch.engine.gan import (GANTrainConfig, GANTrainState,
                                    create_gan_state, gan_train_step)
from tpusr_torch.engine.metrics import psnr, ssim

__all__ = [
    "psnr",
    "ssim",
    "DIPConfig",
    "dip_superresolve",
    "GANTrainConfig",
    "GANTrainState",
    "create_gan_state",
    "gan_train_step",
]
