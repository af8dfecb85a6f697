"""Loss functions of the SRGAN engine.

Counterpart of ``tpusr/engine/losses.py``:
  mse                <- torch.nn.MSELoss
  bce_with_logits    <- torch.nn.BCELoss on sigmoid outputs (train_GAN.py:26;
                        the same function in the stable log-sigmoid form)
  adversarial_loss   <- utils/GAN.py:96-98
  discriminator_loss <- utils/GAN.py:101-105
  perceptual_loss    <- utils/GAN.py:108-123 (content + adversarial)

The content term is VGG19 phi_{5,4} feature MSE when weights are given
(``models/vgg19.py``), else pixel MSE.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from tpusr_torch.models.vgg19 import vgg19_features, vgg_preprocess


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean()


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits (stable log-sigmoid)."""
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits)).mean()


def adversarial_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """BCE(fake, ones): the generator wants D to call its output real."""
    return bce_with_logits(fake_logits, torch.ones_like(fake_logits))


def discriminator_loss(real_logits: torch.Tensor,
                       fake_logits: torch.Tensor) -> torch.Tensor:
    """BCE(real, 1) + BCE(fake, 0)."""
    return (bce_with_logits(real_logits, torch.ones_like(real_logits))
            + bce_with_logits(fake_logits, torch.zeros_like(fake_logits)))


def make_content_loss(vgg_params: dict | None) -> Callable:
    """VGG19 phi_{5,4} feature MSE when weights exist, else pixel MSE
    (Vgg19Loss.forward, utils/GAN.py:80-92: both NHWC inputs through the
    ImageNet eval transform, then MSE of the conv5_4 activations)."""
    if vgg_params is None:
        return mse

    def vgg_content(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        fp = vgg19_features(vgg_params, vgg_preprocess(pred))
        ft = vgg19_features(vgg_params, vgg_preprocess(target))
        return mse(fp, ft)

    return vgg_content


def perceptual_loss(content_loss: Callable, fake_images: torch.Tensor,
                    hr_images: torch.Tensor, fake_logits: torch.Tensor,
                    adv_weight: float = 1.0) -> torch.Tensor:
    """content + adv_weight * adversarial (utils/GAN.py:113-123). 1.0 is
    the reference's unweighted sum; 1e-3 the SRGAN paper's coefficient."""
    return (content_loss(fake_images, hr_images)
            + adv_weight * adversarial_loss(fake_logits))
