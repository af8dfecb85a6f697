"""On-device multi-epoch SRGAN trainer.

Counterpart of ``tpusr/engine/gan_epochs.py``. The reference crops patches
per sample on the host (train_GAN.py:38-71, dataset.py:121-147); here the
uint8 image stacks are uploaded once and stay on the card, and each step's
aligned patch pairs are cut there from offsets drawn with a
``torch.Generator`` on the device.

Batch semantics as tpusr's: images are visited in fixed order in batches
of ``config.batch_size`` (the reference's DataLoader, shuffle=False); the
stack is a multiple of the batch size (``stack_dataset_for_device`` pads
by wrapping). Metrics (PSNR, SSIM, LPIPS or NaN) come from a train-mode
``generator_forward`` on each step's patches in the chunk's first epoch,
which callers align with the reference's ``epoch % log_freq == 0``.
Data parallelism (tpusr's ``mesh``) comes in as the step and the metrics
forward that ``parallel/gan_dp.py`` builds for a mesh: every rank draws
the crops of the whole global batch from the shared generator and hands
them to that step, which trains on the rank's slice, so the ranks see the
patches one device would; the metrics forward uses the global batch
statistics too and scores the gathered global batch. The call, each
step's crop and step and epoch 0's metrics are spans (utils/profiling.py)
opened by the loop, around whatever ``step_fn`` runs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpusr_torch.engine import losses as L
from tpusr_torch.engine.gan import (GANTrainConfig, GANTrainState,
                                    gan_train_step, generator_forward)
from tpusr_torch.engine.metrics import psnr as psnr_fn
from tpusr_torch.engine.metrics import ssim as ssim_fn
from tpusr_torch.utils.profiling import span


def draw_offsets(valid_lr: torch.Tensor, lr_patch: int,
                 generator: torch.Generator) -> tuple[torch.Tensor, ...]:
    """(top, left) of B LR patches, each uniform in [0, max(valid -
    patch, 1)) (dataset.py:128-141: the reference's randint(p // 2,
    v - p // 2) centre). valid_lr: (B, 2) int (rows, columns)."""
    high = torch.clamp(valid_lr - lr_patch, min=1).to(torch.float64)
    u = torch.rand(valid_lr.shape, generator=generator,
                   device=valid_lr.device, dtype=torch.float64)
    off = (u * high).long()
    return off[:, 0], off[:, 1]


def crop_at(lr_u8: torch.Tensor, hr_u8: torch.Tensor, top: torch.Tensor,
            left: torch.Tensor, lr_patch: int, factor: int,
            legacy_scale: bool = False):
    """Aligned patch pairs at the given LR offsets, one gather each: LR
    (B, p, p, 3) in [0, 1], HR (B, p f, p f, 3) in [-1, 1]
    (GANDIV2KDataset.scale_images, dataset.py:149-159; legacy_scale
    reproduces the reference's second /255)."""
    b = torch.arange(lr_u8.shape[0], device=lr_u8.device)[:, None, None]

    def gather(img, t, l, p):
        r = torch.arange(p, device=img.device)
        return img[b, (t[:, None] + r)[:, :, None],
                   (l[:, None] + r)[:, None, :]]

    lr_f = gather(lr_u8, top, left, lr_patch).float() / 255.0
    hr_f = gather(hr_u8, top * factor, left * factor,
                  lr_patch * factor).float() / 255.0
    if legacy_scale:
        lr_f = lr_f / 255.0
        hr_f = hr_f / 255.0
    return lr_f, hr_f * 2.0 - 1.0


def _crop_pair(lr_u8, hr_u8, valid_lr, generator, lr_patch: int,
               factor: int, legacy_scale: bool = False):
    """A batch of aligned random patch pairs from padded uint8 images
    (tpusr's ``_crop_pair`` over the batch)."""
    top, left = draw_offsets(valid_lr, lr_patch, generator)
    return crop_at(lr_u8, hr_u8, top, left, lr_patch, factor, legacy_scale)


def gan_train_epochs(state: GANTrainState, lr_images_u8: torch.Tensor,
                     hr_images_u8: torch.Tensor, valid_lr: torch.Tensor,
                     generator: torch.Generator, config: GANTrainConfig,
                     content_loss: Callable = L.mse, n_epochs: int = 1,
                     lpips_fn: Callable | None = None,
                     step_fn: Callable | None = None,
                     forward_fn: Callable | None = None):
    """Run ``n_epochs`` epochs on the device.

    lr_images_u8 (N, lh, lw, 3) and hr_images_u8 (N, lh f, lw f, 3) uint8,
    padded; valid_lr (N, 2) the true LR sizes; all on one device, with
    ``generator``. Returns (state, logs): losses_D / losses_G (n_epochs,
    steps) tensors on the device, and psnr / ssim / lpips, the means over
    the first epoch's steps (lpips NaN without ``lpips_fn``).
    ``step_fn(state, lr_p, hr_p)`` and ``forward_fn(state, lr_p)`` replace
    ``gan_train_step`` and the metrics' train-mode forward; for data
    parallelism they are ``parallel.gan_dp``'s ``make_dp_train_step`` step
    and ``make_dp_forward``, each rank holds the same stacks, state and
    generator seed, and the losses are the ranks' means.
    """
    if step_fn is None:
        def step_fn(st, lr_p, hr_p):
            return gan_train_step(st, lr_p, hr_p, config, content_loss)
    if forward_fn is None:
        def forward_fn(st, lr_p):
            return generator_forward(st.G, lr_p, config, train=True)
    n = lr_images_u8.shape[0]
    b = config.batch_size
    if n % b:
        raise ValueError("image stack must be a multiple of the batch size")
    steps = n // b
    f = config.factor
    lr_patch = config.hr_patch // f
    losses_d, losses_g, metrics = [], [], []
    with span("gan.call", epochs=n_epochs, steps=steps):
        for epoch in range(n_epochs):
            for s in range(steps):
                sl = slice(s * b, (s + 1) * b)
                with span("gan.crop"):
                    lr_p, hr_p = _crop_pair(
                        lr_images_u8[sl], hr_images_u8[sl], valid_lr[sl],
                        generator, lr_patch, f, config.legacy_scale)
                with span("gan.step", state=state):
                    state, losses = step_fn(state, lr_p, hr_p)
                losses_d.append(losses["loss_D"])
                losses_g.append(losses["loss_G"])
                if epoch == 0:
                    with span("gan.metrics"), torch.no_grad():
                        out = forward_fn(state, lr_p)
                        metrics.append(torch.stack([
                            psnr_fn(out, hr_p),
                            ssim_fn(out, hr_p, data_range=1.0),
                            lpips_fn(out, hr_p) if lpips_fn is not None
                            else torch.tensor(float("nan"),
                                              device=out.device)]))
        m = torch.stack(metrics).mean(0)
        logs = {"losses_D": torch.stack(losses_d).view(n_epochs, steps),
                "losses_G": torch.stack(losses_g).view(n_epochs, steps),
                "psnr": m[0], "ssim": m[1], "lpips": m[2]}
    return state, logs


def stack_dataset_for_device(dataset, batch_size: int):
    """Decode the whole dataset once (host) into padded uint8 stacks.

    Returns numpy (lr_u8 (N, lh, lw, 3), hr_u8, valid_lr (N, 2) int32),
    N padded to a multiple of batch_size by wrapping; float images in
    [0, 1] are quantised by rint(255 x), as tpusr does.
    """
    items = [dataset.base_pair(i) if hasattr(dataset, "base_pair")
             else dataset[i] for i in range(len(dataset))]
    f = items[0][1].shape[0] // items[0][0].shape[0]
    lh = max(it[0].shape[0] for it in items)
    lw = max(it[0].shape[1] for it in items)
    n = len(items)
    total = n + (-n) % batch_size
    lr_out = np.zeros((total, lh, lw, 3), np.uint8)
    hr_out = np.zeros((total, lh * f, lw * f, 3), np.uint8)
    valid = np.zeros((total, 2), np.int32)

    def quantize_into(dst, img):
        if img.dtype != np.uint8:
            img = np.rint(img * np.float32(255.0))
        dst[: img.shape[0], : img.shape[1]] = img

    for j in range(total):
        lr_img, hr_img, _ = items[j if j < n else j - n]
        quantize_into(lr_out[j], lr_img)
        quantize_into(hr_out[j], hr_img)
        valid[j] = (lr_img.shape[0], lr_img.shape[1])
    return lr_out, hr_out, valid
