"""Exact tiled full-image SR inference on one card.

Port of the one-device half of ``tpusr/parallel/spatial.py``
(``generator_receptive_halo``, ``tiled_generator_forward``; the
multi-device ``sharded_generator_forward`` is not ported). The LR image is
split along H into ``n_tiles`` cores; each core is read with ``halo`` rows
of context as a window of one uniform size clamped inside the image (an
edge window shifts inward, so the true image edges keep the per-layer zero
padding of a whole-image forward). The windows run as one batch through
``generator_forward`` and the upscaled cores are cut out and concatenated.
Exact when the halo covers the generator's LR receptive field.
"""

from __future__ import annotations

import torch

from tpusr_torch.engine.gan import GANTrainConfig, generator_forward


def generator_receptive_halo(config: GANTrainConfig) -> int:
    """LR-domain halo covering the pre-upsample receptive field, padded."""
    return 2 * config.residual_blocks_count + 16


def tiled_generator_forward(generator, lr_image: torch.Tensor,
                            config: GANTrainConfig, n_tiles: int = 4,
                            halo: int | None = None) -> torch.Tensor:
    """lr_image (1, H, W, 3) NHWC -> (1, H*f, W*f, 3), as the whole-image
    ``generator_forward(generator, lr_image, config)``."""
    if halo is None:
        halo = generator_receptive_halo(config)
    _, h, w, _ = lr_image.shape
    f = config.factor
    core = -(-h // n_tiles)
    window = min(h, core + 2 * halo)

    windows, cores = [], []
    for i in range(n_tiles):
        c0 = i * core
        if c0 >= h:
            break  # h < n_tiles * core: the image is covered already
        c1 = min(c0 + core, h)
        w0 = min(max(c0 - halo, 0), h - window)
        windows.append(lr_image[0, w0:w0 + window])
        cores.append((c0 - w0, c1 - c0))

    out = generator_forward(generator, torch.stack(windows), config,
                            train=False)
    return torch.cat([out[i, off * f:(off + n) * f]
                      for i, (off, n) in enumerate(cores)])[None]
