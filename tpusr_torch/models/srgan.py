"""SRGAN generator, the model of ``cli/eval_gan.py``.

Counterpart of ``tpusr/models/srgan.py`` (reference models/GAN/
generator.py:44-81) with the same module names (``conv1``, ``prelu1``,
``res{i}``, ``conv2``, ``bn1``, ``ps{i}``, ``conv3``), so weights map one to
one (``tpusr_torch.io.weights.load_flax_generator``, and the reference's
.pth names through ``tpusr_torch.io.checkpoint``):

  conv 9x9 3->64 + PReLU -> n x [conv3x3, BN, PReLU, conv3x3, BN, + x]
  -> conv3x3 + BN + long skip -> per octave [conv3x3 64->256,
  PixelShuffle(2), PReLU] -> conv 9x9 64->3 -> tanh

At x8 with 16 residual blocks this is 1,697,175 parameters. Activations
are NCHW tensors in channels_last memory, so kernel A sees NHWC with no
copy. The 3x3 convs run through kernel A (``ops/fused_conv.py``, zero
padding, no prologue) when fused; the two 9x9 convs stay on ``F.conv2d``,
as the JAX package leaves them to XLA. ``dtype=torch.bfloat16`` computes
activations in bf16 with f32 parameters; the output is f32 in [-1, 1].
The discriminator waits for the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from tpusr_torch.device import resolve_device
from tpusr_torch.models.layers import BatchNorm, Conv, PReLU, pixel_shuffle

N_SHUFFLES = {2: 1, 4: 2, 8: 3, 16: 4}


class ResidualBlock(nn.Module):
    """conv k3 -> BN -> PReLU -> conv k3 -> BN -> + x (generator.py:4-25)."""

    def __init__(self, dtype=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = Conv(64, 64, 3, **kw)
        self.bn1 = BatchNorm(64)
        self.prelu1 = PReLU()
        self.conv2 = Conv(64, 64, 3, **kw)
        self.bn2 = BatchNorm(64)

    def forward(self, x, train: bool = False, fuse: bool = False,
                update_stats: bool = True):
        z = self.bn1(self.conv1(x, fuse=fuse), not train,
                     update_stats=update_stats)
        z = self.prelu1(z)
        z = self.bn2(self.conv2(z, fuse=fuse), not train,
                     update_stats=update_stats)
        return x + z


class PixelShuffleBlock(nn.Module):
    """conv 64->256 k3 -> PixelShuffle(2) -> PReLU (generator.py:27-41)."""

    def __init__(self, dtype=None, generator=None):
        super().__init__()
        self.conv1 = Conv(64, 256, 3, dtype=dtype, generator=generator)
        self.prelu1 = PReLU()

    def forward(self, x, fuse: bool = False):
        return self.prelu1(pixel_shuffle(self.conv1(x, fuse=fuse), 2))


class Generator(nn.Module):
    """SRGAN generator. Input NCHW RGB in [0, 1]; output f32 in [-1, 1].

    factor: 2, 4, 8 or 16 (1 to 4 pixel-shuffle blocks). dtype: None (the
    input's) or torch.bfloat16. device: 'cuda' (default; raises without a
    card) or 'cpu'. The module holds no routing: ``forward(fuse=True)``
    sends the 3x3 convs through kernel A, and ``engine/gan.py::
    generator_forward`` decides ``fuse`` from the config. Init:
    U(+-1/sqrt(fan_in)) from ``generator``; BN scale 1, bias 0, running
    mean 0, var 1; PReLU slopes 0.25.
    """

    def __init__(self, factor: int = 8, residual_blocks_count: int = 16,
                 dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if factor not in N_SHUFFLES:
            raise ValueError(f"factor {factor} not in {sorted(N_SHUFFLES)}")
        dev = resolve_device(device)
        self.dtype = dtype
        self.blocks, self.shuffles = residual_blocks_count, N_SHUFFLES[factor]
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = Conv(3, 64, 9, dtype=dtype, generator=generator)
        self.prelu1 = PReLU()
        for i in range(self.blocks):
            setattr(self, f"res{i}", ResidualBlock(**kw))
        self.conv2 = Conv(64, 64, 3, **kw)
        self.bn1 = BatchNorm(64)
        for i in range(self.shuffles):
            setattr(self, f"ps{i}", PixelShuffleBlock(**kw))
        self.conv3 = Conv(64, 3, 9, dtype=dtype, generator=generator)
        self.to(dev)

    def forward(self, x, train: bool = False, *, fuse: bool = False,
                update_stats: bool = True):
        """train=False normalises with the running statistics; train=True
        with the batch's, updating the running ones unless update_stats is
        False. fuse sends the 3x3 convs through kernel A."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x0 = self.prelu1(self.conv1(
            x.contiguous(memory_format=torch.channels_last)))
        z = x0
        for i in range(self.blocks):
            z = getattr(self, f"res{i}")(z, train, fuse, update_stats)
        z = self.bn1(self.conv2(z, fuse=fuse), not train,
                     update_stats=update_stats)
        z = x0 + z  # long skip (generator.py:74)
        for i in range(self.shuffles):
            z = getattr(self, f"ps{i}")(z, fuse)
        return torch.tanh(self.conv3(z).float())
