"""SRGAN generator and discriminator.

Counterpart of ``tpusr/models/srgan.py`` (reference models/GAN/
generator.py:44-81, discriminator.py:21-74). The generator has the same
module names as tpusr's (``conv1``, ``prelu1``,
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

The discriminator (``conv``, ``block{i}_conv``, ``block{i}_bn``,
``dense1``, ``dense2``, tpusr's names) returns logits; its convs stay on
``F.conv2d``, as tpusr leaves them to XLA. ``dense1`` reads the last
feature map flattened in NHWC (H, W, C) order, as tpusr's does, so the
JAX weight bridge is a transpose; the reference's NCHW order appears only
at .pth import and export (``io/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
from torch import nn

from tpusr_torch.device import resolve_device
from tpusr_torch.models.layers import (BatchNorm, Conv, Dense, PReLU,
                                      leaky_relu, pixel_shuffle)

N_SHUFFLES = {2: 1, 4: 2, 8: 3, 16: 4}
# the discriminator's (channels, stride) after its stem
# (discriminator.py:29-35)
D_SCHEDULE = ((64, 2), (128, 1), (128, 2), (256, 1), (256, 2), (512, 1),
              (512, 2))


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

    # what the engine and the CLI read of the model
    output_range = (-1.0, 1.0)
    eval_only = False
    tiles = True  # spatial tiling and sharding: the halo is this net's

    @staticmethod
    def lr_tag(factor: int) -> str:
        """The DIV2K LR set the eval CLI reads: the reference's x8 set
        whatever the factor."""
        return "x8"

    @classmethod
    def from_config(cls, config, dtype=None, device="cuda", generator=None,
                    **arch):
        """The net a ``GANTrainConfig`` describes (``factor``,
        ``residual_blocks_count``); ``arch`` overrides the other
        constructor arguments."""
        return cls(factor=config.factor,
                   residual_blocks_count=config.residual_blocks_count,
                   dtype=dtype, device=device, generator=generator, **arch)

    @classmethod
    def load(cls, path: str, config, dtype=None, device="cuda"):
        """A reference-named torch .pth (DDP prefixes stripped) or an orbax
        state directory (its ``params_G`` and ``stats_G``, as tpusr reads
        it) -> (the net on ``device``, config). config's
        residual_blocks_count is corrected to what the checkpoint holds,
        with a warning; a pixel-shuffle count that does not fit
        config.factor raises with the factor the model was trained for."""
        from tpusr_torch.io.checkpoint import (import_torch_generator,
                                               infer_generator_arch,
                                               load_torch_state_dict)
        from tpusr_torch.io.orbax import read_tree
        from tpusr_torch.io.weights import load_flax_generator

        n_shuffles = N_SHUFFLES[config.factor]
        if path.endswith(".pth"):
            sd = load_torch_state_dict(path)
            rb, ns = infer_generator_arch(sd)
        else:
            state = read_tree(path)
            rb, ns = infer_generator_arch(state["params_G"])
        if ns != n_shuffles:
            ckpt_factor = {v: k for k, v in N_SHUFFLES.items()}[ns]
            raise ValueError(
                f"{path} holds a x{ckpt_factor} generator ({ns} pixel-"
                f"shuffle blocks) but --factor/--downsample request "
                f"x{config.factor} ({n_shuffles}); rerun with the factor "
                f"the model was trained for")
        if rb != config.residual_blocks_count:
            warnings.warn(
                f"checkpoint has {rb} residual blocks; overriding "
                f"--residual_blocks {config.residual_blocks_count}")
            config = dataclasses.replace(config, residual_blocks_count=rb)
        net = cls.from_config(config, dtype, device)
        if path.endswith(".pth"):
            net.load_state_dict(import_torch_generator(
                sd, residual_blocks_count=rb, n_shuffles=ns))
        else:
            load_flax_generator(net, state["params_G"], state["stats_G"])
        return net, config

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


def disc_feature_hw(n: int) -> int:
    """Side of the discriminator's last feature map for an n x n input: the
    four stride-2 k3 pad-1 convs each map n -> ceil(n / 2) (200 -> 13, not
    n // 16)."""
    for _ in range(4):
        n = (n + 1) // 2
    return n


class Discriminator(nn.Module):
    """SRGAN discriminator over NCHW patches in [-1, 1]; f32 logits (N, 1).

    hr_patch: the square input side, which sizes dense1 (at 192 the last
    map is 12 x 12 x 512 and dense1 holds 75.5 M weights). dtype: None or
    torch.bfloat16 activations. Init: U(+-1/sqrt(fan_in)) from
    ``generator``; BN scale 1, bias 0, running mean 0, var 1.
    """

    def __init__(self, hr_patch: int = 192, dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.conv = Conv(3, 64, 3, **kw)
        cin = 64
        for i, (ch, st) in enumerate(D_SCHEDULE):
            setattr(self, f"block{i}_conv", Conv(cin, ch, 3, stride=st, **kw))
            setattr(self, f"block{i}_bn", BatchNorm(ch))
            cin = ch
        hw = disc_feature_hw(hr_patch)
        self.dense1 = Dense(hw * hw * cin, 1024, **kw)
        self.dense2 = Dense(1024, 1, **kw)
        self.to(dev)

    def forward(self, x, train: bool = True, stat_groups: int = 1, *,
                update_stats: bool = True):
        """train=True normalises with batch statistics (per group of the
        stat_groups stacked along N) and updates the running ones unless
        update_stats is False."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = leaky_relu(self.conv(
            x.contiguous(memory_format=torch.channels_last)))
        for i in range(len(D_SCHEDULE)):
            x = getattr(self, f"block{i}_conv")(x)
            x = getattr(self, f"block{i}_bn")(x, not train,
                                              update_stats=update_stats,
                                              stat_groups=stat_groups)
            x = leaky_relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = leaky_relu(self.dense1(x))
        return self.dense2(x).float()


def discriminator_prob(logits: torch.Tensor) -> torch.Tensor:
    """Sigmoid head of the reference discriminator (discriminator.py:72)."""
    return torch.sigmoid(logits)
