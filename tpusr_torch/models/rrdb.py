"""RRDB (ESRGAN-scale) generator, the BASELINE config-5 model.

Counterpart of ``tpusr/models/rrdb.py`` with the same module and parameter
names, so weights map one to one (``tpusr_torch.io.weights.
load_flax_rrdbnet``):

  conv_first -> nb x RRDB (3 dense blocks each: 5 convs, growth gc,
  residual scaling 0.2) -> trunk_conv + long skip -> [nearest x2 + upconv
  + lrelu] per octave -> conv_hr + lrelu -> conv_last

At nf=64, nb=23, gc=32, x4 this is 16,697,987 parameters. Activations are
NCHW tensors in channels_last memory, so the kernels see NHWC with no copy.

``fusion='auto'`` routes as the JAX package does: at nf 64 / gc 32 every
dense block is one launch of kernel C (``ops/dense_block.py``: wgmma in
bf16 on 16 x 16 tiles, 3xTF32 mma.sync in f32 on 8 x 8 tiles, c1..c4 in
shared memory; ``forward`` packs the weight units of all its blocks anew
in a few batched operations, as the JAX package repacks per call); other
widths run each dense-block conv through kernel A (``ops/fused_conv.py``,
zero padding); trunk_conv, the upconvs and conv_hr go through kernel A.
On a CPU tensor both kernels run their plain versions. ``fusion='off'``
is the unfused dataflow on ``F.conv2d``; ``'auto'`` defers to
TPUSR_CONV_FUSION, read at import (``layers.fusion_mode``).

Spans (``utils/profiling.span``; the shared no-op while spans are off):
``rrdb.pack`` (on a card, where the units are packed; fields ``blocks``,
the dense blocks packed, and ``bytes``, their units' size), ``rrdb.trunk``
(``blocks``, the RRDBs) and ``rrdb.upsample`` (``octaves``, the x2
stages), each inside the forward.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tpusr_torch.device import resolve_device
from tpusr_torch.models.layers import (Conv, _nchw, _nhwc, _uniform,
                                      activation, fusion_mode,
                                      nearest_conv_tail)
from tpusr_torch.ops.dense_block import dense_block, packed_weights
from tpusr_torch.ops.fused_conv import fused_conv3x3
from tpusr_torch.utils.profiling import span


def _conv3(x, kernel, fusion: str):
    """Dense-block 3x3 zero-SAME conv of NCHW x with an HWIO kernel: kernel
    A when fusion is on, ``F.conv2d`` otherwise."""
    if fusion != "off":
        return _nchw(fused_conv3x3(_nhwc(x), kernel.contiguous(),
                                   pad_mode="zero"))
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), padding=1)


_lrelu = activation("LeakyReLU")


class DenseBlock(nn.Module):
    """5-conv dense block with growth gc and 0.2 residual scaling.

    Parameters ``conv{k}_kernel`` (HWIO (3, 3, nf + (k-1) gc, gc | nf), the
    layout kernel C reads) and ``conv{k}_bias``, U(+-1/sqrt(9 cin)). At
    nf 64 / gc 32 with fusion on, the block is one kernel-C launch; else it
    runs the concat form, each conv through ``_conv3``.
    """

    def __init__(self, nf: int = 64, gc: int = 32,
                 dtype: torch.dtype | None = None, fusion: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.fusion = dtype, fusion_mode(fusion)
        self.kernel_c = self.fusion != "off" and (nf, gc) == (64, 32)
        for k in range(1, 6):
            cin = nf + (k - 1) * gc
            cout = gc if k < 5 else nf
            setattr(self, f"conv{k}_kernel",
                    _uniform((3, 3, cin, cout), 9 * cin, generator))
            setattr(self, f"conv{k}_bias", _uniform((cout,), 9 * cin,
                                                     generator))

    def kernels(self):
        return [getattr(self, f"conv{k}_kernel") for k in range(1, 6)]

    def forward(self, x, packed=None):
        """packed: this block's units from ``packed_weights`` in the
        activations' dtype, or None to pack them in kernel C's wrapper."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        kernels = self.kernels()
        biases = [getattr(self, f"conv{k}_bias") for k in range(1, 6)]
        if self.kernel_c:
            return _nchw(dense_block(_nhwc(x), kernels, biases, packed))
        feats = [x]
        for k, (w, b) in enumerate(zip(kernels, biases), 1):
            c = (_conv3(torch.cat(feats, 1), w.to(x.dtype), self.fusion)
                 + b.to(x.dtype).view(1, -1, 1, 1))
            feats.append(_lrelu(c) if k < 5 else c)
        return x + 0.2 * feats[-1]


class RRDB(nn.Module):
    """Three dense blocks and a 0.2-scaled residual."""

    def __init__(self, nf: int = 64, gc: int = 32,
                 dtype: torch.dtype | None = None, fusion: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        for j in range(1, 4):
            setattr(self, f"rdb{j}", DenseBlock(nf, gc, dtype, fusion,
                                                generator))

    def forward(self, x, packed=None):
        """packed: (3, units), the rows of rdb1..rdb3, or None."""
        out = x
        for j in range(3):
            out = getattr(self, f"rdb{j + 1}")(
                out, None if packed is None else packed[j])
        return torch.add(x, out, alpha=0.2)


class RRDBNet(nn.Module):
    """ESRGAN generator. Input NCHW RGB in [0, 1]; output f32, unbounded.

    dtype: None (the input's) or torch.bfloat16 (bf16 activations, f32
    parameters, f32 output). fusion: 'auto' | 'off'. device: 'cuda'
    (default; raises without a card) or 'cpu'. Init: U(+-1/sqrt(fan_in))
    from ``generator``.
    """

    # what the engine and the CLI read of the model
    output_range = (0.0, 1.0)
    eval_only = True
    tiles = False  # the spatial paths' halo is SRGAN's

    @staticmethod
    def lr_tag(factor: int) -> str:
        return f"x{factor}"

    @classmethod
    def from_config(cls, config, dtype=None, device="cuda", generator=None,
                    **arch):
        """The net a ``GANTrainConfig`` describes (``factor``,
        ``rrdb_blocks``, ``conv_fusion``); ``arch`` overrides the other
        constructor arguments."""
        return cls(scale=config.factor, nb=config.rrdb_blocks,
                   fusion=config.conv_fusion, dtype=dtype, device=device,
                   generator=generator, **arch)

    @classmethod
    def load(cls, path: str, config, dtype=None, device="cuda"):
        """A published RRDBNet .pth (ESRGAN's or BasicSR's names) -> (the
        net on ``device``, config with the file's block count); a x2-stage
        count that does not fit config.factor raises."""
        from tpusr_torch.io.checkpoint import (import_esrgan_rrdbnet,
                                               infer_rrdb_arch,
                                               load_torch_state_dict)

        sd = load_torch_state_dict(path)
        nb, n_up = infer_rrdb_arch(sd)
        if 2 ** n_up != config.factor:
            raise ValueError(f"{path} holds a x{2 ** n_up} RRDBNet but "
                             f"--factor/--downsample request "
                             f"x{config.factor}")
        config = dataclasses.replace(config, rrdb_blocks=nb)
        net = cls.from_config(config, dtype, device)
        net.load_state_dict(import_esrgan_rrdbnet(sd, nb, n_up))
        return net, config

    def __init__(self, out_channels: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, scale: int = 4,
                 dtype: torch.dtype | None = None, fusion: str = "auto",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if scale < 1 or scale & (scale - 1):
            raise ValueError(f"scale {scale} is not a power of 2")
        fusion = fusion_mode(fusion)
        dev = resolve_device(device)
        self.dtype, self.n_up = dtype, scale.bit_length() - 1

        def conv(cin, cout, fuse):
            return Conv(cin, cout, 3, dtype=dtype, generator=generator,
                        auto_fuse=fuse, fusion=fusion)

        self.conv_first = conv(3, nf, False)  # RGB in
        for i in range(nb):
            setattr(self, f"rrdb{i}", RRDB(nf, gc, dtype, fusion, generator))
        self.nb = nb
        # elements of the packed units: every dense-block kernel once
        self.pack_elems = sum(k.numel() for m in self.modules()
                              if isinstance(m, DenseBlock)
                              for k in m.kernels())
        self.trunk_conv = conv(nf, nf, True)
        for i in range(1, self.n_up + 1):
            setattr(self, f"upconv{i}", conv(nf, nf, True))
        self.conv_hr = conv(nf, nf, True)
        self.conv_last = conv(nf, out_channels, False)
        self.to(dev)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        fea = self.conv_first(x.contiguous(memory_format=torch.channels_last))
        packed = None
        if x.is_cuda and self.nb and self.rrdb0.rdb1.kernel_c:
            # every block's units in one go: a stack, a cast and a permute
            # per conv, one cat
            with span("rrdb.pack", blocks=3 * self.nb,
                      bytes=self.pack_elems * fea.element_size()):
                rdbs = [getattr(getattr(self, f"rrdb{i}"), f"rdb{j}")
                        for i in range(self.nb) for j in range(1, 4)]
                packed = packed_weights(
                    [torch.stack(ks)
                     for ks in zip(*(r.kernels() for r in rdbs))],
                    fea.dtype).view(self.nb, 3, -1)
        trunk = fea
        with span("rrdb.trunk", blocks=self.nb):
            for i in range(self.nb):
                trunk = getattr(self, f"rrdb{i}")(
                    trunk, None if packed is None else packed[i])
        fea = fea + self.trunk_conv(trunk)
        del trunk  # the tail holds the sum in its place, as before
        return nearest_conv_tail(
            fea, [getattr(self, f"upconv{i}") for i in range(1, self.n_up + 1)],
            self.conv_hr, self.conv_last, "rrdb.upsample")
