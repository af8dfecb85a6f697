"""Model building blocks with PyTorch semantics, logical NCHW.

Counterpart of ``tpusr/models/layers.py`` for the parts the DIP skip
network needs. Activations are NCHW tensors kept in channels_last memory,
so the fused conv kernel sees an NHWC view with no copy.

Init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for conv kernels and biases,
torch's Conv2d default, drawn from an explicit ``torch.Generator``. DIP
builds a fresh net per image, so the init distribution is part of parity.

BatchNorm: torch BatchNorm2d semantics (eps 1e-5, momentum 0.1), with the
JAX package's one-pass formulas: var = max(E[x^2] - E[x]^2, 0) in f32, the
biased variance normalizes, the unbiased one goes into the running stats.
Two hooks carry the fused dataflow: ``conv_stats`` (the producing conv
already reduced sum/sum^2 of its bias-free output) and ``return_affine``
(the consuming conv applies the normalize in its prologue). The skip net's
fused dataflow takes its affines from ``affine``, whose moments, normalize
and their backward run as ops/bn_act.py's kernels on a card. Under
``global_batch_stats(all_sum, world)`` a train-mode BatchNorm's
statistics span the batches of every rank of a data-parallel group, as
tpusr's jitted DP step computes them over the global batch.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpusr_torch.ops.bn_act import (affine_act, channel_moments,
                                    channel_moments_reference)
from tpusr_torch.ops.fused_conv import fused_conv3x3
from tpusr_torch.utils.profiling import span

# The conv-fusion default, read once at import as tpusr reads it
# (tpusr/models/layers.py:79-85): every 'auto' fusion field defers to it,
# an explicit 'off' wins over it. tpusr's third value, 'interpret', runs
# its Pallas kernels in interpret mode and has no counterpart here.
FUSION_MODES = ("auto", "off")
_CONV_FUSION_DEFAULT = os.environ.get("TPUSR_CONV_FUSION", "auto")


def fusion_mode(attr: str = "auto") -> str:
    """Resolve a fusion field: 'auto' defers to the import-time
    TPUSR_CONV_FUSION default, an explicit 'off' wins over it. Any other
    value, in the field or in the environment, raises ValueError."""
    mode = _CONV_FUSION_DEFAULT if attr == "auto" else attr
    if mode not in FUSION_MODES:
        where = " (TPUSR_CONV_FUSION)" if attr == "auto" else ""
        raise ValueError(f"conv fusion {mode!r}{where} not in "
                         f"{'/'.join(FUSION_MODES)}")
    return mode


def _uniform(shape, fan_in: int, generator: torch.Generator | None):
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound,
                                                    generator=generator))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC view of an NCHW tensor; no copy when it is channels_last."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) view of an NHWC tensor."""
    return y.permute(0, 3, 1, 2)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW parameter -> contiguous HWIO, the fused kernel's layout."""
    return w.permute(2, 3, 1, 0).contiguous()


def _per_channel(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype).view(1, -1, 1, 1)


_STAT_REDUCE = None  # (all_sum, world) of the active global_batch_stats


@contextlib.contextmanager
def global_batch_stats(all_sum: Callable, world: int):
    """Within the block, BatchNorm's train-mode statistics are those of the
    global batch over ``world`` ranks. ``all_sum(t)`` returns the sum of
    ``t`` over the ranks, differentiably (its backward sums the cotangents
    over the ranks); the caller that owns the process group supplies it
    (``parallel/gan_dp.py``). Each layer sums its per-channel raw moments,
    each rank's E[x] and E[x^2] weighted by its share 1/W of the global
    count (Σ_r S_r / N, the sums behind them). So every rank normalises and
    updates its running statistics with the same global mean and variance.
    That is 2C floats per layer (per stat group); from the fused path's
    conv_stats, no extra pass over the activations. Every rank's batch
    must have the same shape (the DP step splits the global batch evenly).
    At W = 1 the statistics are the single-process ones bit for bit;
    outside the block, BatchNorm is the single-process layer itself."""
    global _STAT_REDUCE
    prev, _STAT_REDUCE = _STAT_REDUCE, (all_sum, world)
    try:
        yield
    finally:
        _STAT_REDUCE = prev


def _global_moments(m1, m2, n: int):
    """(E[x], E[x^2], count) over the ranks from this rank's (..., C)
    moments over its n elements per channel."""
    all_sum, world = _STAT_REDUCE
    c = m1.shape[-1]
    buf = all_sum(torch.cat([m1, m2], -1) * (1.0 / world))
    return buf[..., :c], buf[..., c:], n * world


def conv_apply(x, weight, stride: int, pad_mode: str, bias=None):
    """kxk conv with the reference's padding: 'zero' pads inside the conv,
    'reflection' reflect-pads first (models/DIP/utils.py:96-102)."""
    if pad_mode not in ("zero", "reflection"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    p = (weight.shape[-1] - 1) // 2
    if pad_mode == "reflection" and p > 0:
        x = F.pad(x, (p, p, p, p), mode="reflect")
        p = 0
    return F.conv2d(x, weight, bias, stride=stride, padding=p)


class Conv(nn.Module):
    """2-D conv (OIHW weight) with torch-style 'same' padding.

    ``forward(x, prologue=(es, eb, act, fold), emit_stats=True)`` runs the
    fused 3x3 kernel: the previous BN's normalize + activation ride the
    input read (``fold``: that BN's, from ``BatchNorm.affine``), and the
    kernel reduces per-channel [sum, sum^2] of the bias-free output for the
    next BN. It then returns (y_without_bias, stats, bias).

    ``auto_fuse=True`` with ``fusion='auto'`` sends a plain call of a 3x3
    stride-1 conv through the fused kernel too (no prologue, no stats), with
    the bias added after; ``fusion='off'`` keeps it on ``F.conv2d``, and
    so does 'auto' under TPUSR_CONV_FUSION=off (``fusion_mode``).
    ``forward(x, fuse=...)`` overrides ``auto_fuse`` for one call, as the
    JAX package's eval forward rebuilds its generator with auto_fuse on.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = True,
                 pad_mode: str = "zero", dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 auto_fuse: bool = False, fusion: str = "auto"):
        super().__init__()
        fusion = fusion_mode(fusion)
        k = kernel_size
        fan_in = k * k * in_channels
        self.stride, self.pad_mode, self.dtype = stride, pad_mode, dtype
        self.fusable = (fusion == "auto" and k == 3 and stride == 1
                        and pad_mode in ("zero", "reflection"))
        self.fused = auto_fuse and self.fusable
        self.weight = _uniform((features, in_channels, k, k), fan_in,
                               generator)
        self.bias = (_uniform((features,), fan_in, generator) if use_bias
                     else None)

    def forward(self, x, *, prologue=None, emit_stats: bool = False,
                fuse: bool | None = None):
        if self.dtype is not None:
            x = x.to(self.dtype)
        fused = self.fused if fuse is None else fuse and self.fusable
        if prologue is None and not emit_stats and not fused:
            b = None if self.bias is None else self.bias.to(x.dtype)
            return conv_apply(x, self.weight.to(x.dtype), self.stride,
                              self.pad_mode, b)
        if self.stride != 1 or self.weight.shape[-1] != 3:
            raise ValueError("the fused path takes 3x3 stride-1 convs only")
        es, eb, act, fold = prologue if prologue is not None else (None,) * 4
        out = fused_conv3x3(_nhwc(x), _hwio(self.weight), es, eb, act=act,
                            pad_mode=self.pad_mode, stats=emit_stats,
                            fold=fold)
        bias = self.bias
        if emit_stats:
            y, st = out
            if bias is None:
                bias = torch.zeros(self.weight.shape[0], device=y.device)
            return _nchw(y), st, bias
        y = _nchw(out)
        return y if bias is None else y + _per_channel(bias, y.dtype)


class BatchNorm(nn.Module):
    """BatchNorm2d with torch semantics and the fused-dataflow hooks.

    * ``conv_stats=(sum, sumsq, n, conv_bias)``: batch stats from the
      producing conv's epilogue; the conv bias is still pending (not added
      to x), so mean = sum/n + b goes to the running stats while the affine
      uses the mean of x as passed.
    * ``return_affine=True``: return (eff_scale, eff_bias) in f32.
    * ``affine(...)``: (eff_scale, eff_bias, fold), the fused dataflow's
      form of ``return_affine``: its train-mode moments come from
      ``ops/bn_act.channel_moments`` (a kernel on a card), whose ``fold``
      the one consumer that normalizes x takes (None on the CPU).
    * ``update_stats=False``: a train-mode forward whose running-stat update
      is discarded (the DIP metric and resolve forwards, the G update's
      discriminator).
    * ``stat_groups=g`` (train mode): x stacks g independent batches along
      N; each group normalises with its own statistics over (N/g, H, W) and
      the running statistics take the g momentum updates in group order,
      as g sequential calls would (the SRGAN discriminator's concat(real,
      fake) update).
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def _update(self, mean, var, n: int):
        unbiased = var * (n / max(n - 1, 1))
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)

    def forward(self, x, use_running_average: bool = False, *,
                conv_stats=None, return_affine: bool = False,
                update_stats: bool = True, stat_groups: int = 1):
        if stat_groups > 1 and (conv_stats is not None or return_affine):
            raise ValueError("stat_groups > 1 is incompatible with "
                             "conv_stats/return_affine")
        if stat_groups > 1 and not use_running_average:
            return self._grouped(x, stat_groups, update_stats)
        es, eb, _ = self._affine(x, use_running_average, conv_stats,
                                 update_stats, kernels=False)
        if return_affine:
            return es, eb
        return x * _per_channel(es, x.dtype) + _per_channel(eb, x.dtype)

    def affine(self, x, use_running_average: bool = False, *,
               conv_stats=None, update_stats: bool = True):
        return self._affine(x, use_running_average, conv_stats,
                            update_stats, kernels=True)

    def _affine(self, x, use_running_average, conv_stats, update_stats,
                kernels):
        pending, fold = 0.0, None
        if use_running_average:
            mean, var = self.running_mean, self.running_var
            if conv_stats is not None:
                pending = conv_stats[3]
        elif conv_stats is not None:
            s, ss, n, cb = conv_stats
            m_raw, m2 = s / n, ss / n
            if _STAT_REDUCE is not None:
                m_raw, m2, n = _global_moments(m_raw, m2, n)
            var = torch.clamp(m2 - m_raw.square(), min=0.0)
            mean = m_raw + cb
            pending = cb
            if update_stats:
                self._update(mean, var, n)
        else:
            mean, var, n, fold = _moments(x, kernels)
            if update_stats:
                self._update(mean, var, n)
        inv = torch.rsqrt(var + self.eps)
        eff_scale = inv * self.weight
        eff_bias = self.bias - (mean - pending) * inv * self.weight
        return eff_scale, eff_bias, fold

    def _grouped(self, x, g: int, update_stats: bool):
        if x.shape[0] % g:
            raise ValueError(f"batch {x.shape[0]} not divisible into {g} "
                             f"stat groups")
        xg = x.reshape(g, x.shape[0] // g, *x.shape[1:])
        if _STAT_REDUCE is None:
            moments = [_batch_moments(part) for part in xg]
        else:  # one all-reduce for the g groups
            local = [_local_moments(part) for part in xg]
            m1, m2, n = _global_moments(torch.stack([m[0] for m in local]),
                                        torch.stack([m[1] for m in local]),
                                        local[0][2])
            moments = [(m1[i], torch.clamp(m2[i] - m1[i].square(), min=0.0),
                        n) for i in range(g)]
        if update_stats:
            for mean, var, n in moments:  # group order = call order
                self._update(mean, var, n)
        mean = torch.stack([m[0] for m in moments])  # (g, C)
        inv = torch.rsqrt(torch.stack([m[1] for m in moments]) + self.eps)
        es = (inv * self.weight).to(x.dtype)[:, None, :, None, None]
        eb = (self.bias - mean * inv * self.weight).to(x.dtype)[
            :, None, :, None, None]
        return (xg * es + eb).reshape(x.shape)


def _local_moments(x):
    """Per-channel E[x] and E[x^2] over (N, H, W) in f32 (an f64 net, the
    exact yardstick of chip_smoke.py, keeps f64) and the count."""
    return (*channel_moments_reference(x), x.numel() // x.shape[1])


def _batch_stats(mean, mean2, n: int):
    """Per-channel mean and biased variance from E[x], E[x^2] over n, one
    pass (E[x^2] - E[x]^2, clamped: bf16 squares can dip below zero), and
    the count; under ``global_batch_stats`` over the group's global batch."""
    if _STAT_REDUCE is not None:
        mean, mean2, n = _global_moments(mean, mean2, n)
    return mean, torch.clamp(mean2 - mean.square(), min=0.0), n


def _batch_moments(x):
    """``_batch_stats`` of x's eager moments."""
    return _batch_stats(*_local_moments(x))


def _moments(x, kernels: bool):
    """(mean, biased var, count, fold): ``_batch_moments`` with fold None,
    or with ``kernels`` the moments of ``ops/bn_act.channel_moments``."""
    if not kernels:
        return (*_batch_moments(x), None)
    m1, m2, fold = channel_moments(x)
    return (*_batch_stats(m1, m2, x.numel() // x.shape[1]), fold)


class SplitBatchNorm(nn.Module):
    """BatchNorm2d over a channel concatenation, consuming the parts.

    Declares the same (sum(splits),) params and stats as a BatchNorm over
    the concat; statistics are per channel, so each part normalizes with
    its slice. ``affine`` gives each part's (eff_scale, eff_bias, fold), as
    ``BatchNorm.affine``.
    """

    def __init__(self, splits: Sequence[int], momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.splits = tuple(splits)
        self.momentum, self.eps = momentum, eps
        c = sum(self.splits)
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, xs, use_running_average: bool = False, *,
                return_affine: bool = False, update_stats: bool = True):
        affines = self._affines(xs, use_running_average, update_stats,
                                kernels=False)
        if return_affine:
            return [(es, eb) for es, eb, _ in affines]
        return [x * _per_channel(es, x.dtype) + _per_channel(eb, x.dtype)
                for x, (es, eb, _) in zip(xs, affines)]

    def affine(self, xs, use_running_average: bool = False, *,
               update_stats: bool = True):
        return self._affines(xs, use_running_average, update_stats,
                             kernels=True)

    def _affines(self, xs, use_running_average, update_stats, kernels):
        outs, means, varis = [], [], []
        off = 0
        for x, ci in zip(xs, self.splits):
            fold = None
            if use_running_average:
                mean = self.running_mean[off:off + ci]
                var = self.running_var[off:off + ci]
            else:
                mean, var, n, fold = _moments(x, kernels)
                means.append(mean)
                varis.append(var * (n / max(n - 1, 1)))
            sc = self.weight[off:off + ci]
            bi = self.bias[off:off + ci]
            inv = torch.rsqrt(var + self.eps)
            outs.append((inv * sc, bi - mean * inv * sc, fold))
            off += ci
        if not use_running_average and update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * torch.cat(means))
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * torch.cat(varis))
        return outs


class SplitConv(nn.Module):
    """kxk conv over a channel concatenation without materializing it:
    conv(concat(xs), W) == sum_i conv(xs[i], W[:, slice_i]).

    One (features, sum(splits), k, k) weight, fan_in = k*k*sum(splits), as a
    Conv over the concat would have. With ``prologues`` (per-part
    (eff_scale, eff_bias, fold) from ``SplitBatchNorm.affine``) the LAST
    part, the trunk, runs through the fused kernel with its prologue, the
    other parts' sum as its base input and, with ``emit_stats``, the stats
    of the merged output; the other parts apply their affine explicitly
    (``ops/bn_act.affine_act``). Returns y, or
    (y_without_bias, stats, bias) with ``emit_stats``.
    """

    def __init__(self, splits: Sequence[int], features: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = True,
                 pad_mode: str = "zero", dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.splits = tuple(splits)
        k = kernel_size
        fan_in = k * k * sum(self.splits)
        self.stride, self.pad_mode, self.dtype = stride, pad_mode, dtype
        self.weight = _uniform((features, sum(self.splits), k, k), fan_in,
                               generator)
        self.bias = (_uniform((features,), fan_in, generator) if use_bias
                     else None)

    def forward(self, xs, *, prologues=None, emit_stats: bool = False):
        if emit_stats and prologues is None:
            raise ValueError("emit_stats needs the fused path (prologues)")
        y, st = None, None
        off = 0
        for idx, (x, ci) in enumerate(zip(xs, self.splits)):
            if self.dtype is not None:
                x = x.to(self.dtype)
            w = self.weight[:, off:off + ci]
            pro = prologues[idx] if prologues is not None else None
            if pro is not None and idx == len(self.splits) - 1:
                if self.stride != 1 or w.shape[-1] != 3:
                    raise ValueError("the fused path takes 3x3 stride-1 convs")
                out = fused_conv3x3(
                    _nhwc(x), _hwio(w), pro[0], pro[1], act=None,
                    pad_mode=self.pad_mode, stats=emit_stats,
                    base=None if y is None else _nhwc(y), fold=pro[2])
                if emit_stats:
                    out, st = out
                y = _nchw(out)
            else:
                if pro is not None:
                    es, eb, fold = pro
                    x = affine_act(x, es, eb, None, fold)
                part = conv_apply(x, w.to(x.dtype), self.stride,
                                  self.pad_mode)
                y = part if y is None else y + part
            off += ci
        bias = self.bias
        if emit_stats:
            if bias is None:
                bias = torch.zeros(self.weight.shape[0], device=y.device)
            return y, st, bias
        return y if bias is None else y + _per_channel(bias, y.dtype)


class PReLU(nn.Module):
    """torch nn.PReLU(): one shared slope ``alpha`` of shape (1,), init
    0.25, applied in x's dtype."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class Dense(nn.Module):
    """torch nn.Linear: ``weight`` (features, in_features), the transpose
    of the JAX package's (in, out) kernel, and ``bias``, both
    U(+-1/sqrt(in_features)). ``dtype`` casts the input; the weight follows
    the input's dtype (a bf16-stored weight computes in f32 for an f32
    input, as a promoting dot does)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = _uniform((features, in_features), in_features,
                               generator)
        self.bias = _uniform((features,), in_features, generator)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def leaky_relu(x, negative_slope: float = 0.2):
    """LeakyReLU in x's dtype."""
    return F.leaky_relu(x, negative_slope)


def nearest_conv_tail(fea, upconvs: Sequence[nn.Module], conv_hr: nn.Module,
                      conv_last: nn.Module, span_name: str) -> torch.Tensor:
    """The nearest+conv tail that ESRGAN's RRDBNet and SwinIR share: per x2
    octave [nearest x2, conv ``upconvs[i]``, LeakyReLU 0.2], inside the
    span ``span_name`` (field ``octaves``); then LeakyReLU 0.2 after
    ``conv_hr`` and ``conv_last``, returned in f32. Each stage drops its
    input before its conv runs; callers drop their other large tensors
    before the call, so that the tail's peak holds no more than it needs."""
    with span(span_name, octaves=len(upconvs)):
        for conv in upconvs:
            fea = F.interpolate(fea, scale_factor=2, mode="nearest")
            fea = leaky_relu(conv(fea))
    fea = leaky_relu(conv_hr(fea))
    return conv_last(fea).float()


def pixel_shuffle(x, r: int):
    """torch nn.PixelShuffle on NCHW: channel c*r*r + dy*r + dx goes to
    (c, y*r + dy, x*r + dx), the order the JAX package copies over NHWC.
    The result stays channels_last, the layout the fused kernel reads."""
    return F.pixel_shuffle(x, r).contiguous(memory_format=torch.channels_last)


def pool2x2(x, mode: str):
    """torch AvgPool2d(2,2) / MaxPool2d(2,2)."""
    if mode == "avg":
        return F.avg_pool2d(x, 2)
    if mode == "max":
        return F.max_pool2d(x, 2)
    raise ValueError(f"unknown pool mode {mode!r}")


def upsample2x(x, mode: str = "bilinear"):
    """torch nn.Upsample(scale_factor=2) (align_corners=False)."""
    if mode == "nearest":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    if mode == "bilinear":
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)
    raise ValueError(f"unknown upsample mode {mode!r}")


def center_crop_to_min(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Center-crop NCHW inputs to the smallest spatial size (the crop half
    of the reference's Concat, models/DIP/utils.py:10-41)."""
    th = min(x.shape[2] for x in xs)
    tw = min(x.shape[3] for x in xs)
    out = []
    for x in xs:
        dh = (x.shape[2] - th) // 2
        dw = (x.shape[3] - tw) // 2
        out.append(x[:, :, dh:dh + th, dw:dw + tw])
    return out


def activation(name: str) -> Callable:
    """'LeakyReLU' | 'ELU' | 'none' (models/DIP/utils.py:62-76)."""
    if name == "LeakyReLU":
        return lambda x: F.leaky_relu(x, 0.2)
    if name == "ELU":
        return F.elu
    if name == "none":
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")
