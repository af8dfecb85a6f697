"""DIP skip network — multi-scale encoder-decoder with per-scale skips.

Counterpart of ``tpusr/models/skip.py`` (reference: models/DIP/skip.py:3-95,
get_net at models/DIP/__init__.py:8-18), with the same fields, defaults and
parameter names (``down{i}_conv1``, ``merge{i}_bn``, ``up{i}_conv``, ...).

Per scale i:
    skip branch : 1x1 conv -> BN -> act
    deeper      : s2 conv k3 -> BN -> act -> conv k3 -> BN -> act
                  -> [recurse] -> upsample x2
    merge       : BN(concat(center-crop)[skip, deeper]) -> conv k3 -> BN -> act
                  -> 1x1 conv -> BN -> act  (need1x1_up)
head: 1x1 conv to n_out + sigmoid.

``conv_fusion='auto'`` sends each level's ``down{i}_conv2`` and the trunk
part of ``up{i}_conv`` through the fused 3x3 kernel (ops/fused_conv.py): the
preceding BN's normalize (+ LeakyReLU) rides the conv's input read and the
conv's stats epilogue replaces the next BN's reduction; every BatchNorm
takes its moments and applies its normalize + activation through
ops/bn_act.py, one kernel a pass on a card (``BatchNorm.affine`` and
``affine_act``). Same math as ``'off'``, the unfused dataflow. ``'auto'``
defers to TPUSR_CONV_FUSION, read at import (``layers.fusion_mode``), as
in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpusr_torch.models.layers import (
    BatchNorm,
    Conv,
    SplitBatchNorm,
    SplitConv,
    activation,
    center_crop_to_min,
    fusion_mode,
    pool2x2,
    upsample2x,
)
from tpusr_torch.ops.bn_act import affine_act

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


class SkipNet(nn.Module):
    def __init__(self,
                 num_input_channels: int = 2,
                 num_output_channels: int = 3,
                 num_channels_down: Sequence[int] = (16, 32, 64, 128, 128),
                 num_channels_up: Sequence[int] = (16, 32, 64, 128, 128),
                 num_channels_skip: Sequence[int] = (4, 4, 4, 4, 4),
                 filter_size_down: int = 3,
                 filter_size_up: int = 3,
                 filter_skip_size: int = 1,
                 need_sigmoid: bool = True,
                 need_bias: bool = True,
                 pad: str = "zero",
                 upsample_mode: str = "nearest",
                 act_fun: str = "LeakyReLU",
                 need1x1_up: bool = True,
                 downsample_mode: str = "stride",
                 dtype: str | None = None,
                 conv_fusion: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        conv_fusion = fusion_mode(conv_fusion)
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {list(_DTYPES)}")
        self.n_scales = len(num_channels_down)
        self.num_channels_skip = tuple(num_channels_skip)
        self.need_sigmoid, self.need1x1_up = need_sigmoid, need1x1_up
        self.upsample_mode, self.downsample_mode = upsample_mode, downsample_mode
        self.act_fun, self.pad = act_fun, pad
        self.dtype = _DTYPES[dtype]
        self.act = activation(act_fun)
        # the semantic gates of the JAX fuse_ok; no shape gates
        fusable = (conv_fusion == "auto" and act_fun in ("LeakyReLU", "none")
                   and pad in ("zero", "reflection"))
        self.fuse_down = fusable and filter_size_down == 3
        self.fuse_up = fusable and filter_size_up == 3
        self.fuse_bn = fusable
        self.prologue_act = "leaky_relu" if act_fun == "LeakyReLU" else None

        dt, g = self.dtype, generator

        def conv(name, cin, cout, k, stride=1):
            self.add_module(name, Conv(cin, cout, k, stride=stride,
                                       use_bias=need_bias, pad_mode=pad,
                                       dtype=dt, generator=g))

        cin = num_input_channels
        for i in range(self.n_scales):
            last = i == self.n_scales - 1
            if num_channels_skip[i] != 0:
                conv(f"skip{i}_conv", cin, num_channels_skip[i],
                     filter_skip_size)
                self.add_module(f"skip{i}_bn",
                                BatchNorm(num_channels_skip[i]))
            down = num_channels_down[i]
            conv(f"down{i}_conv1", cin, down, filter_size_down,
                 stride=2 if downsample_mode == "stride" else 1)
            self.add_module(f"down{i}_bn1", BatchNorm(down))
            conv(f"down{i}_conv2", down, down, filter_size_down)
            self.add_module(f"down{i}_bn2", BatchNorm(down))
            deeper = down if last else num_channels_up[i + 1]
            widths = ((num_channels_skip[i],) if num_channels_skip[i] else ()
                      ) + (deeper,)
            up = num_channels_up[i]
            self.add_module(f"merge{i}_bn", SplitBatchNorm(widths))
            self.add_module(f"up{i}_conv", SplitConv(
                widths, up, filter_size_up, use_bias=need_bias, pad_mode=pad,
                dtype=dt, generator=g))
            self.add_module(f"up{i}_bn", BatchNorm(up))
            if need1x1_up:
                conv(f"up{i}_conv1x1", up, up, 1)
                self.add_module(f"up{i}_bn1x1", BatchNorm(up))
            cin = down
        conv("head_conv", num_channels_up[0], num_output_channels, 1)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = True) -> torch.Tensor:
        """x: (N, C, H, W) -> (N, n_out, H, W) in f32. ``train`` normalizes
        with batch stats (DIP always does); ``update_stats=False`` discards
        the running-stat update of a train-mode forward."""
        ura = not train
        act = self.act

        def mod(name):
            return getattr(self, name)

        def bn(name, t, **kw):
            return mod(name)(t, ura, update_stats=update_stats, **kw)

        def affine(name, t, **kw):
            return mod(name).affine(t, ura, update_stats=update_stats, **kw)

        def bn_act(name, t, **kw):
            """act(BN(t)): on the fused dataflow, ops/bn_act.py's kernels."""
            if not self.fuse_bn:
                return act(bn(name, t, **kw))
            es, eb, fold = affine(name, t, **kw)
            return affine_act(t, es, eb, self.prologue_act, fold)

        def level(i: int, h: torch.Tensor) -> torch.Tensor:
            branches = []
            if self.num_channels_skip[i] != 0:
                s = mod(f"skip{i}_conv")(h)
                branches.append(bn_act(f"skip{i}_bn", s))

            d = mod(f"down{i}_conv1")(h)
            if self.downsample_mode != "stride":
                d = pool2x2(d, self.downsample_mode)
            if self.fuse_down:
                es, eb, fold = affine(f"down{i}_bn1", d)
                d2, st, b2 = mod(f"down{i}_conv2")(
                    d, prologue=(es, eb, self.prologue_act, fold),
                    emit_stats=True)
                n = d2.numel() // d2.shape[1]
                d = bn_act(f"down{i}_bn2", d2,
                           conv_stats=(st[0], st[1], n, b2))
            else:
                d = bn_act(f"down{i}_bn1", d)
                d = mod(f"down{i}_conv2")(d)
                d = bn_act(f"down{i}_bn2", d)

            if i < self.n_scales - 1:
                d = level(i + 1, d)
            branches.append(upsample2x(d, self.upsample_mode))

            parts = center_crop_to_min(branches)
            if self.fuse_up:
                z, st, b2 = mod(f"up{i}_conv")(
                    parts, prologues=affine(f"merge{i}_bn", parts),
                    emit_stats=True)
                n = z.numel() // z.shape[1]
                z = bn_act(f"up{i}_bn", z, conv_stats=(st[0], st[1], n, b2))
            else:
                parts = bn(f"merge{i}_bn", parts)
                z = mod(f"up{i}_conv")(parts)
                z = bn_act(f"up{i}_bn", z)
            if self.need1x1_up:
                z = mod(f"up{i}_conv1x1")(z)
                z = bn_act(f"up{i}_bn1x1", z)
            return z

        if self.dtype is not None:
            x = x.to(self.dtype)
        out = self.head_conv(level(0, x)).float()
        return torch.sigmoid(out) if self.need_sigmoid else out


def build_dip_net(input_depth: int = 32, pad: str = "reflection",
                  upsample_mode: str = "bilinear", n_channels: int = 3,
                  act_fun: str = "LeakyReLU", skip_n33d: int = 128,
                  skip_n33u: int = 128, skip_n11: int = 4,
                  num_scales: int = 5, downsample_mode: str = "stride",
                  dtype: str | None = None, conv_fusion: str = "auto",
                  generator: torch.Generator | None = None) -> SkipNet:
    """The DIP.py:169-174 configuration (get_net parity)."""
    return SkipNet(
        num_input_channels=input_depth,
        num_output_channels=n_channels,
        num_channels_down=(skip_n33d,) * num_scales,
        num_channels_up=(skip_n33u,) * num_scales,
        num_channels_skip=(skip_n11,) * num_scales,
        pad=pad,
        upsample_mode=upsample_mode,
        act_fun=act_fun,
        need_sigmoid=True,
        need_bias=True,
        downsample_mode=downsample_mode,
        dtype=dtype,
        conv_fusion=conv_fusion,
        generator=generator,
    )
