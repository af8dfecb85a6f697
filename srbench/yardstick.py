"""The yardstick: the H100's published peaks and the operations and bytes
that each measured piece of work needs, computed from its shapes.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit):
989 TFLOP/s in bf16, 495 TFLOP/s in TF32, 3.35 TB/s of HBM. f32 work is
bounded at the TF32 rate, the fastest one an f32 conv may take on this
card (cuDNN takes it by default): a bound at the 3xTF32 rate, which is one
implementation's, would read above 100 % for a kernel that moved to
one-pass TF32. A roofline bound is the larger of operations over the peak
rate and bytes over the bandwidth; each input byte is read once and each
output byte written once, whatever a kernel reads again.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def conv_flops(n: int, h_out: int, w_out: int, cin: int, cout: int,
               k: int) -> int:
    """Multiply-adds of one conv, counted as two operations each."""
    return 2 * n * h_out * w_out * cin * cout * k * k


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)


@dataclasses.dataclass(frozen=True)
class Conv:
    """One conv of a net: input (n, h, w, cin), kernel k, stride, output
    channels; ``dgrad`` False where its input needs no gradient."""

    name: str
    n: int
    h: int
    w: int
    cin: int
    cout: int
    k: int
    stride: int = 1
    dgrad: bool = True

    @property
    def out_hw(self) -> tuple[int, int]:
        return -(-self.h // self.stride), -(-self.w // self.stride)

    def fwd_flops(self) -> int:
        return conv_flops(self.n, *self.out_hw, self.cin, self.cout, self.k)

    def train_flops(self) -> int:
        """Forward, weight gradient and, where needed, input gradient."""
        return self.fwd_flops() * (3 if self.dgrad else 2)


# ------------------------------------------------------------ DIP skip net
def skip_net_convs(cfg: dict, h: int, w: int, n: int = 1) -> list[Conv]:
    """Every conv of the DIP skip net (models/DIP/skip.py) on an (h, w)
    input: per scale a 1x1 skip conv, a stride-2 and a stride-1 kxk conv
    down, a kxk conv over the merge and a 1x1 conv up; a 1x1 head. The
    convs that read the fixed input z need no input gradient."""
    d, u, s = cfg["skip_n33d"], cfg["skip_n33u"], cfg["skip_n11"]
    scales = cfg["num_scales"]
    convs, cin = [], cfg["input_depth"]
    for i in range(scales):
        first = i == 0
        deeper = d if i == scales - 1 else u
        h2, w2 = -(-h // 2), -(-w // 2)
        convs += [Conv(f"skip{i}_conv", n, h, w, cin, s, 1, dgrad=not first),
                  Conv(f"down{i}_conv1", n, h, w, cin, d, 3, 2,
                       dgrad=not first),
                  Conv(f"down{i}_conv2", n, h2, w2, d, d, 3),
                  Conv(f"up{i}_conv", n, h, w, s + deeper, u, 3),
                  Conv(f"up{i}_conv1x1", n, h, w, u, u, 1)]
        cin, h, w = d, h2, w2
    convs.append(Conv("head_conv", n, convs[0].h, convs[0].w, u, 3, 1))
    return convs


def dip_flops(cfg: dict, h: int, w: int, lanes: int = 1) -> tuple[int, int]:
    """(operations of one training iteration, of one forward) of the skip
    net on an (h, w) image, for ``lanes`` nets, with the loss's lanczos
    downsample (two operations per tap and output)."""
    convs = skip_net_convs(cfg, h, w)
    f = cfg["factor"]
    taps = 4 * f  # lanczos2 at phase 0.5: 4 * factor taps per axis
    down = 2 * 3 * (h // f) * (w // f) * taps * taps
    train = sum(c.train_flops() for c in convs) + 2 * down
    fwd = sum(c.fwd_flops() for c in convs)
    return lanes * train, lanes * fwd


def dip_fused_launches(cfg: dict, h: int, w: int,
                       dtype: str) -> list[tuple[str, float, float]]:
    """The kernel-A/B launches of one DIP training iteration under
    conv_fusion 'auto' as (kernel, operations, bytes): per scale the
    stride-1 down conv (prologue, stats) and the trunk part of the merge
    conv (prologue, base, stats), each forward (A), input gradient (A) and
    weight gradient (B)."""
    b = ITEMSIZE[dtype]
    d, u = cfg["skip_n33d"], cfg["skip_n33u"]
    out = []
    for i in range(cfg["num_scales"]):
        h2, w2 = -(-h // 2), -(-w // 2)
        trunk_in = d if i == cfg["num_scales"] - 1 else u
        for (hh, ww, ci, co, base) in ((h2, w2, d, d, False),
                                       (h, w, trunk_in, u, True)):
            px = hh * ww
            flops = conv_flops(1, hh, ww, ci, co, 3)
            wbytes = 9 * ci * co * b
            fwd = (px * ci + px * co * (2 if base else 1)) * b + wbytes \
                + 2 * ci * 4 + 2 * co * 4
            dgrad = (px * co + px * ci) * b + wbytes
            wgrad = (px * ci + px * co) * b + 2 * ci * 4 + 9 * ci * co * 4
            out += [("A", flops, fwd), ("A", flops, dgrad),
                    ("B", flops, wgrad)]
        h, w = h2, w2
    return out


# ---------------------------------------------------------------- SRGAN G
def srgan_generator_convs(cfg: dict, h: int, w: int, n: int = 1
                          ) -> list[Conv]:
    """Every conv of the SRGAN generator on an (h, w) LR input: a 9x9 head
    3 -> 64, two 3x3 convs per residual block, one after the blocks, one
    3x3 conv 64 -> 256 before each x2 pixel shuffle, a 9x9 tail 64 -> 3."""
    c, blocks = cfg["n_features"], cfg["residual_blocks_count"]
    convs = [Conv("conv1", n, h, w, 3, c, 9, dgrad=False)]
    convs += [Conv(f"res{i}.conv{j}", n, h, w, c, c, 3)
              for i in range(blocks) for j in (1, 2)]
    convs.append(Conv("conv2", n, h, w, c, c, 3))
    for i in range(cfg["n_shuffles"]):
        convs.append(Conv(f"ps{i}.conv1", n, h, w, c, 4 * c, 3))
        h, w = 2 * h, 2 * w
    convs.append(Conv("conv3", n, h, w, c, 3, 9))
    return convs


def srgan_eval_launches(cfg: dict, h: int, w: int,
                        dtype: str) -> list[tuple[str, float, float]]:
    """Kernel A's launches of one eval forward as (kernel, operations,
    bytes): every 3x3 conv, zero padding, no prologue, no stats."""
    b = ITEMSIZE[dtype]
    out = []
    for cv in srgan_generator_convs(cfg, h, w):
        if cv.k != 3:
            continue
        px = cv.h * cv.w
        nbytes = (px * cv.cin + px * cv.cout + 9 * cv.cin * cv.cout) * b
        out.append(("A", cv.fwd_flops(), nbytes))
    return out


def srgan_discriminator_fwd(hr_patch: int) -> tuple[int, int]:
    """(operations of the SRGAN discriminator's forward on one hr_patch^2
    patch, of its first conv): a 3x3 conv 3 -> 64, seven 3x3 convs (64,
    s2), (128, s1), (128, s2), (256, s1), (256, s2), (512, s1), (512, s2),
    a dense layer to 1024 and one to 1."""
    first = conv_flops(1, hr_patch, hr_patch, 3, 64, 3)
    total, n, cin = first, hr_patch, 64
    for ch, stride in ((64, 2), (128, 1), (128, 2), (256, 1), (256, 2),
                       (512, 1), (512, 2)):
        n = -(-n // stride)
        total += conv_flops(1, n, n, cin, ch, 3)
        cin = ch
    return total + 2 * n * n * cin * 1024 + 2 * 1024, first


def vgg19_fwd(side: int) -> int:
    """Operations of VGG19's feature convs through conv5_4 on one
    side^2 image: blocks of (64, 2), (128, 2), (256, 4), (512, 4),
    (512, 4) 3x3 convs, a 2x2 pool after each block but the last."""
    total, cin = 0, 3
    for cout, n in ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4)):
        for _ in range(n):
            total += conv_flops(1, side, side, cin, cout, 3)
            cin = cout
        side //= 2
    return total
