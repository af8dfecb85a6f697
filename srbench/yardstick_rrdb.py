"""The yardstick of ESRGAN's RRDBNet (the ``esrgan-rrdb-x4``
configuration): the operations of a frame, the work of one dense block,
the unit kernel C computes, and kernel A's launches, from the shapes
alone. Peaks and the roofline rule are ``srbench.yardstick``'s: each
input byte read once, each output byte written once, whatever a kernel
reads again; operations count the useful multiply-adds, not the halo a
kernel recomputes.
"""

from __future__ import annotations

from srbench.yardstick import ITEMSIZE, Conv, bound_s


def dense_block_macs(cfg: dict) -> int:
    """Multiply-adds per pixel of one dense block: five 3x3 convs over
    nf + (k - 1) gc channels to gc (k < 5) or nf; 239,616 at nf 64, gc
    32."""
    nf, gc = cfg["nf"], cfg["gc"]
    return 9 * sum((nf + (k - 1) * gc) * (gc if k < 5 else nf)
                   for k in range(1, 6))


def dense_block_work(cfg: dict, h: int, w: int, dtype: str,
                     n: int = 1) -> tuple[int, int]:
    """(operations, bytes) of one dense block on an (n, h, w, nf) input:
    x read once, y written once, every kernel's weights once in the
    activations' dtype (the packed units), the five biases once in f32."""
    b = ITEMSIZE[dtype]
    macs = dense_block_macs(cfg)
    px = n * h * w
    biases = 4 * cfg["gc"] + cfg["nf"]
    return 2 * macs * px, 2 * px * cfg["nf"] * b + macs * b + 4 * biases


def dense_block_bound_s(cfg: dict, h: int, w: int, dtype: str) -> float:
    """The least time the card could take for one dense block."""
    return bound_s(*dense_block_work(cfg, h, w, dtype), dtype)


def rrdbnet_convs(cfg: dict, h: int, w: int, n: int = 1) -> list[Conv]:
    """Every conv of RRDBNet on an (h, w) LR input: conv_first, the five
    convs of each of the 3 nb dense blocks, trunk_conv at LR; one conv per
    x2 stage at its output size; HRconv and conv_last at HR."""
    nf, gc = cfg["nf"], cfg["gc"]
    convs = [Conv("conv_first", n, h, w, cfg["in_nc"], nf, 3, dgrad=False)]
    convs += [Conv(f"rrdb{i}.rdb{j}.conv{k}", n, h, w, nf + (k - 1) * gc,
                   gc if k < 5 else nf, 3)
              for i in range(cfg["nb"]) for j in range(1, 4)
              for k in range(1, 6)]
    convs.append(Conv("trunk_conv", n, h, w, nf, nf, 3))
    for s in range(1, int(cfg["scale"]).bit_length()):
        h, w = 2 * h, 2 * w
        convs.append(Conv(f"upconv{s}", n, h, w, nf, nf, 3))
    convs += [Conv("conv_hr", n, h, w, nf, nf, 3),
              Conv("conv_last", n, h, w, nf, cfg["out_nc"], 3)]
    return convs


def rrdbnet_flops(cfg: dict, h: int, w: int) -> int:
    """Operations of one frame's forward: 4.647 TFLOP at 270 x 480 -> x4."""
    return sum(c.fwd_flops() for c in rrdbnet_convs(cfg, h, w))


KERNEL_A = ("trunk_conv", "upconv", "conv_hr")


def kernel_a_launches(cfg: dict, h: int, w: int,
                      dtype: str) -> list[tuple[str, float, float]]:
    """Kernel A's launches of one frame as (kernel, operations, bytes):
    trunk_conv at LR, each upconv at its output size, conv_hr at HR; x
    read once, y written once, the weights once."""
    b = ITEMSIZE[dtype]
    return [("A", cv.fwd_flops(),
             (cv.h * cv.w * (cv.cin + cv.cout) + 9 * cv.cin * cv.cout) * b)
            for cv in rrdbnet_convs(cfg, h, w) if cv.name.startswith(KERNEL_A)]
