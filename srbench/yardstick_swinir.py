"""The yardstick of SwinIR-M (the ``swinir-m-x4-real`` configuration): the
operations of a frame, the work of one launch of the window-attention
kernel, and kernel A's launches, from the shapes alone. Peaks and the
roofline rule are ``srbench.yardstick``'s: each input byte read once, each
output byte written once; operations count the useful multiply-adds (the
head dimension as published, not the 32 the kernel pads it to). The model
computes on the LR frame reflect-padded to whole windows and crops its
output, so the operations are those of the padded frame.
"""

from __future__ import annotations

from srbench.yardstick import ITEMSIZE, Conv, bound_s


def padded(cfg: dict, h: int, w: int) -> tuple[int, int]:
    """The LR size the model computes on: whole windows."""
    ws = cfg["window_size"]
    return -(-h // ws) * ws, -(-w // ws) * ws


def swinir_convs(cfg: dict, h: int, w: int, n: int = 1) -> list[Conv]:
    """Every conv of SwinIR on an (h, w) LR input, at the padded size:
    conv_first, one per RSTB, conv_after_body and conv_before_upsample at
    LR; one per x2 stage at its output size; conv_hr and conv_last at
    HR."""
    h, w = padded(cfg, h, w)
    c, nf = cfg["embed_dim"], cfg["num_feat"]
    convs = [Conv("conv_first", n, h, w, cfg["in_chans"], c, 3, dgrad=False)]
    convs += [Conv(f"layers.{i}.conv", n, h, w, c, c, 3)
              for i in range(len(cfg["depths"]))]
    convs += [Conv("conv_after_body", n, h, w, c, c, 3),
              Conv("conv_before_upsample", n, h, w, c, nf, 3)]
    for s in range(1, int(cfg["upscale"]).bit_length()):
        h, w = 2 * h, 2 * w
        convs.append(Conv(f"conv_up{s}", n, h, w, nf, nf, 3))
    convs += [Conv("conv_hr", n, h, w, nf, nf, 3),
              Conv("conv_last", n, h, w, nf, cfg["in_chans"], 3)]
    return convs


def window_attention_work(cfg: dict, h: int, w: int, dtype: str,
                          heads: int) -> tuple[int, int]:
    """(operations, bytes) of one launch of the window-attention kernel on
    an (h, w) LR frame: q k^T and P v, 2 x 64 x 64 x hd multiply-adds each
    per window and head; qkv read once (T x 3C), A written once (T x C),
    the (15^2, heads) f32 bias table once."""
    hp, wp = padded(cfg, h, w)
    ws, c = cfg["window_size"], cfg["embed_dim"]
    tokens, n = hp * wp, ws * ws
    windows = tokens // n
    ops = 2 * 2 * windows * heads * n * n * (c // heads)
    nbytes = tokens * 4 * c * ITEMSIZE[dtype] + (2 * ws - 1) ** 2 * heads * 4
    return ops, nbytes


def window_attention_bound_s(cfg: dict, h: int, w: int, dtype: str) -> float:
    """The least time the card could take for one launch (every layer has
    the same heads in SwinIR-M)."""
    heads = cfg["num_heads"][0]
    return bound_s(*window_attention_work(cfg, h, w, dtype, heads), dtype)


def swinir_flops(cfg: dict, h: int, w: int) -> int:
    """Operations of one frame's forward: every conv, and per Swin layer
    its four GEMMs (qkv C -> 3C, proj, fc1 C -> hidden, fc2) over the
    tokens and its windowed attention; ~3.57 TFLOP at 270 x 480 -> x4."""
    hp, wp = padded(cfg, h, w)
    c = cfg["embed_dim"]
    hidden = int(c * cfg["mlp_ratio"])
    gemm = 2 * hp * wp * c * (3 * c + c + 2 * hidden)
    layers = sum(d * (gemm + window_attention_work(cfg, h, w, "bfloat16",
                                                   heads)[0])
                 for d, heads in zip(cfg["depths"], cfg["num_heads"]))
    return sum(cv.fwd_flops() for cv in swinir_convs(cfg, h, w)) + layers


KERNEL_A = ("conv_up", "conv_hr")


def kernel_a_launches(cfg: dict, h: int, w: int,
                      dtype: str) -> list[tuple[str, float, float]]:
    """Kernel A's launches of one frame as (kernel, operations, bytes):
    the tail's 64 -> 64 convs (the program runs the convs at embed_dim
    channels, conv_first and conv_last on cuDNN); x read once, y written
    once, the weights once."""
    b = ITEMSIZE[dtype]
    return [("A", cv.fwd_flops(),
             (cv.h * cv.w * (cv.cin + cv.cout) + 9 * cv.cin * cv.cout) * b)
            for cv in swinir_convs(cfg, h, w) if cv.name.startswith(KERNEL_A)]
