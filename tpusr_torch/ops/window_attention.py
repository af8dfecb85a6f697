"""Windowed multi-head self-attention of SwinIR's Swin layers.

``window_attention(qkv, table, hw, heads, shift)`` takes the qkv GEMM's
output in the image's token order, (B, Hp*Wp, 3C) with C = heads * hd, and
returns each token's attention output at the token's own place, (B,
Hp*Wp, C): the published chain (``models/network_swinir.py``'s
``SwinTransformerBlock`` and ``WindowAttention``) of

  roll by (-shift, -shift) -> 8 x 8 window partition -> per window and
  head softmax(q k^T hd^-1/2 + B + M) v -> window reverse -> roll back

where B is gathered from the (15^2, heads) relative-position ``table`` by
the published ``relative_position_index`` and M is the published shifted-
window mask, -100 between tokens of different regions (shift > 0 only).

On a CUDA tensor it is one launch of a hand-written kernel
(``tpusr_torch/csrc/window_attention.cu``, CUDA C++ for sm_90a: one block
a window, mma.sync products, the softmax in f32 registers, the shift, bias
and mask in its addressing, so no rolled, partitioned or reversed copy and
no score tensor reaches device memory). On a CPU tensor, and on a card
under ``plain=True`` (the models' fusion 'off'), it runs the plain chain
above as the published code writes it, in f32 (f64 stays f64), rounded
once to the input's dtype. ``LAUNCHES['window_attention']`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"window_attention": 0}
WINDOW = 8  # the kernel's window side (SwinIR's window_size)
MASK = -100.0  # the published mask value
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "window_attention.cu"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------- plain version
def relative_position_index(window: int = WINDOW,
                            device=None) -> torch.Tensor:
    """The published (window^2, window^2) index into the bias table:
    (ri - rj + w - 1) (2w - 1) + (ci - cj + w - 1)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).to(device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window, window, C), the published order."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int,
                   w: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    b = windows.shape[0] // (h * w // window // window)
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def shifted_window_mask(hw: tuple[int, int], window: int, shift: int,
                        device=None) -> torch.Tensor:
    """The published ``calculate_mask``: (nW, window^2, window^2), -100
    between tokens of different regions of the shifted image, 0 else."""
    h, w = hw
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[:, hs, ws, :] = cnt
            cnt += 1
    ids = window_partition(img, window).view(-1, window * window)
    mask = ids[:, None, :] - ids[:, :, None]
    return mask.masked_fill(mask != 0, MASK).masked_fill(mask == 0, 0.0)


def window_attention_reference(qkv, table, hw, heads: int, shift: int = 0,
                               window: int = WINDOW) -> torch.Tensor:
    """The plain chain, in f32 (f64 for f64), out in qkv's dtype."""
    b, n, c3 = qkv.shape
    h, w = hw
    c = c3 // 3
    hd = c // heads
    acc = torch.promote_types(qkv.dtype, torch.float32)
    x = qkv.to(acc).view(b, h, w, c3)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    nt = window * window
    win = window_partition(x, window).view(-1, nt, 3, heads, hd)
    q, k, v = win.permute(2, 0, 3, 1, 4)
    q = q * hd ** -0.5
    attn = q @ k.transpose(-2, -1)
    index = relative_position_index(window, qkv.device)
    bias = table.to(acc)[index.view(-1)].view(nt, nt, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if shift:
        mask = shifted_window_mask(hw, window, shift, qkv.device).to(acc)
        nw = mask.shape[0]
        attn = attn.view(-1, nw, heads, nt, nt) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, nt, nt)
    attn = attn.softmax(-1)
    out = (attn @ v).transpose(1, 2).reshape(-1, window, window, c)
    out = window_reverse(out, window, h, w)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
    return out.reshape(b, n, c).to(qkv.dtype)


# ------------------------------------------------------------ CUDA launcher
def _lib():
    from tpusr_torch.ops._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_tpusr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tpusr_window_attention.argtypes = (
            [ci, ci] + [vp] * 3 + [ci] * 6 + [ctypes.c_float, vp])
        lib.tpusr_window_attention.restype = ci
        lib._tpusr_typed = True
    return lib


def _check(cond, msg):
    if not cond:
        raise ValueError(f"window_attention: {msg}")


def _cuda(qkv, table, hw, heads, shift):
    b, n, c3 = qkv.shape
    h, w = hw
    c = c3 // 3
    _check(qkv.dtype in _DTYPES, f"dtype {qkv.dtype} not in float32/bfloat16")
    _check(qkv.is_contiguous() and qkv.data_ptr() % 16 == 0,
           "qkv must be contiguous and 16-byte aligned")
    _check(h % WINDOW == 0 and w % WINDOW == 0 and n == h * w,
           f"the image {hw} must be whole {WINDOW} x {WINDOW} windows of "
           f"{n} tokens")
    _check(c3 % 3 == 0 and c % heads == 0, f"3C = {c3} is no 3 heads x hd")
    hd = c // heads
    _check(hd % 2 == 0 and hd <= 32 and c % 4 == 0,
           f"head dimension {hd} (even, at most 32) and C = {c} (a multiple "
           f"of 4) out of the kernel's range")
    _check(0 <= shift < WINDOW, f"shift {shift} not in [0, {WINDOW})")
    _check(table.device == qkv.device and table.dtype == torch.float32
           and tuple(table.shape) == ((2 * WINDOW - 1) ** 2, heads),
           f"table must be f32 ({(2 * WINDOW - 1) ** 2}, {heads}) on qkv's "
           f"device")
    table = table.contiguous()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = _lib().tpusr_window_attention(
        qkv.device.index or 0, _DTYPES[qkv.dtype],
        ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(table.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), b, h, w, heads, hd, shift,
        hd ** -0.5, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"window_attention launch failed: CUDA error {rc}")
    LAUNCHES["window_attention"] += 1
    return out


def window_attention(qkv: torch.Tensor, table: torch.Tensor,
                     hw: tuple[int, int], heads: int, shift: int = 0,
                     plain: bool = False) -> torch.Tensor:
    """(B, Hp*Wp, 3C) qkv in image token order -> (B, Hp*Wp, C): the kernel
    on a CUDA tensor, the plain chain on a CPU tensor or under ``plain``."""
    if plain or qkv.device.type == "cpu":
        return window_attention_reference(qkv, table, hw, heads, shift)
    return _cuda(qkv, table, hw, heads, shift)
