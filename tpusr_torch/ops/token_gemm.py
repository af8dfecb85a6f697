"""SwinIR's token linears: the four products of a Swin layer with their
pointwise work.

``token_linear(x, weight, bias, residual=None, gelu=False, packed=None)``
on (..., K) tokens and an nn.Linear's (N, K) weight and (N,) bias is

    residual + F.linear(x, weight, bias)   (proj, fc2: residual given)
    F.gelu(F.linear(x, weight, bias))      (fc1: gelu)
    F.linear(x, weight, bias)              (qkv)

Given ``packed``, its weights as ``pack`` lays them out, it is one launch
of a hand-written kernel on bf16 CUDA tensors
(``tpusr_torch/csrc/token_gemm.cu``, CUDA C++ for sm_90a: wgmma products
from weights resident in shared memory, each 64-row tile of x read once by
one bulk copy, the bias, residual add and GELU finished on the f32
accumulator and rounded to bf16 once, at the store). Without ``packed`` it
runs the plain chain above, operation for operation as the Swin layer
wrote it before the kernel: the caller decides the route once, by packing
or not (``on_kernel``; SwinIR packs once a forward, on a card in bf16 and
not under fusion 'off'). ``LAUNCHES['token_gemm']`` counts the kernel's
launches.

The kernel is built for the products in ``PLANS``, SwinIR-M's four. It
reads the weights packed: a product's N columns cut into ``splits`` slices
of ``chunks`` x 96 columns, K padded with zeros to whole 16-deep k-steps,
each slice laid out as [k-step][8-column group][k half][8 n][8 k] (wgmma's
K-major core matrices without swizzle); the padded columns and k are zero.
``pack`` takes a stack of weights, (..., N, K), so a model packs all its
layers' weights of one kind in one call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = {"token_gemm": 0}
PRODUCT_COLS = 96  # columns of one wgmma product (m64n96k16)
K_STEP = 16
_EPILOGUES = {"bias": 0, "residual": 1, "gelu": 2}
# (N, K, epilogue) -> (k-steps, chunks, splits): the kernel's instances,
# SwinIR-M's four products at embed 180 and mlp ratio 2. A block keeps one
# slice of ``chunks`` 96-column products resident: with a residual the
# epilogue holds every chunk's residual pairs (two), past 12 k-steps the
# weights fill shared memory (one), else three; N takes ``splits`` slices.
PLANS = {(540, 180, "bias"): (12, 3, 2),  # qkv
         (180, 180, "residual"): (12, 2, 1),  # proj
         (360, 180, "gelu"): (12, 2, 2),  # fc1
         (180, 360, "residual"): (23, 1, 2)}  # fc2
_SOURCE = "token_gemm.cu"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------- plain version
def token_linear_reference(x, weight, bias, residual=None, gelu=False):
    """The chain the kernel replaces, as the Swin layer wrote it."""
    y = F.linear(x, weight, bias)
    if gelu:
        y = F.gelu(y)
    if residual is not None:
        y = residual + y
    return y


# ------------------------------------------------------------ packing
def _plan(n: int, k: int, epilogue: str) -> tuple[int, int, int]:
    plan = PLANS.get((n, k, epilogue))
    if plan is None:
        _refuse(f"K {k} -> N {n} with the {epilogue} epilogue is none of "
                f"the kernel's instances (SwinIR-M's 180 -> 540, 180 -> 180 "
                f"+ residual, 180 -> 360 + GELU, 360 -> 180 + residual)")
    return plan


def pack(weight: torch.Tensor, epilogue: str) -> torch.Tensor:
    """(..., N, K) weights of the product with this epilogue -> (...,
    splits, k-steps, chunks * 12, 2, 8, 8), the kernel's layout (the
    module's docstring), in weight's dtype."""
    *lead, n, k = weight.shape
    ks, chunks, splits = _plan(n, k, epilogue)
    nr = chunks * PRODUCT_COLS
    w = F.pad(weight, (0, ks * K_STEP - k, 0, splits * nr - n))
    w = w.reshape(*lead, splits, nr // 8, 8, ks, 2, 8)
    d = len(lead)
    order = [*range(d), d, d + 3, d + 1, d + 4, d + 2, d + 5]
    return w.permute(order).contiguous()


# ------------------------------------------------------------ CUDA launcher
def _lib():
    from tpusr_torch.ops._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_tpusr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tpusr_token_gemm.argtypes = [ci] * 5 + [vp] * 5 + [ci] * 3 + [vp]
        lib.tpusr_token_gemm.restype = ci
        lib._tpusr_typed = True
    return lib


def _refuse(msg):
    raise ValueError(f"token_gemm: {msg}")


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _cuda(x, weight, bias, residual, gelu, packed):
    """One launch of the kernel; raises on what it does not take: dtypes,
    shapes, layouts and devices, which may differ between calls (the plan
    is PLANS'). The messages are made only to raise: this runs 144 times a
    frame on the host."""
    bf = torch.bfloat16
    if not (x.dtype == bias.dtype == packed.dtype == bf
            and (residual is None or residual.dtype == bf)):
        _refuse(f"dtype {x.dtype} (bias {bias.dtype}, packed {packed.dtype}"
                f"{'' if residual is None else f', residual {residual.dtype}'}"
                f") is not bfloat16")
    if residual is not None and gelu:
        _refuse("a residual and GELU together is no product of a Swin layer")
    if not (x.dim() >= 2 and weight.dim() == 2):
        _refuse(f"x {tuple(x.shape)} must be (..., K) tokens and weight "
                f"{tuple(weight.shape)} (N, K)")
    n, k = weight.shape
    if not (x.shape[-1] == k and bias.shape == (n,)):
        _refuse(f"shapes x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                f"bias {tuple(bias.shape)} do not make (..., K) x (N, K)^T "
                f"+ (N,)")
    epi = "residual" if residual is not None else "gelu" if gelu else "bias"
    ks, chunks, splits = _plan(n, k, epi)
    out_shape = (*x.shape[:-1], n)
    if residual is not None and residual.shape != out_shape:
        _refuse(f"residual {tuple(residual.shape)} is not the output's "
                f"{out_shape}")
    if packed.shape != (splits, ks, chunks * PRODUCT_COLS // 8, 2, 8, 8):
        _refuse(f"packed weights {tuple(packed.shape)} are not pack()'s for "
                f"({n}, {k})")
    if not (_aligned(x) and _aligned(packed)
            and (residual is None or _aligned(residual))
            and bias.is_contiguous()):
        _refuse("x, the residual and the packed weights must be contiguous "
                "and 16-byte aligned, the bias contiguous")
    dev = x.device
    if not (x.is_cuda and bias.device == dev and packed.device == dev
            and (residual is None or residual.device == dev)):
        _refuse("every operand must be a CUDA tensor on x's device")
    out = torch.empty(out_shape, dtype=bf, device=dev)
    m = x.numel() // k
    if m == 0:
        return out
    rc = _lib().tpusr_token_gemm(
        dev.index, ks, chunks, splits, _EPILOGUES[epi], x.data_ptr(),
        packed.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        m, n, k, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"token_gemm launch failed: CUDA error {rc}")
    LAUNCHES["token_gemm"] += 1
    return out


def on_kernel(x: torch.Tensor) -> bool:
    """Whether x's products can take the kernel: bf16 tokens on a card."""
    return x.is_cuda and x.dtype == torch.bfloat16


def token_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 residual: torch.Tensor | None = None, gelu: bool = False,
                 packed: torch.Tensor | None = None) -> torch.Tensor:
    """(..., K) tokens -> (..., N): one launch of the kernel given
    ``packed`` (``pack(weight, epilogue)``), the plain chain without it."""
    if packed is None:
        return token_linear_reference(x, weight, bias, residual, gelu)
    return _cuda(x, weight, bias, residual, gelu, packed)
