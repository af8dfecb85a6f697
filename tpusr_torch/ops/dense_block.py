"""One whole ESRGAN dense block per kernel launch (the RRDB trunk).

Counterpart of ``tpusr/ops/pallas_dense.py``. A dense block is

    c1 = lrelu(conv3x3(x) + b1)
    c2 = lrelu(conv3x3([x, c1]) + b2)   ...   c4 = lrelu(conv3x3([x, c1..c3]) + b4)
    c5 = conv3x3([x, c1..c4]) + b5
    y  = x + 0.2 * c5

with zero-SAME halos and LeakyReLU slope 0.2, growth 32 on a 64-channel
trunk. Kernel C (``tpusr_torch/csrc/dense_block.cu``, CUDA C++ for sm_90a)
computes it in one launch: x is read once, y written once, and c1..c4 stay
in shared memory.

Layout: NHWC ``(N, H, W, 64)`` activations for every N, H, W >= 1, and the
five canonical HWIO kernels ``(3, 3, 64 + 32 (k - 1), 32 | 64)`` with f32
biases, the JAX package's parameter layout. The TPU kernel's lane and row
padding and its shape gates belong to the TPU and have no counterpart here.

``dense_block`` launches kernel C for a CUDA tensor (raising on what it does
not take) and runs the plain version for a CPU tensor. Its backward
recomputes through the plain version, as the JAX custom VJP does: the
kernel has no backward of its own. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

NF, GC = 64, 32

LAUNCHES = {"dense_block": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "dense_block.cu"


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(cond, msg):
    if not cond:
        raise ValueError(f"dense_block: {msg}")


def _check_params(x, kernels, biases):
    _check(x.dim() == 4 and x.shape[-1] == NF and min(x.shape) >= 1,
           f"x must be (N,H,W,{NF}) with N,H,W >= 1, got {tuple(x.shape)}")
    _check(len(kernels) == 5 and len(biases) == 5,
           "takes the 5 canonical kernels and 5 biases")
    for i, (k, b) in enumerate(zip(kernels, biases)):
        cout = GC if i < 4 else NF
        _check(tuple(k.shape) == (3, 3, NF + GC * i, cout),
               f"kernel {i + 1} must be (3,3,{NF + GC * i},{cout}), "
               f"got {tuple(k.shape)}")
        _check(tuple(b.shape) == (cout,),
               f"bias {i + 1} must be ({cout},), got {tuple(b.shape)}")


# ------------------------------------------------------------- plain version
def dense_block_reference(x, kernels, biases):
    """Plain version of kernel C: the canonical 5-conv concat form.

    Accumulates in f32 (f64 inputs stay f64, an exact yardstick for the f32
    kernel). Weights are rounded through x's dtype, biases are not; c1..c4
    and y are rounded to x's dtype where the kernel stores them.
    """
    acc = torch.promote_types(x.dtype, torch.float32)
    ks = [k.to(x.dtype).to(acc).permute(3, 2, 0, 1) for k in kernels]
    bs = [b.to(acc) for b in biases]
    a = x.permute(0, 3, 1, 2).to(acc)
    srcs = [a]
    for k, b in zip(ks[:4], bs[:4]):
        c = F.leaky_relu(F.conv2d(torch.cat(srcs, 1), k, b, padding=1), 0.2)
        srcs.append(c.to(x.dtype).to(acc))
    c5 = F.conv2d(torch.cat(srcs, 1), ks[4], bs[4], padding=1)
    return (a + 0.2 * c5).to(x.dtype).permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------ CUDA launcher
def _lib():
    from tpusr_torch.ops._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_tpusr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tpusr_dense_block.argtypes = [ci, ci] + [vp] * 12 + [ci] * 3 + [vp]
        lib.tpusr_dense_block.restype = ci
        lib._tpusr_typed = True
    return lib


def _dense_block_cuda(x, kernels, biases):
    _check(x.is_cuda, "the kernel takes CUDA tensors")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} not in float32/bfloat16")
    _check(x.is_contiguous(), "x must be contiguous NHWC")
    n, h, w, _ = x.shape
    _check(n <= 65535 and x.numel() < 2 ** 31, "tensor too large")
    # f32 parameters as the kernel reads them (no copy for f32 parameters);
    # in bf16 the kernel rounds the weights as it stages them
    ks = [k.to(torch.float32).contiguous() for k in kernels]
    bs = [b.to(torch.float32).contiguous() for b in biases]
    _check(all(t.device == x.device for t in ks + bs),
           "kernels and biases must be on x's device")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().tpusr_dense_block(
        x.device.index or 0, _DTYPES[x.dtype], x.data_ptr(),
        *(t.data_ptr() for t in ks + bs), y.data_ptr(), n, h, w,
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"dense_block launch failed: CUDA error {rc}")
    LAUNCHES["dense_block"] += 1
    return y


# ------------------------------------------------------------------ wrapper
class DenseBlockFn(torch.autograd.Function):
    """Kernel C forward; backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, x, *params):
        kernels, biases = params[:5], params[5:]
        ctx.save_for_backward(x, *params)
        if x.device.type == "cpu":
            return dense_block_reference(x, kernels, biases)
        return _dense_block_cuda(x, kernels, biases)

    @staticmethod
    def backward(ctx, gy):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = dense_block_reference(leaves[0], leaves[1:6], leaves[6:])
        return torch.autograd.grad(y, leaves, gy)


def dense_block(x, kernels, biases):
    """y = x + 0.2 * c5 of one dense block, differentiable.

    x: (N, H, W, 64) f32/bf16, contiguous NHWC on CUDA; kernels: the 5
    canonical HWIO kernels; biases: the 5 biases (f32). Kernel C on a CUDA
    tensor, the plain version on a CPU tensor.
    """
    _check_params(x, kernels, biases)
    return DenseBlockFn.apply(x, *kernels, *biases)
