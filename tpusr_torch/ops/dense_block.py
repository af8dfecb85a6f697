"""One whole ESRGAN dense block per kernel launch (the RRDB trunk).

Counterpart of ``tpusr/ops/pallas_dense.py``. A dense block is

    c1 = lrelu(conv3x3(x) + b1)
    c2 = lrelu(conv3x3([x, c1]) + b2)   ...   c4 = lrelu(conv3x3([x, c1..c3]) + b4)
    c5 = conv3x3([x, c1..c4]) + b5
    y  = x + 0.2 * c5

with zero-SAME halos and LeakyReLU slope 0.2, growth 32 on a 64-channel
trunk. Kernel C (``tpusr_torch/csrc/dense_block.cu``, CUDA C++ for sm_90a)
computes it in one launch on the tensor cores: x is read once, y written
once, and c1..c4 stay in shared memory. Each block owns one output tile
(``TILE``: 16 x 16 in bf16 on wgmma, 8 x 8 in f32 on 3xTF32 mma.sync) and
computes each stage on its region, the tile grown by the remaining halo.

The kernel reads the weights as 52 packed units (``pack_weights``: per
stage, per 16-channel chunk and per 32 outputs, 9 taps x 16 x 32 in the
layout of the kernel's shared-memory slot), in the input's dtype. The
packing is cached against the kernels' identity, storage and version, so a
network's blocks pack once and later calls add no device work.

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
import weakref

import torch
import torch.nn.functional as F

NF, GC = 64, 32
# the kernel's geometry (csrc/dense_block.cu): output tile (rows, columns)
# per dtype, input channels per chunk, outputs per weight unit, units
TILE = {torch.bfloat16: (16, 16), torch.float32: (8, 8)}
KC, UNIT_N, NUNITS = 16, 32, 52
# rows of a stage's M that the kernel pads to: wgmma's 64, mma.sync's 16
M_PAD = {torch.bfloat16: 64, torch.float32: 16}
USEFUL_MACS = 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64)


def recompute_factor(dtype) -> float:
    """Multiply-adds kernel C computes per output pixel over the 239,616
    a dense block needs: every stage on its region of the tile (the tile
    grown by the remaining halo), M padded at its end."""
    th, tw = TILE[dtype]
    macs = 0
    for s in range(1, 6):
        npix = (th + 2 * (5 - s)) * (tw + 2 * (5 - s))
        rows = -(-npix // M_PAD[dtype]) * M_PAD[dtype]
        macs += rows * 9 * (NF + GC * (s - 1)) * (GC if s < 5 else NF)
    return macs / (th * tw) / USEFUL_MACS


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


# ------------------------------------------------------------ weight units
def pack_weights(kernels, dtype):
    """The kernel's weight units, flat, in dtype: for each stage, each
    16-channel chunk and each 32 outputs (stage 5 has two), the 9 x 16 x 32
    slab laid out as the kernel's slot: bf16 [tap][k // 8][n // 8][k % 8]
    [n % 8] (wgmma's N-major B, 8 x 8 core matrices), f32 [tap][k // 4][n]
    [k % 4] (ldmatrix rows of mma.sync's B fragments)."""
    units = []
    for k in kernels:
        cin, cout = k.shape[2], k.shape[3]
        nch, nh = cin // KC, cout // UNIT_N
        w = k.to(dtype).reshape(9, nch, KC, nh, UNIT_N).permute(1, 3, 0, 2, 4)
        if dtype == torch.bfloat16:  # (c, h, t, kp, k8, nb, n8) -> kp, nb, k8
            w = w.reshape(nch, nh, 9, 2, 8, 4, 8).permute(0, 1, 2, 3, 5, 4, 6)
        else:  # (c, h, t, kp, k4, n) -> kp, n, k4
            w = w.reshape(nch, nh, 9, 4, 4, UNIT_N).permute(0, 1, 2, 3, 5, 4)
        units.append(w.reshape(-1))
    return torch.cat(units)


_PACKED: dict = {}  # id of kernel 1 -> (state of the 5 kernels, packed)
_PACKED_MAX = 256   # a 23-block RRDBNet in both dtypes holds 138


def _state(kernels, dtype):
    return tuple((weakref.ref(k), k.data_ptr(), k._version, k.dtype)
                 for k in kernels) + (dtype,)


def _same(state, kernels, dtype):
    return state[-1] == dtype and all(
        r() is k and (p, v, d) == (k.data_ptr(), k._version, k.dtype)
        for (r, p, v, d), k in zip(state[:-1], kernels))


def packed_weights(kernels, dtype):
    """pack_weights, cached while the kernels are alive and unchanged (same
    storage, same version). Inference tensors have no version counter: they
    are packed on every call."""
    if any(k.is_inference() for k in kernels):
        return pack_weights(kernels, dtype)
    key = (id(kernels[0]), dtype)
    hit = _PACKED.get(key)
    if hit is not None and _same(hit[0], kernels, dtype):
        return hit[1]
    for kk in [kk for kk, (st, _) in _PACKED.items() if st[0][0]() is None]:
        del _PACKED[kk]
    while len(_PACKED) >= _PACKED_MAX:
        del _PACKED[next(iter(_PACKED))]
    with torch.no_grad():
        packed = pack_weights(kernels, dtype)
    _PACKED[key] = (_state(kernels, dtype), packed)
    return packed


# ------------------------------------------------------------ CUDA launcher
def _lib():
    from tpusr_torch.ops._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_tpusr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tpusr_dense_block.argtypes = [ci, ci] + [vp] * 8 + [ci] * 3 + [vp]
        lib.tpusr_dense_block.restype = ci
        lib._tpusr_typed = True
    return lib


def _dense_block_cuda(x, kernels, biases):
    _check(x.is_cuda, "the kernel takes CUDA tensors")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} not in float32/bfloat16")
    _check(x.is_contiguous(), "x must be contiguous NHWC")
    n, h, w, _ = x.shape
    _check(n <= 65535 and x.numel() < 2 ** 31, "tensor too large")
    _check(all(t.device == x.device for t in list(kernels) + list(biases)),
           "kernels and biases must be on x's device")
    if x.data_ptr() % 16:  # the kernel reads x by 16-byte copies
        x = x.clone()
    wp = packed_weights(kernels, x.dtype)
    bs = [b.to(torch.float32).contiguous() for b in biases]
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().tpusr_dense_block(
        x.device.index or 0, _DTYPES[x.dtype], x.data_ptr(), wp.data_ptr(),
        *(t.data_ptr() for t in bs), y.data_ptr(), n, h, w,
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
