"""BatchNorm + LeakyReLU glue of the DIP skip net's fused dataflow.

The skip net's train-mode BatchNorms (``models/skip.py`` with conv_fusion
'auto') do three things over a large channels_last activation x: the
per-channel moments E[x], E[x^2]; the normalize and activation
y = act(x * es + eb); and their backward. Eager PyTorch runs each as a
chain of ATen kernels, several passes over x each. Here each is one pass,
a hand-written kernel (``tpusr_torch/csrc/bn_act.cu``, CUDA C++ for
sm_90a, bounded by bytes), on NCHW tensors in channels_last memory:

  * ``channel_moments(x)`` -> (E[x], E[x^2], fold): Σx and Σx² per channel
    in one read (per-block partials, summed in a fixed order: no float
    atomics); its backward writes dx = (dm1 + 2 x dm2) / n in one pass.
  * ``affine_act(x, es, eb, act)``: y = act(x * es + eb), act 'leaky_relu'
    (slope 0.2) or None, one read and one write; its backward is
  * ``prologue_backward(g, x, es, eb, act)`` (NHWC): d = g act'(x es + eb),
    dx = d es and des = Σ d x, deb = Σ d, in one pass over g and x. Kernel
    A's prologue is the same function of x, so ``FusedConv3x3``'s backward
    calls it too.

**Fold.** Where the x that a BatchNorm takes its moments of is the x that
its normalize (``affine_act``, or kernel A's prologue) reads, autograd
would add two full-size gradients of x. ``channel_moments`` returns a
``Fold`` for that one consumer: the consumer's backward then makes only the
reduce pass (des, deb) and leaves (g, es, eb, act) in the fold, and the
moments' backward, which autograd runs after it (es and eb depend on the
moments), writes the whole dx in one pass: the classic two-pass BatchNorm
backward, with the C-sized statistics code between the passes left to
autograd. A consumer that never runs its backward leaves the moments'
backward its own term alone.

On a CPU tensor each function runs its plain version beside it, the eager
operations the skip net ran before these kernels, in the same order, so
every CPU result is what it was; on a CUDA tensor it launches the kernel or
raises. ``LAUNCHES`` counts each kernel's launches (a captured CUDA graph
counts at capture; ``engine/dip.py`` adds its launches at every replay).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

LAUNCHES = {"channel_moments": 0, "affine_act": 0, "affine_act_grad": 0,
            "moments_grad": 0, "partials_sum": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = (None, "leaky_relu")
_SOURCE = "bn_act.cu"
SLOPE = 0.2  # LeakyReLU's, as bn_act.cu's SLOPE

# The kernels' launch shape, as the constexprs of bn_act.cu hold them
NTHREADS = 256  # threads a block
BLOCKS_PER_SM = 4  # blocks over pixels, per SM in all: partials per launch


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ launch geometry
def vec_width(c: int, dtype, *ptrs: int) -> int:
    """Channels a thread owns: the widest of 8 (bf16), 4 or 1 that divides
    C and to whose bytes every pointer is aligned (16 bytes at most)."""
    size = 2 if dtype == torch.bfloat16 else 4
    for v in ((8, 4, 1) if dtype == torch.bfloat16 else (4, 1)):
        if c % v == 0 and all(p % (v * size) == 0 for p in ptrs):
            return v
    raise AssertionError("unreachable: a width of 1 always fits")


def launch_geometry(p: int, c: int, vec: int, sms: int) -> tuple[int, int]:
    """(bx, grid_x): threads of a block over channel vectors, the largest
    power of 2 up to 32 and C / vec, and blocks over pixels, about
    BLOCKS_PER_SM per SM in all and no more than the pixels fill. grid_x
    is also the number of partials a reduction writes."""
    cv = c // vec
    bx = 1 << min(5, cv.bit_length() - 1)
    by = NTHREADS // bx
    grid_y = -(-cv // bx)
    return bx, max(1, min(-(-p // by), BLOCKS_PER_SM * sms // grid_y))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------------------------------------------------- plain versions
def channel_moments_reference(x):
    """E[x] and E[x^2] per channel over (N, H, W) of an NCHW tensor, in f32
    (an f64 x stays f64): ``models/layers.py``'s eager moments."""
    dims = (0, 2, 3)
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.mean(dims, dtype=acc), x.square().mean(dims, dtype=acc)


def affine_act_reference(x, es, eb, act=None):
    """act(x * es + eb) of an NCHW tensor in x's dtype: BatchNorm's
    normalize, then the skip net's activation."""
    y = x * es.to(x.dtype).view(1, -1, 1, 1) + eb.to(x.dtype).view(1, -1, 1, 1)
    return F.leaky_relu(y, SLOPE) if act == "leaky_relu" else y


def prologue_backward_reference(g, x, es, eb, act=None):
    """(dx, des, deb) of act(x * es + eb) under the cotangent g, NHWC: the
    prologue backward of ``FusedConv3x3``; des and deb in f32 (f64 for an
    f64 x)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    dpre = g
    if act == "leaky_relu":
        a0 = x * es.to(x.dtype) + eb.to(x.dtype)
        dpre = torch.where(a0 >= 0, g, g * SLOPE)
    dx = dpre * es.to(x.dtype)
    return (dx, (dpre.to(acc) * x.to(acc)).sum((0, 1, 2)),
            dpre.to(acc).sum((0, 1, 2)))


# ------------------------------------------------------------ CUDA launchers
def _lib():
    from tpusr_torch.ops._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_tpusr_typed", False):
        vp, ci, ll, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
        lib.tpusr_channel_moments.argtypes = (
            [ci, ci] + [vp] * 4 + [ll] + [ci] * 4 + [cf, vp])
        lib.tpusr_affine_act.argtypes = [ci, ci] + [vp] * 4 + [ll] + [ci] * 5 + [vp]
        lib.tpusr_affine_act_grad.argtypes = (
            [ci, ci] + [vp] * 8 + [ll] + [ci] * 5 + [vp])
        lib.tpusr_moments_grad.argtypes = (
            [ci, ci] + [vp] * 7 + [ll] + [ci] * 4 + [cf, ci, vp])
        for fn in (lib.tpusr_channel_moments, lib.tpusr_affine_act,
                   lib.tpusr_affine_act_grad, lib.tpusr_moments_grad):
            fn.restype = ci
        lib._tpusr_typed = True
    return lib


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(cond, msg):
    if not cond:
        raise ValueError(f"bn_act: {msg}")


def _check_x(x, act=None):
    _check(x.is_cuda, "the kernels take CUDA tensors")
    _check(x.dim() == 4, f"x must be (N,H,W,C), got {tuple(x.shape)}")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} not in float32/bfloat16")
    _check(x.is_contiguous(), "x must be contiguous NHWC")
    _check(x.numel() >= 1, f"shape {tuple(x.shape)} is empty")
    _check(act in _ACTS, f"act {act!r} not in {_ACTS}")


def _check_like(t, x, name):
    _check(t.device == x.device and t.dtype == x.dtype and t.shape == x.shape
           and t.is_contiguous(),
           f"{name} must be contiguous NHWC, x's shape and dtype")


def _check_vec(v, x, name):
    _check(v.device == x.device and v.dtype == torch.float32
           and v.shape == (x.shape[-1],) and v.is_contiguous(),
           f"{name} must be contiguous f32 (C,) on x's device")


def _launch(fn, name, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _geometry(x, *others):
    """(device, dtype code, P, C, vec, bx, grid_x, stream) of a launch over
    x and the same-shaped tensors ``others``."""
    p, c = x.numel() // x.shape[-1], x.shape[-1]
    vec = vec_width(c, x.dtype, *(t.data_ptr() for t in (x, *others)))
    index = x.device.index or 0
    bx, grid_x = launch_geometry(p, c, vec, _sms(index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return index, _DTYPES[x.dtype], p, c, vec, bx, grid_x, ctypes.c_void_p(stream)


def _moments_cuda(x):
    """(E[x], E[x^2]) per channel of NHWC x, (C,) f32 each."""
    _check_x(x)
    dev, dt, p, c, vec, bx, gx, stream = _geometry(x)
    part = torch.empty((gx, 2, c), dtype=torch.float32, device=x.device)
    m1, m2 = (torch.empty(c, dtype=torch.float32, device=x.device)
              for _ in range(2))
    _launch(_lib().tpusr_channel_moments, "channel_moments", dev, dt, _ptr(x),
            _ptr(part), _ptr(m1), _ptr(m2), p, c, vec, bx, gx, 1.0 / p, stream)
    LAUNCHES["channel_moments"] += 1
    LAUNCHES["partials_sum"] += 1
    return m1, m2


def _affine_act_cuda(x, es, eb, act):
    """act(x * es + eb) of NHWC x."""
    _check_x(x, act)
    _check_vec(es, x, "eff_scale")
    _check_vec(eb, x, "eff_bias")
    y = torch.empty_like(x)
    dev, dt, p, c, vec, bx, gx, stream = _geometry(x, y)
    _launch(_lib().tpusr_affine_act, "affine_act", dev, dt, _ptr(x), _ptr(es),
            _ptr(eb), _ptr(y), p, c, vec, bx, gx, int(act == "leaky_relu"),
            stream)
    LAUNCHES["affine_act"] += 1
    return y


def _affine_act_grad_cuda(g, x, es, eb, act, want_dx):
    """(dx or None, des, deb) of act(x * es + eb) under g, NHWC."""
    _check_x(x, act)
    _check_like(g, x, "g")
    _check_vec(es, x, "eff_scale")
    _check_vec(eb, x, "eff_bias")
    dx = torch.empty_like(x) if want_dx else None
    dev, dt, p, c, vec, bx, gx, stream = _geometry(
        x, g, *([dx] if want_dx else []))
    part = torch.empty((gx, 2, c), dtype=torch.float32, device=x.device)
    des, deb = (torch.empty(c, dtype=torch.float32, device=x.device)
                for _ in range(2))
    _launch(_lib().tpusr_affine_act_grad, "affine_act_grad", dev, dt, _ptr(g),
            _ptr(x), _ptr(es), _ptr(eb), _ptr(dx), _ptr(part), _ptr(des),
            _ptr(deb), p, c, vec, bx, gx, int(act == "leaky_relu"), stream)
    LAUNCHES["affine_act_grad"] += 1
    LAUNCHES["partials_sum"] += 1
    return dx, des, deb


def _moments_grad_cuda(x, dm1, dm2, pending=None):
    """dx of (E[x], E[x^2]) under (dm1, dm2), NHWC, plus the backward a
    consumer left in the fold: ``pending`` = (g, es, eb, act) or None."""
    g, es, eb, act = pending if pending is not None else (None,) * 4
    _check_x(x, act)
    dm1, dm2 = (d.float().contiguous() for d in (dm1, dm2))
    _check_vec(dm1, x, "dm1")
    _check_vec(dm2, x, "dm2")
    if g is not None:
        _check_like(g, x, "g")
        _check_vec(es, x, "eff_scale")
        _check_vec(eb, x, "eff_bias")
    dx = torch.empty_like(x)
    dev, dt, p, c, vec, bx, gx, stream = _geometry(
        x, dx, *([g] if g is not None else []))
    _launch(_lib().tpusr_moments_grad, "moments_grad", dev, dt, _ptr(x),
            _ptr(g), _ptr(es), _ptr(eb), _ptr(dm1), _ptr(dm2), _ptr(dx), p, c,
            vec, bx, gx, 1.0 / p, int(act == "leaky_relu"), stream)
    LAUNCHES["moments_grad"] += 1
    return dx


# ------------------------------------------------------------------ autograd
def _nhwc(x):
    """NHWC view of an NCHW tensor; no copy when it is channels_last."""
    return x.permute(0, 2, 3, 1).contiguous()


class Fold:
    """The hand-off from one consumer's backward to the moments' backward
    of the same x (the module docstring): ``put`` by the consumer, ``take``
    by the moments, once per backward."""

    __slots__ = ("pending",)

    def __init__(self):
        self.pending = None

    def put(self, g, es, eb, act) -> None:
        if self.pending is not None:
            raise RuntimeError("a Fold takes one consumer's backward")
        self.pending = (g, es, eb, act)

    def take(self):
        pending, self.pending = self.pending, None
        return pending


class ChannelMoments(torch.autograd.Function):
    """(E[x], E[x^2]) of an NCHW channels_last x on the card; the backward
    writes dx in one pass, with the fold's consumer term when it holds one."""

    @staticmethod
    def forward(ctx, x, fold):
        xh = _nhwc(x)
        m1, m2 = _moments_cuda(xh)
        ctx.save_for_backward(xh)
        ctx.fold = fold
        return m1, m2

    @staticmethod
    def backward(ctx, dm1, dm2):
        (xh,) = ctx.saved_tensors
        pending = None if ctx.fold is None else ctx.fold.take()
        dx = _moments_grad_cuda(xh, dm1, dm2, pending)
        return dx.permute(0, 3, 1, 2), None


class AffineAct(torch.autograd.Function):
    """act(x * es + eb) of an NCHW channels_last x on the card; the backward
    is ``prologue_backward``, through the fold when it is given one."""

    @staticmethod
    def forward(ctx, x, es, eb, act, fold):
        xh = _nhwc(x)
        y = _affine_act_cuda(xh, es, eb, act)
        ctx.save_for_backward(xh, es, eb)
        ctx.act, ctx.fold = act, fold
        return y.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, gy):
        xh, es, eb = ctx.saved_tensors
        fold = ctx.fold if ctx.needs_input_grad[0] else None
        dx, des, deb = prologue_backward(_nhwc(gy), xh, es, eb, ctx.act, fold)
        if dx is not None:
            dx = dx.permute(0, 3, 1, 2)
        return dx, des, deb, None, None


# ------------------------------------------------------------------ wrappers
def _plain(x) -> bool:
    """Whether x takes the plain versions: a CPU tensor does."""
    return x.device.type == "cpu"


def channel_moments(x):
    """(E[x], E[x^2], fold) of an NCHW tensor per channel over (N, H, W),
    in f32. On a card: the kernels, and a ``Fold`` for the one consumer
    that normalizes this x when x takes a gradient (else None). On the CPU:
    the plain version, fold None."""
    if _plain(x):
        return (*channel_moments_reference(x), None)
    fold = Fold() if torch.is_grad_enabled() and x.requires_grad else None
    m1, m2 = ChannelMoments.apply(x, fold)
    return m1, m2, fold


def affine_act(x, es, eb, act=None, fold=None):
    """act(x * es + eb) of an NCHW tensor (channels_last on a card), es and
    eb (C,) f32, act None or 'leaky_relu'. ``fold``: from the moments of
    this same x (``channel_moments``), which then write its dx."""
    if act not in _ACTS:
        raise ValueError(f"act {act!r} not in {_ACTS}")
    if _plain(x):
        return affine_act_reference(x, es, eb, act)
    return AffineAct.apply(x, es, eb, act, fold)


def prologue_backward(g, x, es, eb, act=None, fold=None):
    """(dx, des, deb) of act(x * es + eb) under g, NHWC, des and deb f32.
    With a ``fold`` (on a card only) dx is None: the reduce pass alone runs
    here and the moments' backward of x writes dx."""
    if _plain(x):
        if fold is not None:
            raise ValueError("bn_act: a Fold exists on a card only")
        return prologue_backward_reference(g, x, es, eb, act)
    if fold is None:
        return _affine_act_grad_cuda(g, x, es, eb, act, want_dx=True)
    _, des, deb = _affine_act_grad_cuda(g, x, es, eb, act, want_dx=False)
    fold.put(g, es, eb, act)
    return None, des, deb
