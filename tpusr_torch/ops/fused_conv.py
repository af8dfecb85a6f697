"""Fused 3x3 conv: prologue, in-kernel halos, base input, BN stats epilogue.

Counterpart of ``tpusr/ops/pallas_conv.py``. One conv block of the DIP skip
network, y = conv3x3(act(x * eff_scale + eff_bias)) [+ base], runs as one
read of x and one write of y: the previous BatchNorm's normalize and
LeakyReLU ride the input read (the prologue), reflect or zero halos are
handled in the kernel, and the per-channel [sum y, sum y^2] that the next
BatchNorm needs come out of the epilogue.

Layout: the public functions take NHWC activations and HWIO weights, the
JAX package's layout. A channels_last NCHW tensor permuted to NHWC is such
a tensor, with no copy.

Kernels (``tpusr_torch/csrc/fused_conv3x3.cu``, CUDA C++ for sm_90a, on
the tensor cores: wgmma in bf16, 3xTF32 mma.sync in f32):
  * A ``fused_conv3x3_fwd`` — the forward, and dgrad (kernel A over the
    output cotangent with rotated, transposed weights, zero pad, no
    prologue, no stats);
  * B ``fused_conv3x3_wgrad`` — the weight gradient, recomputing the same
    halo and prologue from x.
Their launch geometry (stats partials per tile, split-K row slices) is in
plain functions here, with the tile constants the source also holds.
Each wrapper launches its kernel for a CUDA tensor and raises on what the
kernel does not take; for a CPU tensor it runs the plain PyTorch version
beside it. ``LAUNCHES`` counts kernel launches, so a run can show that its
main path went through the kernels.

The backward pieces that the JAX package leaves to XLA outside its kernels
stay plain PyTorch here: the stats cotangent G = gy + gst0 + 2*y*gst1 and
the reflect fold corrections. The prologue backward is
``ops/bn_act.prologue_backward``, a kernel on a card; given the ``fold`` of
x's moments it leaves dx to their backward.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpusr_torch.ops.bn_act import prologue_backward

LAUNCHES = {"fused_conv3x3_fwd": 0, "fused_conv3x3_wgrad": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = (None, "leaky_relu")
_SOURCE = "fused_conv3x3.cu"

# The kernels' tiles, as the constexprs of fused_conv3x3.cu hold them
TH, TW = 16, 16  # kernel A's output tile: one stats partial each
WG_CI, WG_CO = 64, 64  # kernel B's block: input x output channels
# f32 kernel B: pixels summed into one partial at most. The tensor cores'
# f32 accumulation loses about 2^-24 per product added, so the error of a
# partial grows with its length (at 512^2, 128 -> 128: 5.3e-5 of f64 with
# 8192 pixels a slice, 1.5e-5 with 2048); the slices hold it well inside
# the f32 kernels' 1e-4.
WGRAD_F32_MAX_PIXELS = 4096


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ launch geometry
def stats_tiles(h, w):
    """Kernel A's stats partials per image: one per TH x TW output tile."""
    return -(-h // TH) * -(-w // TW)


def wgrad_split(n, h, w, cin, cout, sms, max_pixels=None):
    """Kernel B's split-K over rows: (rows per slice, slices per image).

    About one block per SM in all, and no slice longer than ``max_pixels``
    (rows x w, at least one row); each slice is a run of rows of one image
    and writes its own partial dw (slices x 9 x Cin x Cout f32), which one
    torch.sum reduces."""
    tiles = -(-cin // WG_CI) * -(-cout // WG_CO)
    want = -(-sms // tiles)
    per_img = max(1, min(h, -(-want // n)))
    rows = -(-h // per_img)
    if max_pixels is not None:
        rows = max(1, min(rows, max_pixels // w))
    return rows, -(-h // rows)


# ------------------------------------------------------------- plain versions
def _prologue(x, es, eb, act):
    a = x
    if es is not None:
        a = a * es.to(a.dtype) + eb.to(a.dtype)
    if act == "leaky_relu":
        a = torch.where(a >= 0, a, 0.2 * a)
    return a


def _padded_nchw(x, es, eb, act, reflect):
    """Prologued input, padded by one pixel: reflect halos before the
    prologue (it commutes with reflection), zero halos after it."""
    a = _prologue(x, es, eb, act).permute(0, 3, 1, 2)
    return F.pad(a, (1, 1, 1, 1), mode="reflect" if reflect else "constant")


def _acc_dtype(dtype):
    """The kernels' f32 accumulation; f64 inputs stay f64, which makes the
    plain versions an exact yardstick for the f32 kernels."""
    return torch.promote_types(dtype, torch.float32)


def fused_conv3x3_fwd_reference(x, w, es=None, eb=None, base=None, *,
                                act=None, reflect=True, stats=False):
    """Plain version of kernel A: (y, [sum y, sum y^2] in f32 or None)."""
    acc = _acc_dtype(x.dtype)
    ap = _padded_nchw(x, es, eb, act, reflect)
    y32 = F.conv2d(ap, w.to(ap.dtype).permute(3, 2, 0, 1)).to(acc)
    y32 = y32.permute(0, 2, 3, 1)
    if base is not None:
        y32 = y32 + base.to(acc)
    st = None
    if stats:
        st = torch.stack([y32.sum((0, 1, 2)), y32.square().sum((0, 1, 2))])
    return y32.to(x.dtype).contiguous(), st


def fused_conv3x3_wgrad_reference(x, g, es=None, eb=None, *, act=None,
                                  reflect=True):
    """Plain version of kernel B: dw (3, 3, Cin, Cout) in f32."""
    acc = _acc_dtype(x.dtype)
    ap = _padded_nchw(x, es, eb, act, reflect).to(acc)
    dw = torch.nn.grad.conv2d_weight(
        ap, (g.shape[-1], x.shape[-1], 3, 3), g.permute(0, 3, 1, 2).to(acc))
    return dw.permute(2, 3, 1, 0).contiguous()


# ------------------------------------------------------------ CUDA launchers
def _lib():
    from tpusr_torch.ops._build import load

    lib = load(_SOURCE)
    if not getattr(lib, "_tpusr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tpusr_conv3x3_fwd.argtypes = [ci, ci] + [vp] * 7 + [ci] * 8 + [vp]
        lib.tpusr_conv3x3_fwd.restype = ci
        lib.tpusr_conv3x3_wgrad.argtypes = [ci, ci] + [vp] * 5 + [ci] * 10 + [vp]
        lib.tpusr_conv3x3_wgrad.restype = ci
        lib._tpusr_typed = True
    return lib


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(cond, msg):
    if not cond:
        raise ValueError(f"fused_conv3x3: {msg}")


def _check_common(x, es, eb, act, reflect):
    _check(x.is_cuda, "the kernel takes CUDA tensors")
    _check(x.dim() == 4, f"x must be (N,H,W,C), got {tuple(x.shape)}")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} not in float32/bfloat16")
    _check(x.is_contiguous(), "x must be contiguous NHWC")
    n, h, w, c = x.shape
    _check(min(n, c) >= 1 and min(h, w) >= (2 if reflect else 1),
           f"shape {tuple(x.shape)} too small")
    _check(n <= 65535 and x.numel() < 2 ** 31, "tensor too large")
    _check(act in _ACTS, f"act {act!r} not in {_ACTS}")
    _check((es is None) == (eb is None), "eff_scale and eff_bias go together")
    for v in (es, eb):
        if v is not None:
            _check(v.device == x.device and v.dtype == torch.float32
                   and v.shape == (c,) and v.is_contiguous(),
                   "eff_scale/eff_bias must be contiguous f32 (Cin,) "
                   "on x's device")


def _fwd_cuda(x, w, es, eb, base, act, reflect, stats):
    _check_common(x, es, eb, act, reflect)
    n, h, wd, cin = x.shape
    _check(w.device == x.device and w.dtype == x.dtype and w.dim() == 4
           and tuple(w.shape[:3]) == (3, 3, cin) and w.is_contiguous(),
           f"w must be contiguous (3,3,{cin},Cout) in {x.dtype}")
    cout = w.shape[3]
    if base is not None:
        _check(base.device == x.device and base.dtype == x.dtype
               and tuple(base.shape) == (n, h, wd, cout)
               and base.is_contiguous(),
               "base must be contiguous (N,H,W,Cout) in x's dtype")
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    part = None
    if stats:
        part = torch.empty((n * stats_tiles(h, wd), 2, cout),
                           dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().tpusr_conv3x3_fwd(
        x.device.index or 0, _DTYPES[x.dtype], _ptr(x), _ptr(w), _ptr(es),
        _ptr(eb), _ptr(base), _ptr(y), _ptr(part), n, h, wd, cin, cout,
        int(es is not None), int(act == "leaky_relu"), int(reflect),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_conv3x3_fwd launch failed: CUDA error {rc}")
    LAUNCHES["fused_conv3x3_fwd"] += 1
    return y, (part.sum(0) if stats else None)


def _wgrad_cuda(x, g, es, eb, act, reflect):
    _check_common(x, es, eb, act, reflect)
    n, h, wd, cin = x.shape
    _check(g.device == x.device and g.dtype == x.dtype and g.dim() == 4
           and tuple(g.shape[:3]) == (n, h, wd) and g.is_contiguous(),
           "g must be contiguous (N,H,W,Cout) in x's dtype")
    cout = g.shape[3]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows, per_img = wgrad_split(
        n, h, wd, cin, cout, sms,
        WGRAD_F32_MAX_PIXELS if x.dtype == torch.float32 else None)
    part = torch.empty((n * per_img, 9, cin, cout), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().tpusr_conv3x3_wgrad(
        x.device.index or 0, _DTYPES[x.dtype], _ptr(x), _ptr(g), _ptr(es),
        _ptr(eb), _ptr(part), n, h, wd, cin, cout, rows, per_img,
        int(es is not None), int(act == "leaky_relu"), int(reflect),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"fused_conv3x3_wgrad launch failed: CUDA error {rc}")
    LAUNCHES["fused_conv3x3_wgrad"] += 1
    return part.sum(0).view(3, 3, cin, cout)


# ------------------------------------------------------------------ wrappers
def fused_conv3x3_fwd(x, w, es=None, eb=None, base=None, *, act=None,
                      reflect=True, stats=False):
    """Kernel A on a CUDA tensor, its plain version on a CPU tensor.
    Returns (y, stats or None); stats = [sum y, sum y^2] per channel, f32."""
    if x.device.type == "cpu":
        return fused_conv3x3_fwd_reference(x, w, es, eb, base, act=act,
                                           reflect=reflect, stats=stats)
    return _fwd_cuda(x, w, es, eb, base, act, reflect, stats)


def fused_conv3x3_wgrad(x, g, es=None, eb=None, *, act=None, reflect=True):
    """Kernel B on a CUDA tensor, its plain version on a CPU tensor.
    Returns dw (3, 3, Cin, Cout) in f32."""
    if x.device.type == "cpu":
        return fused_conv3x3_wgrad_reference(x, g, es, eb, act=act,
                                             reflect=reflect)
    return _wgrad_cuda(x, g, es, eb, act, reflect)


def reflect_fold_corrections(dpa, G, w):
    """Fold the reflect padding's virtual border into a zero-SAME dgrad.

    dpa (N,H,W,Ci) is the gradient of the padded input's interior; the
    virtual rows/columns -1 and H (W) reflect onto 1 and H-2 (W-2), so their
    gradients, single-row 1x3 convs of G's border, fold back there, and the
    four virtual corners fold onto the corners one pixel in
    (pallas_conv.py::_reflect_fold_corrections).
    """
    _, H, W, _ = dpa.shape
    wd = w.to(G.dtype)

    def strip(rows, wrow):  # rows (N, L, Co), wrow (3, Ci, Co) -> (N, L, Ci)
        k = wrow.flip(0).permute(1, 2, 0)  # out[v] = sum_t rows[v+1-t] wrow[t]
        return F.conv1d(rows.transpose(1, 2), k, padding=1).transpose(1, 2)

    dpa = dpa.clone()
    dpa[:, 1] += strip(G[:, 0], wd[0])
    dpa[:, H - 2] += strip(G[:, H - 1], wd[2])
    dpa[:, :, 1] += strip(G[:, :, 0], wd[:, 0])
    dpa[:, :, W - 2] += strip(G[:, :, W - 1], wd[:, 2])
    for (h, w_), (gy, gx), (ky, kx) in (
            ((1, 1), (0, 0), (0, 0)),
            ((1, W - 2), (0, W - 1), (0, 2)),
            ((H - 2, 1), (H - 1, 0), (2, 0)),
            ((H - 2, W - 2), (H - 1, W - 1), (2, 2))):
        corner = G[:, gy, gx].float() @ wd[ky, kx].float().T
        dpa[:, h, w_] += corner.to(dpa.dtype)
    return dpa


class FusedConv3x3(torch.autograd.Function):
    """Kernel A forward; backward = dgrad (kernel A) + wgrad (kernel B) +
    the prologue backward + plain elementwise pieces, with no forward
    recompute."""

    @staticmethod
    def forward(ctx, x, w, es, eb, base, act, reflect, stats, fold):
        y, st = fused_conv3x3_fwd(x, w, es, eb, base, act=act,
                                  reflect=reflect, stats=stats)
        # y rides along only for the stats cotangent (d sum y^2 / dy = 2y)
        ctx.save_for_backward(x, w, es, eb, y if stats else None)
        ctx.act, ctx.reflect, ctx.stats, ctx.fold = act, reflect, stats, fold
        ctx.base_dtype = None if base is None else base.dtype
        return (y, st) if stats else y

    @staticmethod
    def backward(ctx, gy, gst=None):
        x, w, es, eb, y = ctx.saved_tensors
        if ctx.stats:
            G = (gy.float() + gst[0] + 2.0 * y.float() * gst[1]).to(gy.dtype)
        else:
            G = gy
        G = G.contiguous()
        need_x, need_w, need_es, need_eb, need_base = ctx.needs_input_grad[:5]
        dx = dw = des = deb = db = None
        if need_x or need_es or need_eb:
            w_rot = w.flip(0, 1).transpose(2, 3).contiguous()  # (3,3,Cout,Cin)
            dpa, _ = fused_conv3x3_fwd(G, w_rot, reflect=False)
            if ctx.reflect:
                dpa = reflect_fold_corrections(dpa, G, w)
            if es is not None:
                dx, des, deb = prologue_backward(
                    dpa, x, es, eb, ctx.act, ctx.fold if need_x else None)
            elif ctx.act == "leaky_relu":
                dx = torch.where(x >= 0, dpa, dpa * 0.2)
            else:
                dx = dpa
        if need_w:
            dw = fused_conv3x3_wgrad(x, G, es, eb, act=ctx.act,
                                     reflect=ctx.reflect).to(w.dtype)
        if need_base:
            db = G.to(ctx.base_dtype)
        return dx, dw, des, deb, db, None, None, None, None


def fused_conv3x3(x, w, eff_scale=None, eff_bias=None, *, act=None,
                  pad_mode="reflection", stats=False, base=None, fold=None):
    """y = conv3x3(act(x*eff_scale + eff_bias)) [+ base], differentiable.

    x: (N,H,W,Cin) f32/bf16, contiguous on CUDA; w: (3,3,Cin,Cout), cast to
    x's dtype here (inside autograd, so dw flows back in w's dtype);
    eff_scale/eff_bias: (Cin,) f32 or None; act: None | 'leaky_relu';
    base: (N,H,W,Cout) or None; fold: the ``ops/bn_act.Fold`` of x's
    moments, whose backward then writes dx. Returns y, or (y, stats) with
    stats = [sum y, sum y^2] per channel of the f32 output including base.
    """
    if pad_mode not in ("reflection", "zero"):
        raise ValueError(f"pad_mode {pad_mode!r} not in reflection/zero")
    if (eff_scale is None) != (eff_bias is None):
        raise ValueError("eff_scale and eff_bias go together")
    return FusedConv3x3.apply(x, w.to(x.dtype), eff_scale, eff_bias, base,
                              act, pad_mode == "reflection", stats, fold)
