"""tpusr_torch fused 3x3 conv against the JAX package's Pallas conv.

The port's ``fused_conv3x3`` runs on the CPU through the plain versions of
its two kernels, inside the same autograd Function (hand-built backward)
that drives the CUDA kernels on the card. The JAX side runs as its own
tests run it: ``fused_conv3x3(..., interpret=True)`` and ``_fused_ref``.
The kernels' launch geometry (stats partials per tile, split-K slices)
is held here too, against the tile constants of the CUDA source.
"""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpusr.ops.pallas_conv import _fused_ref
from tpusr.ops.pallas_conv import fused_conv3x3 as jax_fused_conv3x3
from tpusr_torch.ops import fused_conv
from tpusr_torch.ops.fused_conv import fused_conv3x3

PROLOGUES = {"none": (False, None), "affine": (True, None),
             "affine_leaky": (True, "leaky_relu")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((1, h, w, cin)).astype(np.float32),
        w=(rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32),
        es=rng.uniform(0.5, 1.5, (cin,)).astype(np.float32),
        eb=(rng.standard_normal((cin,)) * 0.1).astype(np.float32),
        base=rng.standard_normal((1, h, w, cout)).astype(np.float32),
    )


def _torch_fwd(d, affine, act, pad, base, stats=True):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return fused_conv3x3(t["x"], t["w"], t["es"] if affine else None,
                         t["eb"] if affine else None, act=act, pad_mode=pad,
                         stats=stats, base=t["base"] if base else None)


def _jax_ref(d, affine, act, pad, base):
    j = {k: jnp.asarray(v) for k, v in d.items()}
    return _fused_ref(j["x"], j["w"], j["es"], j["eb"], affine=affine, act=act,
                      reflect=pad == "reflection", stats=True,
                      base=j["base"] if base else None)


@pytest.mark.parametrize("base", [False, True])
@pytest.mark.parametrize("prologue", list(PROLOGUES))
@pytest.mark.parametrize("pad", ["reflection", "zero"])
def test_forward_matches_jax_kernel(pad, prologue, base):
    affine, act = PROLOGUES[prologue]
    d = _inputs(0, 16, 24, 32, 48)
    y, st = _torch_fwd(d, affine, act, pad, base)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    yk, stk = jax_fused_conv3x3(
        j["x"], j["w"], j["es"] if affine else None,
        j["eb"] if affine else None, act=act, pad_mode=pad, stats=True,
        base=j["base"] if base else None, interpret=True)
    yr, str_ = _jax_ref(d, affine, act, pad, base)
    for yj, sj in ((yk, stk), (yr, str_)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                                   rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("prologue", list(PROLOGUES))
@pytest.mark.parametrize("pad", ["reflection", "zero"])
def test_forward_odd_shapes_match_reference(pad, prologue):
    """Odd H and W, channel counts outside {32, 64, 128}: the Hopper kernel
    takes every shape, so its plain version is held to _fused_ref there."""
    affine, act = PROLOGUES[prologue]
    d = _inputs(1, 7, 9, 5, 6)
    y, st = _torch_fwd(d, affine, act, pad, base=True)
    yr, str_ = _jax_ref(d, affine, act, pad, base=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(str_), rtol=1e-5,
                               atol=1e-4)


def _max_rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("shape", [(16, 24, 32, 48), (7, 9, 5, 6)])
@pytest.mark.parametrize("prologue", ["affine", "affine_leaky"])
@pytest.mark.parametrize("pad", ["reflection", "zero"])
def test_gradients_match_jax(pad, prologue, shape):
    """dx, dw, des, deb and dbase against jax.grad of _fused_ref, with the
    loss of tests/test_pallas_conv.py."""
    affine, act = PROLOGUES[prologue]
    d = _inputs(2, *shape)
    names = ("x", "w", "es", "eb", "base")

    def jloss(x, w, es, eb, base):
        y, st = _fused_ref(x, w, es, eb, affine=affine, act=act,
                           reflect=pad == "reflection", stats=True, base=base)
        return (0.5 * jnp.sum(jnp.square(y)) + 0.1 * jnp.sum(st[0])
                + 0.01 * jnp.sum(st[1]))

    gj = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(d[k]) for k in names))

    t = {k: torch.from_numpy(d[k]).requires_grad_() for k in names}
    y, st = fused_conv3x3(t["x"], t["w"], t["es"], t["eb"], act=act,
                          pad_mode=pad, stats=True, base=t["base"])
    loss = (0.5 * y.square().sum() + 0.1 * st[0].sum()
            + 0.01 * st[1].sum())
    loss.backward()
    for k, g in zip(names, gj):
        assert _max_rel(t[k].grad.numpy(), np.asarray(g)) < 1e-4, k


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions and launch nothing;
    the CUDA launcher refuses a CPU tensor instead of falling back."""
    d = _inputs(3, 8, 8, 4, 4)
    fused_conv.reset_launch_counts()
    x = torch.from_numpy(d["x"]).requires_grad_()
    y = fused_conv3x3(x, torch.from_numpy(d["w"]), pad_mode="zero")
    y.sum().backward()
    assert fused_conv.LAUNCHES == {"fused_conv3x3_fwd": 0,
                                   "fused_conv3x3_wgrad": 0}
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv._fwd_cuda(x.detach(), torch.from_numpy(d["w"]), None,
                             None, None, None, False, False)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv._wgrad_cuda(x.detach(), y.detach(), None, None, None,
                               False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wgrad_reference_matches_autograd(dtype):
    """Kernel B's plain version equals autograd's weight gradient of the
    forward's plain version (reflect + affine + LeakyReLU). In f64 both
    stay f64 throughout: chip_smoke.py holds the f32 kernels to them."""
    d = _inputs(4, 9, 11, 6, 7)
    x, es, eb, g = (torch.from_numpy(d[k]).to(dtype)
                    for k in ("x", "es", "eb", "base"))
    w = torch.from_numpy(d["w"]).to(dtype).requires_grad_()
    y, st = fused_conv.fused_conv3x3_fwd_reference(
        x, w, es, eb, act="leaky_relu", reflect=True, stats=True)
    (y * g).sum().backward()
    dw = fused_conv.fused_conv3x3_wgrad_reference(x, g, es, eb,
                                                  act="leaky_relu")
    assert y.dtype == st.dtype == dw.dtype == dtype
    np.testing.assert_allclose(dw.numpy(), w.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ launch geometry
def _csrc_constants():
    """The `constexpr int NAME = value;` lines of the kernels' source."""
    path = os.path.join(os.path.dirname(fused_conv.__file__), os.pardir,
                        "csrc", "fused_conv3x3.cu")
    with open(path) as f:
        src = f.read()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}


def test_tile_constants_match_the_kernel_source():
    """The wrapper sizes the stats partials and the split-K blocks from
    its own copy of the tiles; the kernels index with the source's."""
    c = _csrc_constants()
    assert (c["TH"], c["TW"]) == (fused_conv.TH, fused_conv.TW)
    assert (c["WG_CI"], c["WG_CO"]) == (fused_conv.WG_CI, fused_conv.WG_CO)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (15, 17), (16, 16),
                                 (33, 70), (270, 480), (512, 512)])
def test_stats_partials_cover_every_pixel_once(n, h, w):
    """Kernel A's partial index n * tiles + tile, with the tile's origin as
    the kernel derives it from blockIdx.x: every partial is written by one
    block whose tile holds a pixel, and every pixel lies in one tile."""
    th, tw = fused_conv.TH, fused_conv.TW
    tiles = fused_conv.stats_tiles(h, w)
    tiles_w = -(-w // tw)
    cover = np.zeros((n, h, w), np.int64)
    written = np.zeros(n * tiles, np.int64)
    for img in range(n):
        for t in range(tiles):
            h0, w0 = (t // tiles_w) * th, (t % tiles_w) * tw
            assert h0 < h and w0 < w
            cover[img, h0:h0 + th, w0:w0 + tw] += 1
            written[img * tiles + t] += 1
    assert (cover == 1).all() and (written == 1).all()


@pytest.mark.parametrize("max_pixels", [None, 4096])
@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 512, 512, 128, 128), (1, 16, 16, 128, 128), (2, 19, 35, 64, 64),
    (3, 7, 9, 5, 6), (1, 2, 5000, 3, 64), (4, 1, 3, 132, 128),
    (1, 1080, 1920, 64, 64)])
def test_wgrad_slices_cover_every_row_once(n, h, w, cin, cout, sms,
                                           max_pixels):
    """Kernel B's split-K: slice s covers rows [j * rows, min((j + 1) *
    rows, H)) of image s // per_img, j = s % per_img, as the kernel reads
    it. No slice is empty, none crosses an image, every row is in one; the
    grid stays about one block per SM unless a slice would pass
    max_pixels, and none does but for a single row."""
    rows, per_img = fused_conv.wgrad_split(n, h, w, cin, cout, sms,
                                           max_pixels)
    cover = np.zeros((n, h), np.int64)
    for s in range(n * per_img):
        img, j = divmod(s, per_img)
        hs, he = j * rows, min((j + 1) * rows, h)
        assert hs < he
        cover[img, hs:he] += 1
    assert (cover == 1).all()
    tiles = -(-cin // fused_conv.WG_CI) * -(-cout // fused_conv.WG_CO)
    if max_pixels is None or rows * w < max_pixels - w:
        assert n * per_img * tiles <= sms + n * tiles
    if max_pixels is not None:
        assert rows == 1 or rows * w <= max_pixels


@pytest.mark.parametrize("dtype,max_pixels,inputs", [
    ("bfloat16", None, 2 * 512 * 512 * 128 * 2),
    ("float32", fused_conv.WGRAD_F32_MAX_PIXELS, 2 * 512 * 512 * 128 * 4)])
def test_wgrad_partials_stay_small_at_up0(dtype, max_pixels, inputs):
    """At DIP's up0_conv (512^2, 128 -> 128) the dw partials stay well under
    the bytes of the kernel's inputs (x and G: 134 MB in bf16)."""
    rows, per_img = fused_conv.wgrad_split(1, 512, 512, 128, 128, 132,
                                           max_pixels)
    assert per_img * 9 * 128 * 128 * 4 < inputs / 4
