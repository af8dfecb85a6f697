"""Kernel C's tile geometry, checked on the CPU where no card is.

The constants are read from ``tpusr_torch/csrc/dense_block.cu``; the shared
memory, the recompute factor and the tile cover are recomputed from them;
and a plain emulation of the kernel's schedule (per tile, each stage on its
region with M padded as the kernel pads it, the taps as pixel offsets into
each source at its own pitch, the weights read from the packed units at the
kernel's slot addresses) is held to tpusr's ``dense_block_reference``.
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr.ops.pallas_dense import dense_block_reference as jax_reference
from tpusr_torch.ops import dense_block as db

NF, GC, HALO = 64, 32, 5
SMEM_MAX = 232_448  # shared memory a block may use on the H100
USEFUL = 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64)
# per dtype: the tile constants' names, bytes per value, M padding
KINDS = {torch.bfloat16: ("B16", 2, 64), torch.float32: ("F32", 4, 16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _source():
    path = os.path.join(os.path.dirname(db.__file__), os.pardir, "csrc",
                        "dense_block.cu")
    with open(path) as f:
        return f.read()


def _constants():
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", _source())}


def _geometry(dtype):
    c = _constants()
    name, size, mpad = KINDS[dtype]
    th, tw = c[f"{name}_TH"], c[f"{name}_TW"]
    rh = [th + 2 * (HALO - s) for s in range(6)]
    rw = [tw + 2 * (HALO - s) for s in range(6)]
    return th, tw, rh, rw, size, mpad, c


def _cin(s):
    return NF + GC * (s - 1)


def _cout(s):
    return GC if s < 5 else NF


def test_constants_match_the_wrapper():
    c = _constants()
    for dtype, (name, _, _) in KINDS.items():
        assert (c[f"{name}_TH"], c[f"{name}_TW"]) == db.TILE[dtype]
    assert (c["KC"], c["UNIT_N"], c["NUNITS"]) == (db.KC, db.UNIT_N,
                                                   db.NUNITS)
    assert c["HALO"] == HALO and (c["NF"], c["GC"]) == (NF, GC)
    units = sum(_cin(s) // db.KC * (_cout(s) // db.UNIT_N)
                for s in range(1, 6))
    assert units == db.NUNITS


@pytest.mark.parametrize("dtype", list(KINDS))
def test_shared_memory_fits_and_matches_the_note(dtype):
    th, tw, rh, rw, size, _, c = _geometry(dtype)
    acts = sum(rh[s] * rw[s] * (NF if s == 0 else GC) * size
               for s in range(5))
    ring = c["RING"] * 9 * c["KC"] * c["UNIT_N"] * size
    total = acts + ring
    assert total <= SMEM_MAX
    note = _source()
    assert f"{acts:,}" in note and f"{total:,}" in note


@pytest.mark.parametrize("dtype", list(KINDS))
def test_recompute_factor_matches_the_note(dtype):
    """Multiply-adds the tile computes (M padded at its end) over the useful
    239,616 a pixel, as the source's note states it."""
    th, tw, rh, rw, _, mpad, _ = _geometry(dtype)
    macs = sum(math.ceil(rh[s] * rw[s] / mpad) * mpad * 9 * _cin(s)
               * _cout(s) for s in range(1, 6))
    factor = macs / (th * tw) / USEFUL
    assert USEFUL == 239_616 == db.USEFUL_MACS
    assert f"{factor:.3f}x" in _source()
    assert db.recompute_factor(dtype) == pytest.approx(factor)
    assert mpad == db.M_PAD[dtype]


@pytest.mark.parametrize("dtype", list(KINDS))
@pytest.mark.parametrize("n,h,w", [(1, 1, 1), (1, 17, 13), (2, 9, 33),
                                   (1, 40, 3), (3, 16, 16), (1, 270, 480)])
def test_tiles_cover_every_output_pixel_once(dtype, n, h, w):
    """Block (b, img) of the grid (tiles_h * tiles_w, N) owns the tile at
    rows (b // tiles_w) * TH, columns (b % tiles_w) * TW, as the kernel
    derives it; its stores are masked to the image."""
    th, tw = db.TILE[dtype]
    tiles_w, tiles_h = -(-w // tw), -(-h // th)
    cover = np.zeros((n, h, w), np.int64)
    for img in range(n):
        for b in range(tiles_w * tiles_h):
            h0, w0 = (b // tiles_w) * th, (b % tiles_w) * tw
            assert h0 < h and w0 < w  # no block without an output pixel
            cover[img, h0:h0 + th, w0:w0 + tw] += 1
    assert (cover == 1).all()


def test_the_kernel_runs_on_the_tensor_cores():
    """wgmma in bf16, mma.sync in f32, and no FMA main loop left."""
    src = _source()
    assert "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "fmaf(" not in src and "__fmaf" not in src


# ------------------------------------------------------- schedule emulation
def _slot_index(dtype, t, k, n):
    """Element index of weight (tap t, chunk channel k, unit output n) in a
    unit, at the kernel's slot addresses."""
    if dtype == torch.bfloat16:  # 1,024 B a tap, LBO 512 B, SBO 128 B
        return t * 512 + (k // 8) * 256 + (n // 8) * 64 + (k % 8) * 8 + n % 8
    return ((t * 4 + k // 4) * 32 + n) * 4 + k % 4  # ldmatrix rows of 16 B


def _units(kernels, dtype):
    """The packed units, each read back as (9, 16, 32) [tap][k][n]."""
    packed = db.pack_weights(kernels, dtype).double().reshape(db.NUNITS, -1)
    t, k, n = np.meshgrid(np.arange(9), np.arange(db.KC),
                          np.arange(db.UNIT_N), indexing="ij")
    idx = torch.from_numpy(_slot_index(dtype, t, k, n))
    return [u[idx] for u in packed]


def emulate(x, kernels, biases, dtype):
    """Kernel C's schedule in f64 on the CPU: x (N, H, W, 64); the weights
    as the kernel reads them (packed in dtype), the arithmetic in f64."""
    th, tw, rh, rw, _, mpad, _ = _geometry(dtype)
    units = _units(kernels, dtype)
    bs = [b.double() for b in biases]
    n_img, h, w, _ = x.shape
    x = x.double()
    y = torch.zeros_like(x)
    for img in range(n_img):
        for h0 in range(0, h, th):
            for w0 in range(0, w, tw):
                def region(s):  # image rows, columns, inside mask of stage s
                    gh = torch.arange(rh[s]) + h0 - (HALO - s)
                    gw = torch.arange(rw[s]) + w0 - (HALO - s)
                    inside = (((gh >= 0) & (gh < h))[:, None]
                              & ((gw >= 0) & (gw < w))[None, :])
                    return gh, gw, inside.reshape(-1)
                gh, gw, inside = region(0)
                xr = x[img, gh.clamp(0, h - 1)][:, gw.clamp(0, w - 1)]
                bufs = [xr.reshape(-1, NF) * inside[:, None]]
                u = 0
                for s in range(1, 6):
                    npix = rh[s] * rw[s]
                    m = torch.arange(math.ceil(npix / mpad) * mpad)
                    mc = m.clamp(max=npix - 1)  # padding rows: last pixel
                    oy, ox = mc // rw[s], mc % rw[s]
                    acc = torch.zeros(len(m), _cout(s), dtype=torch.float64)
                    for c in range(_cin(s) // db.KC):
                        j = 0 if c < NF // db.KC else (c - 4) // 2 + 1
                        ch0 = db.KC * c if j == 0 else db.KC * ((c - 4) % 2)
                        d = s - j - 1
                        for half in range(_cout(s) // db.UNIT_N):
                            wt = units[u]
                            u += 1
                            for t in range(9):
                                dy, dx = divmod(t, 3)
                                idx = (oy + d + dy) * rw[j] + ox + d + dx
                                assert int(idx.max()) < rh[j] * rw[j]
                                a = bufs[j][idx, ch0:ch0 + db.KC]
                                acc[:, 32 * half:32 * half + 32] += a @ wt[t]
                    acc = acc[:npix] + bs[s - 1]
                    _, _, inside = region(s)
                    if s < 5:
                        c_s = torch.where(acc >= 0, acc, 0.2 * acc)
                        bufs.append(c_s * inside[:, None])
                        continue
                    out = bufs[0].reshape(rh[0], rw[0], NF)[
                        HALO:HALO + th, HALO:HALO + tw].reshape(-1, NF)
                    out = (out + 0.2 * acc).reshape(th, tw, NF)
                    hh, ww = min(th, h - h0), min(tw, w - w0)
                    y[img, h0:h0 + hh, w0:w0 + ww] = out[:hh, :ww]
                assert u == db.NUNITS
    return y


def _operands(shape, seed, dtype):
    """x and the 5 kernels and biases, the kernels rounded through dtype so
    that the packed units hold them exactly."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (*shape, NF)).astype(np.float32)
    ks = [torch.from_numpy(rng.normal(0, 0.05, (3, 3, _cin(s), _cout(s)))
                           .astype(np.float32)).to(dtype).float()
          for s in range(1, 6)]
    bs = [torch.from_numpy(rng.normal(0, 0.02, (_cout(s),))
                           .astype(np.float32)) for s in range(1, 6)]
    return x, ks, bs


@pytest.mark.parametrize("dtype", list(KINDS))
@pytest.mark.parametrize("shape", [(1, 17, 13), (2, 9, 33), (1, 1, 1)])
def test_schedule_emulation_matches_jax_reference(dtype, shape):
    x, ks, bs = _operands(shape, sum(shape), dtype)
    want = np.asarray(jax_reference(
        jnp.asarray(x), [jnp.asarray(k.numpy()) for k in ks],
        [jnp.asarray(b.numpy()) for b in bs]))
    got = emulate(torch.from_numpy(x), ks, bs, dtype)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("dtype", list(KINDS))
def test_packed_units_hold_the_kernels(dtype):
    """Every weight appears once, at the unit and slot address the kernel
    reads for its stage, chunk, output half, tap and channel."""
    _, ks, _ = _operands((1, 1, 1), 7, dtype)
    units = _units(ks, dtype)
    u = 0
    for s, k in enumerate(ks, 1):
        for c in range(_cin(s) // db.KC):
            for half in range(_cout(s) // db.UNIT_N):
                want = k.reshape(9, _cin(s), _cout(s))[
                    :, db.KC * c:db.KC * (c + 1),
                    db.UNIT_N * half:db.UNIT_N * (half + 1)]
                assert torch.equal(units[u], want.double())
                u += 1
    assert db.pack_weights(ks, dtype).numel() == sum(k.numel() for k in ks)


def test_packing_is_cached_until_the_kernels_change():
    """No cache is kept: every call packs the kernels as they are now, after
    an in-place write and for inference tensors alike."""
    _, ks, _ = _operands((1, 1, 1), 8, torch.float32)
    first = db.packed_weights(ks, torch.bfloat16)
    assert torch.equal(first, db.pack_weights(ks, torch.bfloat16))
    assert torch.equal(db.packed_weights(ks, torch.float32),
                       db.pack_weights(ks, torch.float32))
    with torch.no_grad():
        ks[3].mul_(2)  # in place: a new version
    again = db.packed_weights(ks, torch.bfloat16)
    assert not torch.equal(again, first)
    assert torch.equal(again, db.pack_weights(ks, torch.bfloat16))
    with torch.inference_mode():
        inf = [k.clone() for k in ks]
    assert torch.equal(db.packed_weights(inf, torch.bfloat16), again)


@pytest.mark.parametrize("dtype", list(KINDS))
def test_packing_sees_a_write_through_data(dtype):
    """A write through .data moves neither data_ptr() nor the version
    counter; the units must still hold the new values."""
    _, ks, _ = _operands((1, 1, 1), 9, torch.float32)
    ks = [torch.nn.Parameter(k) for k in ks]
    db.packed_weights(ks, dtype)
    ks[3].data.copy_(torch.randn_like(ks[3]))
    assert torch.equal(db.packed_weights(ks, dtype),
                       db.pack_weights(ks, dtype))


@pytest.mark.parametrize("dtype", list(KINDS))
def test_stacked_packing_matches_each_block(dtype):
    """RRDBNet packs all its blocks at once: row b is block b's units."""
    blocks = [_operands((1, 1, 1), 20 + b, torch.float32)[1]
              for b in range(3)]
    stacked = db.packed_weights([torch.stack(ks) for ks in zip(*blocks)],
                                dtype)
    assert stacked.shape == (3, db.pack_weights(blocks[0], dtype).numel())
    for b, ks in enumerate(blocks):
        assert torch.equal(stacked[b], db.pack_weights(ks, dtype))
