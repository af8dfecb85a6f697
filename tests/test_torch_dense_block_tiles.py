"""Kernel C's tile geometry, checked on the CPU where no card is.

The constants are read from ``tpusr_torch/csrc/dense_block.cu``; the shared
memory, the recompute factor and the tile cover are recomputed from them;
a plain emulation of the kernel's schedule (per tile, each stage on its
region with M padded as the kernel pads it, the taps as pixel offsets into
each source at its own pitch, the weights read from the packed units at the
kernel's slot addresses) is held to tpusr's ``dense_block_reference``; and
a model of the bf16 kernel's weight ring (its mbarriers' phases, the
producer's and the consumers' waits and releases) is run under every
interleaving a seeded scheduler draws.
"""

import math
import os
import random
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
    assert c["B16_NUNITS"] == db.B16_NUNITS
    assert c["HALO"] == HALO and (c["NF"], c["GC"]) == (NF, GC)
    for dtype, count in ((torch.float32, db.NUNITS),
                         (torch.bfloat16, db.B16_NUNITS)):
        assert len(_unit_shapes(dtype)) == count
    # a slot holds the largest bf16 unit, y's kernel row: 3 taps x 16 x 64
    assert c["B16_SLOT"] == 3 * db.KC * NF * 2


@pytest.mark.parametrize("dtype", list(KINDS))
def test_shared_memory_fits_and_matches_the_note(dtype):
    """x and c1..c4, the weight ring and, in bf16, the mbarriers: full and
    empty per slot, one per chunk of x, c1..c4's, 8 bytes each."""
    th, tw, rh, rw, size, _, c = _geometry(dtype)
    acts = sum(rh[s] * rw[s] * (NF if s == 0 else GC) * size
               for s in range(5))
    if dtype == torch.bfloat16:
        assert 8 * (2 * c["B16_RING"] + NF // db.KC + 4) <= c["B16_BARS"]
        head = c["B16_BARS"] + c["B16_RING"] * c["B16_SLOT"]
        assert head % 16 == 0 and c["B16_SLOT"] % 128 == 0
    else:
        head = c["RING"] * 9 * c["KC"] * c["UNIT_N"] * size
    total = acts + head
    assert total <= SMEM_MAX
    note = _source()
    assert f"{acts:,}" in note and f"{total:,}" in note


@pytest.mark.parametrize("dtype", list(KINDS))
def test_recompute_factor_matches_the_note(dtype):
    """Multiply-adds the tile computes (M padded at its end) over the useful
    239,616 a pixel, as the source's note and the wrapper state it; in bf16
    with the padding tile of a stage whose M tiles the two consumer
    warpgroups cannot split evenly, and as the note states it without."""
    th, tw, rh, rw, _, mpad, _ = _geometry(dtype)
    tiles = [math.ceil(rh[s] * rw[s] / mpad) for s in range(6)]

    def factor(tiles):
        return sum(tiles[s] * mpad * 9 * _cin(s) * _cout(s)
                   for s in range(1, 6)) / (th * tw) / USEFUL

    bare = factor(tiles)
    done = factor([t + t % 2 for t in tiles]) if dtype == torch.bfloat16 \
        else bare
    assert USEFUL == 239_616 == db.USEFUL_MACS
    prose = re.sub(r"\s*\n//\s*", " ", _source())  # the note's lines joined
    assert f"{done:.3f}x" in prose
    assert db.recompute_factor(dtype) == pytest.approx(done)
    assert mpad == db.M_PAD[dtype]
    if dtype == torch.bfloat16:
        assert done > bare
        assert f"{done:.3f}x ({done * USEFUL:,.0f} a pixel" in prose
        assert (f"{bare:.3f}x, {bare * USEFUL:,.0f} a pixel, without those "
                f"two tiles" in prose)


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


def _kernel_source(dtype):
    """One dtype's kernel: its section of dense_block.cu, and a test of
    whether that section calls a primitive whose source holds a text."""
    src = _source()
    marks = [re.search(r"// -+ %s" % name, src).start()
             for name in ("primitives", "the tile", "bf16 kernel",
                          "f32 kernel")] + [src.index("}  // namespace")]
    prims = re.sub(r"//[^\n]*", "", src[marks[0]:marks[1]])
    body = (src[marks[2]:marks[3]] if dtype == torch.bfloat16
            else src[marks[3]:marks[4]])
    heads = list(re.finditer(r"__device__ __forceinline__ \w+ (\w+)\(",
                             prims))

    def calls(text):
        return any(text in prims[m.start():nxt.start() if nxt else None]
                   and re.search(r"\b%s\b" % m.group(1), body)
                   for m, nxt in zip(heads, heads[1:] + [None]))
    return body, calls


@pytest.mark.parametrize("dtype,products", [
    (torch.bfloat16, ("wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16",
                      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16")),
    (torch.float32, ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",))])
def test_the_kernel_runs_on_the_tensor_cores(dtype, products):
    """wgmma in bf16 (m64n32k16 for c1..c4, one m64n64k16 for y), mma.sync
    in f32, no FMA main loop left, and no main-loop logic shared: bf16
    streams its weights by bulk copies behind mbarriers with one block-wide
    barrier (the mbarriers' set-up), f32 by cp.async behind block-wide
    barriers."""
    body, calls = _kernel_source(dtype)
    for product in products:
        assert calls(product)
    assert "fmaf(" not in _source() and "__fmaf" not in _source()
    if dtype == torch.bfloat16:
        assert "N = S == 5 ? NF : GC" in body  # y: one product over all 64
        assert calls("cp.async.bulk.shared::cluster.global.mbarrier")
        assert calls("setmaxnreg.dec") and calls("setmaxnreg.inc")
        assert body.count("__syncthreads") == 1 and "ring_step" not in body
        assert not calls("mma.sync.aligned")
    else:
        assert "ring_step" in body and not calls("wgmma")
        assert not calls("mbarrier")


# ------------------------------------------------------- schedule emulation
def _unit_shapes(dtype):
    """(stage, chunk, part, taps, outputs) of each weight unit in the order
    the kernel consumes them: bf16 part = the kernel row dy (3 taps, all the
    stage's outputs), f32 part = the half of 32 outputs (9 taps)."""
    out = []
    for s in range(1, 6):
        for c in range(_cin(s) // db.KC):
            if dtype == torch.bfloat16:
                out += [(s, c, dy, 3, _cout(s)) for dy in range(3)]
            else:
                out += [(s, c, h, 9, db.UNIT_N)
                        for h in range(_cout(s) // db.UNIT_N)]
    return out


def _slot_index(dtype, t, k, n, n_out):
    """Element index of weight (tap t of the unit, chunk channel k, output n)
    in a unit of n_out outputs, at the kernel's slot addresses."""
    if dtype == torch.bfloat16:  # a tap 32 n_out B, LBO 16 n_out B, SBO 128 B
        return (t * 16 * n_out + (k // 8) * 8 * n_out + (n // 8) * 64
                + (k % 8) * 8 + n % 8)
    return ((t * 4 + k // 4) * 32 + n) * 4 + k % 4  # ldmatrix rows of 16 B


def _units(kernels, dtype):
    """The packed units, each read back as (taps, 16, outputs) [t][k][n]."""
    flat = db.pack_weights(kernels, dtype).double()
    units, off = [], 0
    for _, _, _, taps, n_out in _unit_shapes(dtype):
        size = taps * db.KC * n_out
        t, k, n = np.meshgrid(np.arange(taps), np.arange(db.KC),
                              np.arange(n_out), indexing="ij")
        idx = torch.from_numpy(_slot_index(dtype, t, k, n, n_out))
        units.append(flat[off:off + size][idx])
        off += size
    assert off == flat.numel()
    return units


def _stage_weights(kernels, dtype):
    """{(stage, chunk): (9, 16, cout)}: the weights as the kernel reads them
    from its units."""
    w = {}
    for (s, c, part, _, n_out), unit in zip(_unit_shapes(dtype),
                                           _units(kernels, dtype)):
        cur = w.setdefault((s, c), torch.zeros(9, db.KC, _cout(s),
                                                dtype=torch.float64))
        if dtype == torch.bfloat16:
            cur[3 * part:3 * part + 3] = unit
        else:
            cur[:, :, n_out * part:n_out * (part + 1)] = unit
    return w


def _m_pixels(dtype, rh, rw, mpad):
    """The region pixel of every M row of a stage, tile after tile, as the
    kernel maps them (padding included). bf16 where 8 x 8 blocks tile the
    region (A straight from shared memory): tile mt is block (mt // (rw /
    8), mt % (rw / 8)), its row 16 wq + lane / 4 + 8 r pixel (2 wq + r,
    lane / 4) of the block; elsewhere 64 pixels in row order, padding rows
    on the last pixel. The two consumer warpgroups take tiles 0, 2, ... and
    1, 3, ...; the second takes a padding tile where the count is odd (it
    repeats the last tile)."""
    npix = rh * rw
    if dtype == torch.bfloat16 and rh % 8 == 0 and rw % 8 == 0:
        mtiles = (rh // 8) * (rw // 8)
        rows = []
        for mt in range(mtiles):
            for wq in range(4):
                for r in range(2):
                    for quad in range(8):  # lane // 4
                        py, px = 2 * wq + r, quad
                        rows.append((8 * (mt // (rw // 8)) + py) * rw
                                    + 8 * (mt % (rw // 8)) + px)
        m = torch.tensor(rows).reshape(mtiles, 8, 8)  # [tile][wq, r][quad]
        # rows in wgmma order: 16 wq + lane // 4 + 8 r = 8 (2 wq + r) + quad
        m = m.reshape(mtiles, 64)
    else:
        mtiles = math.ceil(npix / mpad)
        m = torch.arange(mtiles * mpad).clamp(max=npix - 1).reshape(mtiles, mpad)
    assert sorted(set(m.reshape(-1).tolist())) == list(range(npix))
    if dtype == torch.bfloat16:
        owned = [mt for g in (0, 1) for mt in range(g, mtiles + mtiles % 2, 2)]
        assert sorted(owned) == list(range(mtiles + mtiles % 2))
        if mtiles % 2:  # the padding tile repeats the last
            m = torch.cat([m, m[-1:]])
    return m.reshape(-1)


def emulate(x, kernels, biases, dtype):
    """Kernel C's schedule in f64 on the CPU: x (N, H, W, 64); the weights
    as the kernel reads them (packed in dtype), the arithmetic in f64. In
    bf16 the stage's M tiles are split between the two consumer
    warpgroups as the kernel splits them."""
    th, tw, rh, rw, _, mpad, _ = _geometry(dtype)
    weights = _stage_weights(kernels, dtype)
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
                for s in range(1, 6):
                    npix = rh[s] * rw[s]
                    mc = _m_pixels(dtype, rh[s], rw[s], mpad)
                    oy, ox = mc // rw[s], mc % rw[s]
                    acc = torch.zeros(len(mc), _cout(s), dtype=torch.float64)
                    for c in range(_cin(s) // db.KC):
                        j = 0 if c < NF // db.KC else (c - 4) // 2 + 1
                        ch0 = db.KC * c if j == 0 else db.KC * ((c - 4) % 2)
                        d = s - j - 1
                        wt = weights[(s, c)]
                        for t in range(9):
                            dy, dx = divmod(t, 3)
                            idx = (oy + d + dy) * rw[j] + ox + d + dx
                            assert int(idx.max()) < rh[j] * rw[j]
                            a = bufs[j][idx, ch0:ch0 + db.KC]
                            acc += a @ wt[t]
                    first = torch.zeros(npix, dtype=torch.long)  # each pixel's
                    first.scatter_(0, mc.flip(0), torch.arange(len(mc)).flip(0))
                    acc = acc[first] + bs[s - 1]  # first row computes it
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
    reads for its stage, chunk, kernel row (bf16) or output half (f32), tap
    and channel; the bf16 units are 3,072 bytes for c1..c4 and 6,144 for y,
    as the producer copies them."""
    _, ks, _ = _operands((1, 1, 1), 7, dtype)
    for (s, c, part, taps, n_out), unit in zip(_unit_shapes(dtype),
                                               _units(ks, dtype)):
        k = ks[s - 1].reshape(3, 3, _cin(s), _cout(s))[
            :, :, db.KC * c:db.KC * (c + 1)]
        if dtype == torch.bfloat16:
            want = k[part]
            assert unit.numel() * 2 == (3072 if s < 5 else 6144)
        else:
            want = k.reshape(9, db.KC, _cout(s))[
                :, :, n_out * part:n_out * (part + 1)]
        assert torch.equal(unit, want.double())
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


# ------------------------------------------------------- the bf16 weight ring
class _Mbarrier:
    """An mbarrier: a phase completes when its arrivals are all in and its
    transaction bytes have landed; try_wait.parity(q) passes while the
    current phase's parity differs from q."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, n=1, tx=0):
        self.pending -= n
        self.tx += tx
        assert self.pending >= 0
        self._complete()

    def landed(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passes(self, parity, want):
        """try_wait.parity for the completion of phase ``want``: passing on
        any other phase is a parity that aliases."""
        ok = (self.phase & 1) != parity
        assert not ok or self.phase == want + 1, (self.phase, want)
        return ok


def _consumer_program(g, ring):
    """Consumer warpgroup g's operations on the ring and the stage barriers,
    in the kernel's order (stage_bf16): waits, 3-wgmma groups (each
    followed by wgmma.wait_group 1), releases, epilogues."""
    _, _, rh, rw, _, mpad, _ = _geometry(torch.bfloat16)
    ops, u = [], 0
    for s in range(1, 6):
        mtiles = math.ceil(rh[s] * rw[s] / mpad)
        mine = list(range(g, mtiles + mtiles % 2, 2))  # a padding tile
        for c in range(_cin(s) // db.KC):
            if s == 1:
                ops.append(("wait_x", c))
            if s > 1 and c == 2 * s:
                ops.append(("wait_c", s - 1))
            ops.append(("source", s, 0 if c < 4 else (c - 4) // 2 + 1, c))
            for dy in range(3):
                for i, _ in enumerate(mine):
                    if i == 0:
                        ops.append(("wait_full", u))
                    ops.append(("group", u))
                    if i == 0 and (c > 0 or dy > 0):
                        ops.append(("release", u - 1))
                u += 1
        ops += [("drain",), ("release", u - 1), ("epilogue", s)]
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_bf16_ring_protocol(seed):
    """The bf16 kernel's producer, x loaders and two consumer warpgroups
    under a seeded scheduler: every group reads the unit it expects, no
    copy lands in a slot whose unit a group still reads or has yet to read,
    no wait passes on an aliased parity, a stage reads c_j only after both
    warpgroups stored it, and nothing deadlocks."""
    c = _constants()
    ring, nunits = c["B16_RING"], c["B16_NUNITS"]
    rng = random.Random(seed)
    full = [_Mbarrier(1) for _ in range(ring)]
    empty = [_Mbarrier(8) for _ in range(ring)]
    x_ready = [_Mbarrier(c["B16_XLOADERS"]) for _ in range(NF // db.KC)]
    c_ready = [_Mbarrier(256) for _ in range(5)]
    progs = [_consumer_program(g, ring) for g in (0, 1)]
    groups = {}  # unit -> groups of both warpgroups
    for prog in progs:
        for op in prog:
            if op[0] == "group":
                groups[op[1]] = groups.get(op[1], 0) + 1
    assert sorted(groups) == list(range(nunits))
    pc, inflight, done_read = [0, 0], [None, None], {}
    stored = [set(), set()]
    content = [None] * ring
    produced, copies, x_loaded = 0, [], 0

    def step_consumer(g):
        op = progs[g][pc[g]]
        kind = op[0]
        if kind == "wait_x" and not x_ready[op[1]].passes(0, 0):
            return False
        if kind == "wait_c" and not c_ready[op[1]].passes(0, 0):
            return False
        if kind == "wait_full":
            u = op[1]
            if not full[u % ring].passes((u // ring) & 1, u // ring):
                return False
        if kind == "source" and op[2] > 0:
            assert all(op[2] in st for st in stored)
        if kind == "source" and op[2] == 0:  # chunk c of x has landed
            assert x_loaded > op[3]
        if kind == "group":
            u = op[1]
            assert content[u % ring] == u
            done_read[u] = done_read.get(u, 0) + 1
            inflight[g] = u  # wait_group 1: the earlier groups retired
        if kind == "drain":
            inflight[g] = None
        if kind == "release":
            assert inflight[g] != op[1]  # retired before its slot is freed
            empty[op[1] % ring].arrive(4)
        if kind == "epilogue":
            stored[g].add(op[1])
            if op[1] < 5:
                c_ready[op[1]].arrive(128)
        pc[g] += 1
        return True

    while True:
        moves = []
        if produced < nunits:
            u = produced
            if u < ring or empty[u % ring].passes(((u // ring) & 1) ^ 1,
                                                  u // ring - 1):
                moves.append("produce")
        moves += [("land", i) for i in range(len(copies))]
        if x_loaded < NF // db.KC:
            moves.append("load_x")
        moves += [("consume", g) for g in (0, 1) if pc[g] < len(progs[g])]
        if not moves:
            break
        rng.shuffle(moves)
        for move in moves:
            if move == "produce":
                u = produced
                nbytes = 3072 if u < 84 else 6144
                full[u % ring].arrive(1, tx=nbytes)
                copies.append((u, nbytes))
                produced += 1
            elif move == "load_x":  # one chunk of x lands, in order
                x_ready[x_loaded].arrive(c["B16_XLOADERS"])
                x_loaded += 1
            elif move[0] == "land":
                u, nbytes = copies.pop(move[1])
                old = content[u % ring]
                if old is not None:  # every group of it issued and retired
                    assert done_read.get(old, 0) == groups[old]
                    assert old not in inflight
                content[u % ring] = u
                full[u % ring].landed(nbytes)
            elif not step_consumer(move[1]):
                continue
            break
        else:
            break  # every actor waits: a deadlock unless all are done
    assert produced == nunits and not copies
    assert pc == [len(p) for p in progs], "deadlock"
    assert all(done_read[u] == groups[u] for u in groups)
