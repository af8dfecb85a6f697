"""The CUDA kernels against their plain versions — needs an NVIDIA card.

Marked ``cuda``: each test skips without a card. On a machine with one,
run them without the JAX conftest (the port needs no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from tpusr_torch.ops import fused_conv as fc

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    """A card-side generator; the plain versions' cuDNN convs in full f32
    (PyTorch's default lets them round through TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cudnn.allow_tf32 = True


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-12))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 7, 9, 5, 6), (2, 33, 70, 132, 128),
                                   (1, 2, 2, 16, 64)])
@pytest.mark.parametrize("reflect", [True, False])
def test_kernels_match_plain_versions(gen, dtype, tol, shape, reflect):
    n, h, w, cin, cout = shape

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    x = rnd(n, h, w, cin).to(dtype)
    wt = (rnd(3, 3, cin, cout) * 0.1).to(dtype)
    es, eb = rnd(cin).abs() + 0.5, rnd(cin) * 0.1
    base, g = rnd(n, h, w, cout).to(dtype), rnd(n, h, w, cout).to(dtype)
    # the plain side: the same values, f32 ones in f64 (exact sums)
    xp, wp, bp, gp = (t.double() if dtype == torch.float32 else t
                      for t in (x, wt, base, g))
    before = dict(fc.LAUNCHES)
    y, st = fc.fused_conv3x3_fwd(x, wt, es, eb, base, act="leaky_relu",
                                 reflect=reflect, stats=True)
    yr, sr = fc.fused_conv3x3_fwd_reference(xp, wp, es, eb, bp,
                                            act="leaky_relu",
                                            reflect=reflect, stats=True)
    dw = fc.fused_conv3x3_wgrad(x, g, es, eb, act="leaky_relu",
                                reflect=reflect)
    dwr = fc.fused_conv3x3_wgrad_reference(xp, gp, es, eb, act="leaky_relu",
                                           reflect=reflect)
    torch.cuda.synchronize()
    assert _rel(y, yr) < tol and _rel(st, sr) < tol and _rel(dw, dwr) < tol
    assert fc.LAUNCHES["fused_conv3x3_fwd"] == before["fused_conv3x3_fwd"] + 1
    assert (fc.LAUNCHES["fused_conv3x3_wgrad"]
            == before["fused_conv3x3_wgrad"] + 1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [
    (1, 64, 96, 128, 128),  # DIP up0-like: full width, whole tiles
    (1, 13, 21, 24, 40),    # widths off the 8 and 16 grid, ragged tiles
    (1, 9, 30, 3, 64),      # an RGB input
    (2, 19, 35, 64, 64),    # N = 2 through the split-K wgrad, ragged
])
def test_tensor_core_kernels_at_path_and_odd_shapes(gen, dtype, tol, shape):
    """Kernels A (forward with prologue, base and stats; dgrad) and B on the
    tensor cores against their plain versions (f32 ones in f64)."""
    n, h, w, cin, cout = shape

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    x = rnd(n, h, w, cin).to(dtype)
    wt = (rnd(3, 3, cin, cout) * 0.1).to(dtype)
    es, eb = rnd(cin).abs() + 0.5, rnd(cin) * 0.1
    base, g = rnd(n, h, w, cout).to(dtype), rnd(n, h, w, cout).to(dtype)
    f64 = dtype == torch.float32
    xp, wp, bp, gp = (t.double() if f64 else t for t in (x, wt, base, g))
    y, st = fc.fused_conv3x3_fwd(x, wt, es, eb, base, act="leaky_relu",
                                 reflect=True, stats=True)
    yr, sr = fc.fused_conv3x3_fwd_reference(xp, wp, es, eb, bp,
                                            act="leaky_relu", reflect=True,
                                            stats=True)
    w_rot = wt.flip(0, 1).transpose(2, 3).contiguous()
    d, _ = fc.fused_conv3x3_fwd(g, w_rot, reflect=False)
    dr, _ = fc.fused_conv3x3_fwd_reference(gp, wp.flip(0, 1).transpose(2, 3),
                                           reflect=False)
    dw = fc.fused_conv3x3_wgrad(x, g, es, eb, act="leaky_relu", reflect=True)
    dwr = fc.fused_conv3x3_wgrad_reference(xp, gp, es, eb, act="leaky_relu",
                                           reflect=True)
    torch.cuda.synchronize()
    errs = {"fwd": _rel(y, yr), "stats": _rel(st, sr), "dgrad": _rel(d, dr),
            "wgrad": _rel(dw, dwr)}
    assert y.shape == (n, h, w, cout) and dw.shape == (3, 3, cin, cout)
    assert all(e < tol for e in errs.values()), errs


@pytest.mark.parametrize("shape", [(1, 64, 96, 128, 128),
                                   (2, 19, 35, 64, 64)])
def test_bf16_kernels_accumulate_in_f32(gen, shape):
    """bf16 inputs without a prologue are exact in f64, so against the f64
    plain version the forward is off by its one bf16 rounding of y
    (2^-9 relative), and the f32 outputs (stats, dw) by f32 accumulation
    alone."""
    n, h, w, cin, cout = shape
    x = torch.randn(n, h, w, cin, generator=gen, device="cuda").bfloat16()
    wt = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda")
          * 0.1).bfloat16()
    g = torch.randn(n, h, w, cout, generator=gen, device="cuda").bfloat16()
    y, st = fc.fused_conv3x3_fwd(x, wt, reflect=True, stats=True)
    yr, sr = fc.fused_conv3x3_fwd_reference(x.double(), wt.double(),
                                            reflect=True, stats=True)
    dw = fc.fused_conv3x3_wgrad(x, g, reflect=False)
    dwr = fc.fused_conv3x3_wgrad_reference(x.double(), g.double(),
                                           reflect=False)
    torch.cuda.synchronize()
    errs = {"fwd": _rel(y.double(), yr), "stats": _rel(st, sr),
            "wgrad": _rel(dw, dwr)}
    print(f"bf16 kernels against f64 at {shape}: {errs}")
    assert errs["fwd"] < 4e-3 and errs["stats"] < 1e-4, errs
    assert errs["wgrad"] < 1e-4, errs


def test_autograd_on_the_card_matches_the_cpu(gen):
    """The Function's backward (dgrad + wgrad kernels, reflect folds,
    prologue backward) on the card against the same Function on the CPU."""
    x = torch.randn(1, 19, 23, 40, generator=gen, device="cuda")
    w = torch.randn(3, 3, 40, 24, generator=gen, device="cuda") * 0.1
    es = torch.rand(40, generator=gen, device="cuda") + 0.5
    eb = torch.randn(40, generator=gen, device="cuda") * 0.1
    base = torch.randn(1, 19, 23, 24, generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (x, w, es, eb, base)]
        y, st = fc.fused_conv3x3(*leaves[:4], act="leaky_relu",
                                 pad_mode="reflection", stats=True,
                                 base=leaves[4])
        (0.5 * y.square().sum() + 0.1 * st[0].sum()
         + 0.01 * st[1].sum()).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _rel(a, b) < 1e-4


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x = torch.randn(1, 8, 8, 4, generator=gen, device="cuda")
    w = torch.randn(3, 3, 4, 4, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_conv3x3_fwd(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="dtype"):
        fc.fused_conv3x3_fwd(x.half(), w.half())
    with pytest.raises(ValueError, match="w must be"):
        fc.fused_conv3x3_fwd(x, w[:, :, :3].contiguous())


def _dense_operands(gen, shape, dtype):
    """x (N,H,W,64) and the 5 canonical kernels and biases, U(+-1/sqrt(fan
    in)) as the net initialises them."""
    from tpusr_torch.ops.dense_block import GC, NF

    def uni(*s, fan_in):
        return (torch.rand(*s, generator=gen, device="cuda") * 2 - 1) \
            / fan_in ** 0.5

    x = torch.randn(*shape, NF, generator=gen, device="cuda").to(dtype)
    ks, bs = [], []
    for i in range(5):
        cin, cout = NF + GC * i, GC if i < 4 else NF
        ks.append(uni(3, 3, cin, cout, fan_in=9 * cin))
        bs.append(uni(cout, fan_in=9 * cin))
    return x, ks, bs


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 7, 9), (1, 13, 70), (2, 16, 20),
                                   (1, 1, 1), (1, 40, 3)])
def test_dense_block_matches_plain_version(gen, dtype, tol, shape):
    from tpusr_torch.ops import dense_block as db

    x, ks, bs = _dense_operands(gen, shape, dtype)
    before = db.LAUNCHES["dense_block"]
    y = db.dense_block(x, ks, bs)
    # the plain side: the same values, f32 ones in f64 (exact sums)
    f64 = dtype == torch.float32
    yr = db.dense_block_reference(x.double() if f64 else x,
                                  [k.double() if f64 else k for k in ks],
                                  [b.double() if f64 else b for b in bs])
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.dtype == dtype
    assert _rel(y, yr) < tol
    assert db.LAUNCHES["dense_block"] == before + 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("edge", [(-1, 1), (0, 0), (1, 2), (2, -1)])
def test_dense_block_at_the_tile_edges(gen, dtype, tol, edge):
    """Kernel C at N = 2 and at sides on each side of its tile's edges
    (tile - 1, tile, tile + 1 and 2 tile + 3 rows or columns, the tile of
    the dtype): the regions' halos cross the image edges and the tiles'."""
    from tpusr_torch.ops import dense_block as db

    sides = {-1: lambda t: t - 1, 0: lambda t: t, 1: lambda t: t + 1,
             2: lambda t: 2 * t + 3}
    th, tw = db.TILE[dtype]
    shape = (2, sides[edge[0]](th), sides[edge[1]](tw))
    x, ks, bs = _dense_operands(gen, shape, dtype)
    y = db.dense_block(x, ks, bs)
    f64 = dtype == torch.float32
    yr = db.dense_block_reference(x.double() if f64 else x,
                                  [k.double() if f64 else k for k in ks],
                                  [b.double() if f64 else b for b in bs])
    torch.cuda.synchronize()
    assert y.shape == x.shape and _rel(y, yr) < tol, (shape, _rel(y, yr))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_block_is_deterministic(gen, dtype):
    """Two launches on the same input give bit-identical outputs (no
    atomics; each output is written by one thread)."""
    from tpusr_torch.ops import dense_block as db

    x, ks, bs = _dense_operands(gen, (2, 37, 45), dtype)
    a = db.dense_block(x, ks, bs)
    b = db.dense_block(x, ks, bs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_dense_block_autograd_on_the_card_matches_the_cpu(gen):
    """Kernel C forward and the plain recompute backward on the card against
    the same Function on the CPU."""
    from tpusr_torch.ops import dense_block as db

    x, ks, bs = _dense_operands(gen, (1, 11, 14), torch.float32)
    outs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in [x] + ks + bs]
        y = db.dense_block(leaves[0], leaves[1:6], leaves[6:])
        y.square().sum().backward()
        outs[dev] = y.detach().cpu()
        grads[dev] = [t.grad.cpu() for t in leaves]
    assert _rel(outs["cuda"], outs["cpu"]) < 1e-4
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _rel(a, b) < 1e-4


def test_dense_block_wrapper_rejects_what_the_kernel_does_not_take(gen):
    from tpusr_torch.ops import dense_block as db

    x, ks, bs = _dense_operands(gen, (1, 8, 8), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        db.dense_block(x.transpose(1, 2), ks, bs)
    with pytest.raises(ValueError, match="dtype"):
        db.dense_block(x.half(), ks, bs)
    with pytest.raises(ValueError, match="device"):
        db.dense_block(x, [k.cpu() for k in ks], bs)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 128, 128, 64, 256),
                                   (1, 85, 127, 64, 64),
                                   (1, 37, 19, 64, 256)])
def test_kernel_a_at_the_srgan_shapes(gen, dtype, tol, shape):
    """The generator's convs: zero pad, no prologue, 64 -> 64 and 64 -> 256,
    at 128^2 and at ragged LR shapes."""
    n, h, w, cin, cout = shape
    x = torch.randn(n, h, w, cin, generator=gen, device="cuda").to(dtype)
    wt = ((torch.rand(3, 3, cin, cout, generator=gen, device="cuda") * 2 - 1)
          / 24).to(dtype)
    before = fc.LAUNCHES["fused_conv3x3_fwd"]
    y, _ = fc.fused_conv3x3_fwd(x, wt, reflect=False)
    f64 = dtype == torch.float32
    yr, _ = fc.fused_conv3x3_fwd_reference(x.double() if f64 else x,
                                           wt.double() if f64 else wt,
                                           reflect=False)
    torch.cuda.synchronize()
    assert y.shape == (n, h, w, cout) and _rel(y, yr) < tol
    assert fc.LAUNCHES["fused_conv3x3_fwd"] == before + 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(8, 24, 24, 64, 64), (8, 24, 24, 64, 256),
                                   (8, 48, 48, 64, 256),
                                   (8, 96, 96, 64, 256)])
def test_kernels_at_the_srgan_training_shapes(gen, dtype, tol, shape):
    """The training generator's convs under g_fuse='train' at batch 8 on
    the 24^2 patch: kernel A forward, its dgrad (Cout -> 64, so Cin = 256
    for the 64 -> 256 convs) and kernel B, zero pad, no prologue."""
    n, h, w, cin, cout = shape
    x = torch.randn(n, h, w, cin, generator=gen, device="cuda").to(dtype)
    wt = ((torch.rand(3, 3, cin, cout, generator=gen, device="cuda") * 2 - 1)
          / 24).to(dtype)
    g = torch.randn(n, h, w, cout, generator=gen, device="cuda").to(dtype)
    f64 = dtype == torch.float32
    xp, wp, gp = (t.double() if f64 else t for t in (x, wt, g))
    w_rot = wt.flip(0, 1).transpose(2, 3).contiguous()
    y, _ = fc.fused_conv3x3_fwd(x, wt, reflect=False)
    d, _ = fc.fused_conv3x3_fwd(g, w_rot, reflect=False)
    dw = fc.fused_conv3x3_wgrad(x, g, reflect=False)
    yr, _ = fc.fused_conv3x3_fwd_reference(xp, wp, reflect=False)
    dr, _ = fc.fused_conv3x3_fwd_reference(
        gp, wp.flip(0, 1).transpose(2, 3), reflect=False)
    dwr = fc.fused_conv3x3_wgrad_reference(xp, gp, reflect=False)
    torch.cuda.synchronize()
    errs = {"fwd": _rel(y, yr), "dgrad": _rel(d, dr), "wgrad": _rel(dw, dwr)}
    assert d.shape == (n, h, w, cin) and dw.shape == (3, 3, cin, cout)
    assert all(e < tol for e in errs.values()), errs


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_a_at_the_rrdb_shape(gen, dtype, tol):
    """RRDBNet's trunk and upsampling convs: zero pad, no prologue, 64 ->
    64, on a 270 x 480 frame (a ragged last row of tiles)."""
    x = torch.randn(1, 270, 480, 64, generator=gen, device="cuda").to(dtype)
    wt = ((torch.rand(3, 3, 64, 64, generator=gen, device="cuda") * 2 - 1)
          / 24).to(dtype)
    y, _ = fc.fused_conv3x3_fwd(x, wt, reflect=False)
    f64 = dtype == torch.float32
    yr, _ = fc.fused_conv3x3_fwd_reference(x.double() if f64 else x,
                                           wt.double() if f64 else wt,
                                           reflect=False)
    torch.cuda.synchronize()
    assert _rel(y, yr) < tol


def check_gaussian_against_plain(got, want):
    """Equal, except where log/cos of the card and of the plain version
    differ by an ulp next to an integer: a fraction <= 1e-4 of the
    elements, each off by exactly 1."""
    diff = (got - want).abs()
    assert set(diff.unique().tolist()) <= {0.0, 1.0}
    assert float((diff > 0).float().mean()) <= 1e-4


@pytest.mark.parametrize("shape", [(1356, 2040, 3), (85, 128, 3), (7, 9, 3),
                                   (1, 1, 3), (3, 5, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, -7])
def test_degradation_kernels_match_plain_versions(gen, shape, seed):
    from tpusr_torch.ops import fused_degrade as fd

    img = torch.randint(0, 256, shape, generator=gen, device="cuda").float()
    before = dict(fd.LAUNCHES)
    g = fd.fused_add_gaussian_noise(img, seed, std=0.1)
    sp = fd.fused_add_salt_pepper_noise(img, seed, s=0.05, p=0.05)
    gr = fd.fused_add_gaussian_noise_reference(img, seed, std=0.1)
    spr = fd.fused_add_salt_pepper_noise_reference(img, seed, s=0.05, p=0.05)
    torch.cuda.synchronize()
    assert g.shape == sp.shape == shape and g.dtype == torch.float32
    check_gaussian_against_plain(g, gr)
    assert torch.equal(sp, spr)
    assert fd.LAUNCHES["fused_add_gaussian_noise"] == (
        before["fused_add_gaussian_noise"] + 1)
    assert fd.LAUNCHES["fused_add_salt_pepper_noise"] == (
        before["fused_add_salt_pepper_noise"] + 1)


def test_degradation_kernels_statistics(gen):
    """tests/test_pallas.py's checks on the card: range, integers, mean and
    spread, rates, channel-shared masks, untouched pixels."""
    from tpusr_torch.ops import fused_degrade as fd

    out = fd.fused_add_gaussian_noise(
        torch.full((64, 128, 3), 128.0, device="cuda"), 7, std=0.1)
    assert 0 <= float(out.min()) and float(out.max()) <= 255
    assert torch.equal(out, out.floor())
    assert 20 < float(out.std()) < 32 and abs(float(out.mean()) - 128) < 3
    sp = fd.fused_add_salt_pepper_noise(
        torch.full((128, 128, 3), 128.0, device="cuda"), 5, s=0.05, p=0.05)
    salt, pepper = sp == 255, sp == 0
    assert torch.equal(salt.all(-1), salt.any(-1))
    assert torch.equal(pepper.all(-1), pepper.any(-1))
    assert 0.02 < float(salt[..., 0].float().mean()) < 0.08
    assert 0.02 < float(pepper[..., 0].float().mean()) < 0.08
    assert torch.all(sp[~salt & ~pepper] == 128.0)


def test_lbfgs_fixed_iteration_on_the_card_matches_the_cpu(gen):
    """One L-BFGS 'fixed' iteration of a small DIP net on the deterministic
    objective: on the card through kernels A (forward, dgrad) and B, against
    the same iteration on the CPU through their plain versions."""
    from tpusr_torch.engine import dip
    from tpusr_torch.engine.lbfgs import lbfgs_fixed_init, lbfgs_fixed_step

    config = dip.DIPConfig(factor=4, input_depth=8, skip_n33d=32,
                           skip_n33u=32, num_scales=3)
    cpu = torch.Generator().manual_seed(0)
    z = torch.rand(1, 48, 48, 8, generator=cpu).permute(0, 3, 1, 2) * 0.1
    lr = torch.rand(1, 3, 12, 12, generator=cpu)
    out = {}
    for dev in ("cuda", "cpu"):
        net, down = dip.build(config, torch.Generator().manual_seed(1))
        net.to(dev, memory_format=torch.channels_last)
        down.to(dev)
        leaves = list(net.parameters())
        before = dict(fc.LAUNCHES)
        loss = dip.dip_loss(net, down, z.to(dev), lr.to(dev),
                            update_stats=False)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        flat = torch.cat([g.reshape(-1) for g in grads])
        upd, _ = lbfgs_fixed_step(flat, lbfgs_fixed_init(flat.numel(), 10,
                                                         dev), 0.01)
        torch.cuda.synchronize()
        out[dev] = (float(loss), flat.cpu(), upd.cpu())
        if dev == "cuda":  # 6 fused convs: forward and dgrad (A), wgrad (B)
            assert fc.LAUNCHES["fused_conv3x3_fwd"] - before[
                "fused_conv3x3_fwd"] == 12
            assert fc.LAUNCHES["fused_conv3x3_wgrad"] - before[
                "fused_conv3x3_wgrad"] == 6
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * out["cpu"][0]
    assert _rel(out["cuda"][1], out["cpu"][1]) < 1e-4
    assert _rel(out["cuda"][2], out["cpu"][2]) < 1e-4


def test_tiled_generator_forward_matches_the_whole_image(gen):
    """Exact tiling on the card: 3 row tiles of a 70-row LR (windows 64
    rows, shorter than the image) against the whole-image forward, TF32
    off; kernel A runs in both."""
    from tpusr_torch.engine.gan import (GANTrainConfig, build_generator,
                                        generator_forward)
    from tpusr_torch.parallel.spatial import tiled_generator_forward

    config = GANTrainConfig(factor=8, residual_blocks_count=2)
    g = build_generator(config, "cuda", torch.Generator().manual_seed(0))
    lr = torch.rand(1, 70, 9, 3, generator=gen, device="cuda") * 2 - 1
    before = fc.LAUNCHES["fused_conv3x3_fwd"]
    with torch.inference_mode():
        tiled = tiled_generator_forward(g, lr, config, n_tiles=3)
        whole = generator_forward(g, lr, config)
    torch.cuda.synchronize()
    assert fc.LAUNCHES["fused_conv3x3_fwd"] > before
    assert tiled.shape == whole.shape == (1, 560, 72, 3)
    assert float((tiled - whole).abs().max()) <= 1e-4


def test_dp_step_at_world_size_1_is_the_single_step(gen):
    """make_dp_train_step over a one-rank NCCL group (g_fuse='train':
    kernels A and B) gives gan_train_step's losses and state bit for bit,
    with cuDNN deterministic and TF32 off."""
    import torch.distributed as dist

    from tpusr_torch.engine import gan as pg
    from tpusr_torch.parallel.gan_dp import make_dp_train_step
    from tpusr_torch.parallel.mesh import make_mesh

    cfg = pg.GANTrainConfig(factor=4, batch_size=8, hr_patch=32,
                            residual_blocks_count=2, g_fuse="train",
                            d_moments="f32", d_params="f32")

    def state():
        return pg.create_gan_state(cfg, 1e-4, generator=torch.Generator()
                                   .manual_seed(0), device="cuda")

    lo = torch.rand(8, 8, 8, 3, generator=gen, device="cuda")
    hi = torch.rand(8, 32, 32, 3, generator=gen, device="cuda") * 2 - 1
    torch.backends.cudnn.deterministic = True
    try:
        single, ls = pg.gan_train_step(state(), lo, hi, cfg)
        place, step = make_dp_train_step(make_mesh(devices="cuda"), cfg,
                                         1e-4)
        before = dict(fc.LAUNCHES)
        dp, ld = step(place(state()), lo, hi)
        torch.cuda.synchronize()
        # 7 fused convs at 2 blocks, x4: forward and dgrad (A), wgrad (B)
        assert fc.LAUNCHES["fused_conv3x3_fwd"] - before[
            "fused_conv3x3_fwd"] == 14
        assert fc.LAUNCHES["fused_conv3x3_wgrad"] - before[
            "fused_conv3x3_wgrad"] == 7
        for k in ls:
            assert float(ls[k]) == float(ld[k]), k
        for net in ("G", "D"):
            want = getattr(single, net).state_dict()
            for k, v in getattr(dp, net).state_dict().items():
                assert torch.equal(v, want[k]), (net, k)
    finally:
        torch.backends.cudnn.deterministic = False
        if dist.is_initialized():
            dist.destroy_process_group()


def _sharded_on_the_card(rank, work):
    """A worker of a two-process gloo group sharing the card."""
    import os

    from tpusr_torch.engine.gan import GANTrainConfig, build_generator
    from tpusr_torch.parallel.mesh import make_mesh
    from tpusr_torch.parallel.spatial import sharded_generator_forward

    torch.backends.cudnn.allow_tf32 = False
    config = GANTrainConfig(factor=4, residual_blocks_count=2)
    g = build_generator(config, "cuda", torch.Generator().manual_seed(0))
    lr = torch.load(os.path.join(work, "lr.pt")).cuda()
    before = fc.LAUNCHES["fused_conv3x3_fwd"]
    with torch.inference_mode():
        out = sharded_generator_forward(
            g, lr, config, halo=12,
            mesh=make_mesh({"spatial": 2}, "cuda", backend="gloo"))
    torch.cuda.synchronize()
    torch.save({"out": out.cpu(),
                "launches": fc.LAUNCHES["fused_conv3x3_fwd"] - before},
               os.path.join(work, f"r{rank}.pt"))


def test_sharded_forward_two_processes_on_the_card(gen, tmp_path):
    """sharded_generator_forward over two processes that share the card
    (gloo: NCCL refuses two ranks on one GPU), slab 48 >= 2 * halo 24:
    every rank returns the whole image, equal to generator_forward (TF32
    off, 1e-5), each through kernel A."""
    import os

    from tpusr_torch.engine.gan import (GANTrainConfig, build_generator,
                                        generator_forward)
    from tpusr_torch.parallel.mesh import spawn

    lr = torch.rand(1, 96, 16, 3, generator=gen, device="cuda")
    torch.save(lr.cpu(), tmp_path / "lr.pt")
    spawn(_sharded_on_the_card, 2, (str(tmp_path),), backend="gloo",
          store_dir=str(tmp_path))
    config = GANTrainConfig(factor=4, residual_blocks_count=2)
    g = build_generator(config, "cuda", torch.Generator().manual_seed(0))
    with torch.inference_mode():
        whole = generator_forward(g, lr, config).cpu()
    for r in range(2):
        got = torch.load(os.path.join(tmp_path, f"r{r}.pt"))
        assert got["launches"] > 0
        assert float((got["out"] - whole).abs().max()) <= 1e-5


def test_lane_batch_on_the_card(gen):
    """The DIP lane batch on the card (conv_fusion 'off': no kernel): each
    lane starts as its single-image run (first PSNR head within 1e-4 dB)
    and its curves stay within tpusr's 0.5 dB."""
    import numpy as np

    from tpusr_torch.engine import dip

    cfg = dip.DIPConfig(factor=4, num_iter=20, log_freq=10, input_depth=8,
                        skip_n33d=16, skip_n33u=16, skip_n11=4,
                        num_scales=3, conv_fusion="off")
    lr = torch.rand(2, 1, 16, 16, 3, generator=gen, device="cuda")
    hr = torch.rand(2, 1, 64, 64, 3, generator=gen, device="cuda")
    before = dict(fc.LAUNCHES)
    res, curves = dip.dip_superresolve_batch(
        lr, hr, [torch.Generator().manual_seed(i) for i in range(2)], cfg)
    assert dict(fc.LAUNCHES) == before
    assert res.shape == (2, 1, 64, 64, 3) and bool(torch.isfinite(res).all())
    for i in range(2):
        _, one = dip.dip_superresolve(lr[i], hr[i], cfg,
                                      torch.Generator().manual_seed(i))
        assert abs(curves["psnr"][i, 0] - one["psnr"][0]) < 1e-4
        np.testing.assert_allclose(curves["psnr"][i], one["psnr"], atol=0.5)
