"""tpusr_torch's multi-device paths on the CPU, in gloo process groups.

Two groups are spawned, of 4 and of 2 ranks (FileStore in tmp_path, no
TCP port; one thread each; the workers import no JAX). Each rank runs a
battery of checks and saves what it computed; the tests compare those
results with the port's single-process functions and with tpusr's on its
8-virtual-device CPU mesh, both computed here in the parent.

Tolerances:
  * the sharded forward: the whole-image forward and tpusr's sharded
    forward within 1e-5 (edge-exact); the zero-filled fallback's interior
    as tpusr's test holds it, 2e-5;
  * the DP step: losses within 5e-4 and parameters within 1e-3 of the
    single-process step and of tpusr's ``gan_train_step``
    (tests/test_parallel.py's bounds). Those cannot see the gradient:
    Adam's first step moves every element by lr times its gradient's
    sign, so two first steps part by at most 2 lr = 2e-4 whatever the
    gradients were. The reduced gradients are held through each rank's
    Adam first moments after the step, exp_avg = (1 - b1) g, in relative
    L2 per net: D's after that step within 1e-5 of the single step's
    (one bf16 rounding, 2^-8, where D's moments are stored in bf16); both
    nets' after an EXACT step (see below) within 1e-6 of it; against
    tpusr's, ``TPUSR_MOMENT_TOL``;
  * global BatchNorm: running statistics, outputs and input gradients
    within 1e-5 (1e-6 absolute) of one BatchNorm over the whole batch;
  * the DP epochs: 2e-3, as tests/test_gan_epochs_dp.py; two EXACT
    steps in f32, the first moments within ``F32_GRAD_TOL``;
  * the sharded DIP: tpusr's criteria (tests/test_parallel.py:183-190),
    with the PSNR curves tightened from 0.5 to 1e-3 dB.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from tpusr_torch.engine import gan as pg
from tpusr_torch.parallel import mesh as pm

CFG = dict(factor=4, batch_size=8, hr_patch=32, residual_blocks_count=2)
F32_D = dict(d_moments="f32", d_params="f32")
LR = 1e-4
HALO = 12
# The reduced gradients, read from Adam's first moments after the step
# ((1 - b1) g), in relative L2 per net; measurements on a CPU. D's is
# taken before any update and is held after every step. G's is taken
# through the just-updated D, and two cases part it without a fault:
# at LR, D's first step turns rounding-level differences into 2 lr sign
# flips (measured 2.5e-3 at W=2, 6.1e-3 at W=4); and a LeakyReLU input
# of D within rounding of zero changes its slope (a 1e-6 relative change
# of G's output moved G's gradient by 1.7e-4 in one of four draws; W=4
# at lr 0: 3.2e-4); G's PReLUs do the same in f32 (content only, W=4:
# 1.9e-5). So both nets' gradients are held in an EXACT step: lr 0 (no
# net moves), adv_weight 0 (no path from G through D), in f64, where
# only the all-reduce's f32 buffer parts them from one process (measured
# 5e-8; rank 0's half batch alone would part them by 0.43 for G and 2.1
# for D). D's gradient covers the global BatchNorm backward through D.
# The f32 epochs hold the same step twice.
LR_EXACT = 0.0
EXACT = dict(adv_weight=0.0)
F64_GRAD_TOL = {"G": 1e-6, "D": 1e-6}
F32_GRAD_TOL = {"G": 1e-4, "D": 1e-5}
F32_MOMENT_TOL = 1e-5  # D at LR
BF16_MOMENT_TOL = 2.0 ** -8  # D's moments stored in bf16
# against tpusr's f32 step: D's gradient through the fake group is
# ill-conditioned at random init (tests/test_torch_gan_train.py), measured
# 3.1e-3; G's (EXACT) measured 1.2e-4
TPUSR_MOMENT_TOL = {"G": 1e-3, "D": 1e-2}
TINY_DIP = dict(factor=2, num_iter=8, log_freq=4, input_depth=4,
                skip_n33d=8, skip_n33u=8, skip_n11=2, num_scales=2)
TINY_CLI = ["--residual_blocks", "2", "--hr_patch_size", "64",
            "--pre_train_epochs", "1", "--fine_tune_epochs", "1",
            "--train_log_freq", "1", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _batch():
    rng = np.random.default_rng(0)
    return (rng.random((8, 8, 8, 3)).astype(np.float32),
            (rng.random((8, 32, 32, 3)) * 2 - 1).astype(np.float32))


def _image(h, w, seed):
    return np.random.default_rng(seed).random((1, h, w, 3)).astype(
        np.float32)


def _state(cfg, path=None, lr=LR):
    state = pg.create_gan_state(cfg, lr, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    if path is not None:
        sd = torch.load(path)
        state.G.load_state_dict(sd["G"])
        state.D.load_state_dict(sd["D"])
    return state


def _exact(path):
    """The EXACT step's config, f64 state (tpusr's weights) and batch."""
    cfg = pg.GANTrainConfig(**CFG, **F32_D, **EXACT)
    state = _state(cfg, path, lr=LR_EXACT)
    state.G.double()
    state.D.double()
    return cfg, state, [torch.from_numpy(a).double() for a in _batch()]


def _nets(state):
    return {f"{n}.{k}": v.detach().float().clone()
            for n, net in (("G", state.G), ("D", state.D))
            for k, v in net.state_dict().items()}


def _first_moments(state):
    """Both nets' Adam first moments, (1 - b1) g after a first step, by
    parameter name (``m.G.<name>``, as tests/test_torch_gan_train.py)."""
    out = {}
    for net, mod, opt in (("G", state.G, state.opt_G),
                          ("D", state.D, state.opt_D)):
        _, ms, _ = pg.adam_moments(opt)
        out.update({f"m.{net}.{k}": m.detach().double().clone()
                    for (k, _), m in zip(mod.named_parameters(), ms)})
    return out


def _result(state, logs):
    return ({k: float(v) for k, v in logs.items()}, _nets(state),
            _first_moments(state))


def _epoch_stacks():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (8, 20, 24, 3), dtype=np.uint8),
            rng.integers(0, 256, (8, 80, 96, 3), dtype=np.uint8),
            np.tile(np.int32([[20, 24]]), (8, 1)))


def _dip_inputs(n=4):
    rng = np.random.default_rng(2)
    return (rng.random((n, 1, 8, 8, 3)).astype(np.float32),
            rng.random((n, 1, 16, 16, 3)).astype(np.float32))


# ------------------------------------------------------------ the workers
def _battery4(rank, work):
    """4 ranks: the sharded forward (edge-exact and the fallback) and one
    DP step from the state tpusr made."""
    import warnings

    from tpusr_torch.engine.gan import GANTrainConfig, build_generator
    from tpusr_torch.parallel.gan_dp import make_dp_train_step
    from tpusr_torch.parallel.spatial import sharded_generator_forward

    torch.set_num_threads(1)
    out = {}
    cfg = GANTrainConfig(factor=4, residual_blocks_count=2)
    g = build_generator(cfg, "cpu")
    g.load_state_dict(torch.load(os.path.join(work, "generator.pt")))
    mesh = pm.make_mesh({"spatial": 4}, "cpu")
    with torch.inference_mode():
        out["edge_exact"] = sharded_generator_forward(
            g, torch.from_numpy(_image(96, 16, 2)), cfg, halo=HALO,
            mesh=mesh)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out["fallback"] = sharded_generator_forward(
                g, torch.from_numpy(_image(64, 16, 1)), cfg, halo=HALO)
    out["warnings"] = [str(w.message) for w in caught]

    dmesh = pm.make_mesh(devices="cpu")
    path = os.path.join(work, "tpusr_state.pt")
    dcfg = pg.GANTrainConfig(**CFG, **F32_D)
    place, step = make_dp_train_step(dmesh, dcfg, LR)
    lo, hi = (torch.from_numpy(a) for a in _batch())
    out["dp"] = _result(*step(place(_state(dcfg, path)), lo, hi))
    ecfg, state, (lo, hi) = _exact(path)
    place, step = make_dp_train_step(dmesh, ecfg, LR_EXACT)
    out["dp_exact"] = _result(*step(place(state), lo, hi))
    torch.save(out, os.path.join(work, f"r{rank}.pt"))


def _battery2(rank, work, tree, tpusr_work):
    """2 ranks: DP steps (tpusr's default bf16 D state; f32 from the state
    tpusr made), DP epochs, the global BatchNorm statistics, the sharded
    DIP, and the train CLI."""
    from tpusr_torch.cli import train_gan
    from tpusr_torch.engine.dip import DIPConfig
    from tpusr_torch.engine.gan_epochs import gan_train_epochs
    from tpusr_torch.models.layers import BatchNorm
    from tpusr_torch.parallel.dip_batch import dip_superresolve_sharded
    from tpusr_torch.parallel.gan_dp import (make_dp_forward,
                                             make_dp_train_step, stats_over)

    torch.set_num_threads(1)
    out = {}
    mesh = pm.make_mesh(devices="cpu")
    group, _, world = pm.axis_of(mesh, "data")

    cfg = pg.GANTrainConfig(**CFG)
    place, step = make_dp_train_step(mesh, cfg, LR)
    lo, hi = _batch()
    state, logs = step(place(_state(cfg)), torch.from_numpy(lo),
                       torch.from_numpy(hi))
    out["dp"] = _result(state, logs)
    path = os.path.join(tpusr_work, "tpusr_state.pt")
    dcfg = pg.GANTrainConfig(**CFG, **F32_D)
    place32, step32 = make_dp_train_step(mesh, dcfg, LR)
    out["dp_tpusr"] = _result(*step32(place32(_state(dcfg, path)),
                                      torch.from_numpy(lo),
                                      torch.from_numpy(hi)))
    ecfg, state, (lo64, hi64) = _exact(path)
    place64, step64 = make_dp_train_step(mesh, ecfg, LR_EXACT)
    out["dp_exact"] = _result(*step64(place64(state), lo64, hi64))

    lr_u8, hr_u8, valid = (torch.from_numpy(a) for a in _epoch_stacks())
    state, logs = gan_train_epochs(
        place(_state(cfg)), lr_u8, hr_u8, valid,
        torch.Generator().manual_seed(1), cfg, n_epochs=2, step_fn=step,
        forward_fn=make_dp_forward(mesh, cfg))
    out["epochs"] = ({k: v.clone() for k, v in logs.items()}, _nets(state))
    dcfg = pg.GANTrainConfig(**CFG, **F32_D, **EXACT)
    place32, step32 = make_dp_train_step(mesh, dcfg, LR_EXACT)
    state, _ = gan_train_epochs(
        place32(_state(dcfg)), lr_u8, hr_u8, valid,
        torch.Generator().manual_seed(1), dcfg, n_epochs=2, step_fn=step32,
        forward_fn=make_dp_forward(mesh, dcfg))
    out["epochs_exact"] = _first_moments(state)

    out["bn"] = _global_bn(rank, world, stats_over(group, world), BatchNorm)

    lr_dip, hr_dip = _dip_inputs()
    res, curves = dip_superresolve_sharded(
        lr_dip, hr_dip, [torch.Generator().manual_seed(i) for i in range(4)],
        DIPConfig(**TINY_DIP), mesh, device="cpu")
    out["dip"] = (res, curves)

    cli_out = os.path.join(work, "cli")
    os.makedirs(cli_out, exist_ok=True)
    out["cli_dir"] = train_gan.run(
        ["--data_dir", tree, "--out_dir", cli_out, "--batch_size", "2",
         "--data_parallel", "True", *TINY_CLI])
    try:
        train_gan.run(["--data_dir", tree, "--out_dir", cli_out,
                       "--batch_size", "3", "--data_parallel", "True",
                       *TINY_CLI])
        out["cli_indivisible"] = 0
    except SystemExit as e:
        out["cli_indivisible"] = e.code
    torch.save(out, os.path.join(work, f"r{rank}.pt"))


def _bn_inputs():
    gen = torch.Generator().manual_seed(5)
    return (torch.randn(4, 6, 5, 7, generator=gen) * 2 + 0.5,
            torch.randn(4, 6, 5, 7, generator=gen))


def _bn_run(bn, x, w, **kw):
    """A train-mode BatchNorm forward and backward of sum(out * w)."""
    x = x.clone().requires_grad_()
    y = bn(x, **kw)
    (y * w).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "rm": bn.running_mean.clone(),
            "rv": bn.running_var.clone()}


def _global_bn(rank, world, global_stats, BatchNorm):
    """Each rank's slice of the _bn_inputs batch through BatchNorm under
    the global statistics: plain, grouped (stat_groups=2, each group its
    own global batch) and from conv_stats."""
    x, w = _bn_inputs()
    per = x.shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)
    res = {}
    with global_stats:
        res["plain"] = _bn_run(BatchNorm(6), x[mine], w[mine])
        half = x.shape[0] // 2  # groups: rows [0, half) and [half, N)
        gp = half // world
        idx = torch.cat([torch.arange(rank * gp, (rank + 1) * gp),
                         half + torch.arange(rank * gp, (rank + 1) * gp)])
        res["grouped"] = _bn_run(BatchNorm(6), x[idx], w[idx],
                                 stat_groups=2)
        xs = x[mine]
        bn = BatchNorm(6)
        n = xs.numel() // 6
        st = (xs.sum((0, 2, 3)), xs.square().sum((0, 2, 3)), n,
              torch.full((6,), 0.25))
        res["conv_stats"] = bn(xs, conv_stats=st).detach(), \
            bn.running_mean.clone(), bn.running_var.clone()
    return res


def _spawn(tmp_path_factory, name, fn, nprocs, *args):
    work = str(tmp_path_factory.mktemp(name))
    pm.spawn(fn, nprocs, (work, *args), device="cpu", store_dir=work)
    return work, [torch.load(os.path.join(work, f"r{r}.pt"),
                             weights_only=False) for r in range(nprocs)]


# ------------------------------------------------------------ the parent
@pytest.fixture(scope="module")
def tpusr_side(tmp_path_factory):
    """tpusr's generator and GAN state (saved for the workers) and its
    sharded forward and DP step on the 8-device mesh."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_gan_train import _jax_flat, _strong
    from tpusr.engine import gan as jg
    from tpusr.engine import losses as JL
    from tpusr.parallel.mesh import make_mesh
    from tpusr.parallel.spatial import sharded_generator_forward
    from tpusr_torch.engine.gan import GANTrainConfig, build_generator
    from tpusr_torch.io.weights import load_flax_gan_state, load_flax_generator

    from tpusr.models.srgan import Generator as JaxGenerator

    work = str(tmp_path_factory.mktemp("tpusr"))
    v = jax.jit(lambda k: JaxGenerator(factor=4, residual_blocks_count=2)
                .init(k, jnp.zeros((1, 8, 8, 3)), False))(jax.random.key(3))
    params = jax.tree.map(np.asarray, v["params"])
    rng = np.random.default_rng(3)  # running statistics away from 0 / 1
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), v["batch_stats"])
    g = build_generator(GANTrainConfig(factor=4, residual_blocks_count=2),
                        "cpu")
    load_flax_generator(g, params, stats)
    torch.save(g.state_dict(), os.path.join(work, "generator.pt"))
    jcfg = jg.GANTrainConfig(factor=4, residual_blocks_count=2)
    sharded = np.asarray(sharded_generator_forward(
        params, stats, jnp.asarray(_image(96, 16, 2)), jcfg,
        mesh=make_mesh({"spatial": 4}), halo=HALO))

    jc = jg.GANTrainConfig(**CFG, **F32_D)
    js = _strong(jax.jit(lambda k: jg.create_gan_state(k, jc, LR))(
        jax.random.key(1)))
    ps = _state(pg.GANTrainConfig(**CFG, **F32_D))
    load_flax_gan_state(ps, jax.tree.map(np.asarray, js))
    torch.save({"G": ps.G.state_dict(), "D": ps.D.state_dict()},
               os.path.join(work, "tpusr_state.pt"))
    lo, hi = _batch()
    steps = {}
    for key, lr, kw in (("step", LR, {}), ("step_exact", LR_EXACT, EXACT)):
        c = jg.GANTrainConfig(**CFG, **F32_D, **kw)
        out, log = jax.jit(lambda s, a, b: jg._train_step_core(
            s, a, b, c, lr, JL.mse))(js, jnp.asarray(lo), jnp.asarray(hi))
        nets, moments, _ = _jax_flat(out)
        steps[key] = ({k: float(v) for k, v in log.items()}, nets,
                      {k: torch.from_numpy(np.array(v))
                       for k, v in moments.items() if k.startswith("m.")})
    return dict(work=work, generator=g, sharded=sharded, **steps)


@pytest.fixture(scope="module")
def ranks4(tpusr_side, tmp_path_factory):
    work = tpusr_side["work"]
    pm.spawn(_battery4, 4, (work,), device="cpu", store_dir=work)
    return [torch.load(os.path.join(work, f"r{r}.pt"), weights_only=False)
            for r in range(4)]


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("div2k")
    rng = np.random.default_rng(0)
    hr_dir, lr_dir = root / "DIV2K_train_HR", root / "DIV2K_train_LR_x8"
    hr_dir.mkdir()
    lr_dir.mkdir()
    for i in range(1, 5):
        hr = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
        Image.fromarray(hr).save(hr_dir / f"{i:04d}.png")
        Image.fromarray(hr).resize((32, 32), Image.BICUBIC).save(
            lr_dir / f"{i:04d}x8.png")
    return str(root)


@pytest.fixture(scope="module")
def ranks2(cli_tree, tpusr_side, tmp_path_factory):
    return _spawn(tmp_path_factory, "ranks2", _battery2, 2, cli_tree,
                  tpusr_side["work"])


def _single_step(cfg, state):
    lo, hi = _batch()
    state, logs = pg.gan_train_step(state, torch.from_numpy(lo),
                                    torch.from_numpy(hi), cfg)
    return _result(state, logs)


def _exact_single(tpusr_side):
    cfg, state, (lo, hi) = _exact(os.path.join(tpusr_side["work"],
                                               "tpusr_state.pt"))
    return _result(*pg.gan_train_step(state, lo, hi, cfg))


def _close_moments(got, want, tol, nets=("G", "D")):
    """Each net's first-moment vector within ``tol[net]`` of ``want`` in
    relative L2."""
    for net in nets:
        keys = sorted(k for k in want if k.startswith(f"m.{net}."))
        assert keys == sorted(k for k in got if k.startswith(f"m.{net}."))
        a = torch.cat([got[k].reshape(-1) for k in keys]).double()
        b = torch.cat([want[k].reshape(-1) for k in keys]).double()
        rel = float((a - b).norm() / b.norm())
        assert rel <= tol[net], (net, rel)


def _close_steps(got, want, d_tol, lim=1e-3, loss_lim=5e-4):
    """A step at LR: losses and parameters at tests/test_parallel.py's
    bounds, and D's reduced gradient (D steps first, from the state both
    runs share). G's gradient is taken after D's step, whose
    rounding-level sign flips already part it at this lr (see
    ``LR_EXACT``)."""
    for k in ("loss_D", "loss_G"):
        assert abs(got[0][k] - want[0][k]) < loss_lim, k
    assert set(got[1]) == set(want[1])
    for k, v in got[1].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]),
                                   rtol=0, atol=lim, err_msg=k)
    _close_moments(got[2], want[2], {"D": d_tol}, nets=("D",))


# ------------------------------------------------------------ the tests
def test_sharded_forward_edge_exact_matches_whole_and_tpusr(tpusr_side,
                                                            ranks4):
    g = tpusr_side["generator"]
    cfg = pg.GANTrainConfig(factor=4, residual_blocks_count=2)
    with torch.inference_mode():
        whole = pg.generator_forward(g, torch.from_numpy(_image(96, 16, 2)),
                                     cfg)
    for r in ranks4:  # every rank returns the whole image
        got = r["edge_exact"]
        assert got.shape == (1, 384, 64, 3)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), tpusr_side["sharded"],
                                   rtol=0, atol=1e-5)


def test_sharded_forward_fallback_is_interior_exact(tpusr_side, ranks4):
    """slab 16 < 2 halo: zero-filled edge halos, warned; the interior (halo
    rows from each true edge) equals the whole image."""
    cfg = pg.GANTrainConfig(factor=4, residual_blocks_count=2)
    with torch.inference_mode():
        whole = pg.generator_forward(tpusr_side["generator"],
                                     torch.from_numpy(_image(64, 16, 1)),
                                     cfg).numpy()
    f = 4
    for r in ranks4:
        assert any("interior-exact only" in w for w in r["warnings"])
        got = r["fallback"].numpy()
        assert got.shape == whole.shape
        np.testing.assert_allclose(got[:, HALO * f:-HALO * f],
                                   whole[:, HALO * f:-HALO * f], rtol=0,
                                   atol=2e-5)


def test_sharded_forward_one_shard_and_indivisible_height(tpusr_side):
    from tpusr_torch.parallel.spatial import sharded_generator_forward

    g = tpusr_side["generator"]
    cfg = pg.GANTrainConfig(factor=4, residual_blocks_count=2)
    x = torch.from_numpy(_image(32, 8, 6))
    with torch.inference_mode():
        one = sharded_generator_forward(g, x, cfg, n_shards=1, halo=HALO)
        whole = pg.generator_forward(g, x, cfg)
    torch.testing.assert_close(one, whole, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        sharded_generator_forward(g, x, cfg, n_shards=3)


def test_dp_step_w4_matches_single_and_tpusr(tpusr_side, ranks4):
    cfg = pg.GANTrainConfig(**CFG, **F32_D)
    single = _single_step(cfg, _state(cfg, os.path.join(
        tpusr_side["work"], "tpusr_state.pt")))
    exact = _exact_single(tpusr_side)
    for r in ranks4:
        _close_steps(r["dp"], single, F32_MOMENT_TOL)
        _close_steps(r["dp"], tpusr_side["step"], TPUSR_MOMENT_TOL["D"])
        _close_moments(r["dp_exact"][2], exact[2], F64_GRAD_TOL)
        _close_moments(r["dp_exact"][2], tpusr_side["step_exact"][2],
                       TPUSR_MOMENT_TOL)
        for k, v in r["dp"][1].items():  # the ranks stay replicated
            torch.testing.assert_close(v, ranks4[0]["dp"][1][k], rtol=0,
                                       atol=0, msg=k)


def test_dp_step_w2_matches_single_and_tpusr(tpusr_side, ranks2):
    cfg = pg.GANTrainConfig(**CFG)
    single = _single_step(cfg, _state(cfg))
    exact = _exact_single(tpusr_side)
    for r in ranks2[1]:
        _close_steps(r["dp"], single, BF16_MOMENT_TOL)
        _close_steps(r["dp_tpusr"], tpusr_side["step"],
                     TPUSR_MOMENT_TOL["D"])
        _close_moments(r["dp_exact"][2], exact[2], F64_GRAD_TOL)
        _close_moments(r["dp_exact"][2], tpusr_side["step_exact"][2],
                       TPUSR_MOMENT_TOL)


def test_dp_epochs_match_single_process(ranks2):
    cfg = pg.GANTrainConfig(**CFG)
    from tpusr_torch.engine.gan_epochs import gan_train_epochs

    lr_u8, hr_u8, valid = (torch.from_numpy(a) for a in _epoch_stacks())
    state, logs = gan_train_epochs(_state(cfg), lr_u8, hr_u8, valid,
                                   torch.Generator().manual_seed(1), cfg,
                                   n_epochs=2)
    want = _nets(state)
    cfg0 = pg.GANTrainConfig(**CFG, **F32_D, **EXACT)
    exact, _ = gan_train_epochs(_state(cfg0, lr=LR_EXACT), lr_u8, hr_u8,
                                valid, torch.Generator().manual_seed(1),
                                cfg0, n_epochs=2)
    for r in ranks2[1]:
        _close_moments(r["epochs_exact"], _first_moments(exact),
                       F32_GRAD_TOL)
        got_logs, got = r["epochs"]
        for k in ("losses_G", "losses_D", "psnr", "ssim"):
            np.testing.assert_allclose(got_logs[k].numpy(),
                                       logs[k].numpy(), rtol=0, atol=2e-3,
                                       err_msg=k)
        for k, v in got.items():
            if k.startswith("G."):
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           rtol=0, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("case", ["plain", "grouped", "conv_stats"])
def test_global_batch_norm_statistics(ranks2, case):
    """Running mean and (unbiased) variance, output and input gradient of
    each rank's slice equal one BatchNorm over the whole batch."""
    from tpusr_torch.models.layers import BatchNorm

    x, w = _bn_inputs()
    world = 2
    per = x.shape[0] // world
    if case == "conv_stats":
        bn = BatchNorm(6)
        n = x.numel() // 6
        y = bn(x, conv_stats=(x.sum((0, 2, 3)), x.square().sum((0, 2, 3)),
                              n, torch.full((6,), 0.25)))
        for rank, r in enumerate(ranks2[1]):
            got_y, rm, rv = r["bn"]["conv_stats"]
            torch.testing.assert_close(got_y, y[rank * per:(rank + 1) * per]
                                       .detach(), rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(rm, bn.running_mean, rtol=1e-5,
                                       atol=1e-6)
            torch.testing.assert_close(rv, bn.running_var, rtol=1e-5,
                                       atol=1e-6)
        return
    kw = {"stat_groups": 2} if case == "grouped" else {}
    want = _bn_run(BatchNorm(6), x, w, **kw)
    half, gp = x.shape[0] // 2, x.shape[0] // 2 // world
    for rank, r in enumerate(ranks2[1]):
        got = r["bn"][case]
        if case == "grouped":
            rows = torch.cat([torch.arange(rank * gp, (rank + 1) * gp),
                              half + torch.arange(rank * gp,
                                                  (rank + 1) * gp)])
        else:
            rows = torch.arange(rank * per, (rank + 1) * per)
        for k in ("y", "dx"):
            torch.testing.assert_close(got[k], want[k][rows], rtol=1e-5,
                                       atol=1e-6, msg=k)
        for k in ("rm", "rv"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, msg=k)


def test_sharded_dip_matches_the_lane_batch(ranks2):
    from tpusr_torch.engine.dip import DIPConfig, dip_superresolve_batch

    lr_dip, hr_dip = _dip_inputs()
    ref, curves = dip_superresolve_batch(
        lr_dip, hr_dip, [torch.Generator().manual_seed(i) for i in range(4)],
        DIPConfig(**TINY_DIP), device="cpu")
    for r in ranks2[1]:
        res, got = r["dip"]
        assert res.shape == (4, 1, 16, 16, 3)
        diff = (res - ref).abs().numpy()
        assert np.median(diff) < 1e-5
        assert (diff > 1e-3).mean() < 0.25
        np.testing.assert_allclose(got["psnr"], curves["psnr"], rtol=0,
                                   atol=1e-3)
        assert got["loss"].shape == curves["loss"].shape == (4, 2)


def test_sharded_dip_needs_lanes_divisible_by_the_ranks():
    from tpusr_torch.engine.dip import DIPConfig
    from tpusr_torch.parallel.dip_batch import dip_superresolve_sharded

    class _Mesh:  # a 'data' axis of 2 ranks, as axis_of reads it
        mesh_dim_names = ("data",)

        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

        def size(self, dim=None):
            return 2

    lr_dip, hr_dip = _dip_inputs(3)
    with pytest.raises(ValueError, match="3 images do not divide over 2"):
        dip_superresolve_sharded(
            lr_dip, hr_dip, [torch.Generator() for _ in range(3)],
            DIPConfig(**TINY_DIP), _Mesh(), device="cpu")


def test_train_cli_data_parallel_writes_tpusr_file_set(ranks2):
    work, results = ranks2
    out_dir = results[0]["cli_dir"]
    assert out_dir.startswith(os.path.join(work, "cli", "trained", "GANx8"))
    files = set(os.listdir(out_dir))
    for prefix in ("pre_trained", "fine_tuned"):
        assert {f"{prefix}_state", f"{prefix}_srgan_G.pth",
                f"{prefix}_srgan_D.pth"} <= files
    assert len([f for f in files if f.endswith("_log.txt")]) == 2
    # rank 0 alone wrote: one run directory
    assert os.listdir(os.path.join(work, "cli", "trained", "GANx8")) == [
        os.path.basename(out_dir)]
    assert [r["cli_indivisible"] for r in results] == [1, 1]
