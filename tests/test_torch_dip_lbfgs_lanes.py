"""L-BFGS lanes of tpusr_torch's DIP lane batch on the CPU.

tpusr's ``dip_superresolve_batch`` is ``jax.vmap`` over ``_dip_core``, its
L-BFGS branch included: under vmap, the zoom line search's ``while_loop``
runs until every lane has finished and holds each finished lane's carry,
so lane i takes exactly its single run's trial points. The port runs one
host-side line search per lane and one batched value-and-gradient call per
round (``engine/lbfgs.py::ZoomLBFGSLanes``).

* (a) ``ZoomLBFGSLanes`` on N = 3 seeded 6-D Rosenbrock starts and on
  N = 3 convex quadratics, in f64: iterates within 1e-9 of ``jax.vmap``
  of the optax run and of three single ``ZoomLBFGS`` runs; each lane's
  line-search step counts equal optax's for that lane, and the lanes take
  different counts in some iteration; one batched call per round.
* (b) ``lbfgs_fixed_step_lanes`` against N single ``lbfgs_fixed_step``
  calls on the same gradients, in f64: equal bit for bit, with a lane whose
  memory refuses a pair the others admit.
* (c) ``dip_superresolve_batch`` (and the bucketed form, two valid sizes)
  with 'fixed' and 'zoom': each lane against its single ``conv_fusion=
  'off'`` run, by ``_close_runs`` (tests/test_torch_dip_batch.py: images by
  tpusr's batched-run criteria, PSNR / SSIM within 1e-4, losses within
  1e-5 relative, the same evaluations per chunk) and the loss curve within
  1e-6 absolute, inside tpusr's own spread between its batch and its
  single runs (1.4e-6 'fixed', 4.9e-6 'zoom', 2 lanes at 32^2), on that
  file's inputs. What f32 allows, measured on a CPU:
  - the Adam warm-up is cut from 100 steps to 4 (``WARMUP_ITERS``, for the
    batch and the single runs alike): the Adam lane batch itself parts
    from its single runs after ~50 steps (vmap's grouped convs round
    differently, and Adam's g / (|g| + eps) turns the rounding of
    near-zero gradients into lr-sized steps; 1.8e-3 dB after 100), which
    no L-BFGS code can undo. The card runs the full 100 (chip_smoke.py
    phase 10e);
  - the step is 0.5 (the L-BFGS runs of tests/test_torch_dip_variants.py
    use it): at 0.01 the fixed steps are so short that y = g' - g is
    mostly the gradients' rounding, and lanes part on it (median up to
    6.2e-2 over four inputs; at 0.5, below 1e-6 on all four);
  - on three other inputs a zoom lane's second direction, through the
    1/(y.s) of a nearly flat pair, amplifies the same rounding: images
    part (median up to 6.6e-3) while the loss curves stay within 2.8e-6
    and the trial counts equal; a batch of one lane equals its single run
    (median 4.5e-7). The optimizer-level tests (a) hold the exact
    semantics in f64.
* (d) One batched L-BFGS iteration from two lanes' tpusr weights against
  ``jax.vmap`` of tpusr's step on its own loss (``optax.lbfgs`` with
  ``value_and_grad_from_state``, and ``lbfgs_fixed_step_tx``): losses to
  1e-5 relative, new parameters to 1e-5 (tests/test_torch_dip_batch.py's
  one-iteration bounds), each lane's update to 5e-4 in relative L2 (the
  gradients' bound), and the same step counts per lane.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tests.test_torch_dip_batch import (HW, LANES, SMALL, TINY, _close_runs,
                                        _gens, _inputs)
from tpusr_torch.engine import dip
from tpusr_torch.engine.lbfgs import (ZoomLBFGS, ZoomLBFGSLanes,
                                      lbfgs_fixed_init,
                                      lbfgs_fixed_init_lanes,
                                      lbfgs_fixed_step,
                                      lbfgs_fixed_step_lanes)

N = 3
LBFGS = dataclasses.replace(TINY, optimizer="lbfgs", learning_rate=0.5,
                            num_iter=6, log_freq=3)
LOSS_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------- (a) optimizer level
def _rosenbrock(x, lib):
    return lib.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                   + (1 - x[..., :-1]) ** 2, -1)


def _quadratics():
    rng = np.random.default_rng(4)
    mats, vecs = [], []
    for cond in (5.0, 20.0, 60.0):
        q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
        mats.append((q * np.logspace(0, np.log10(cond), 12)) @ q.T)
        vecs.append(rng.standard_normal(12))
    return np.stack(mats), np.stack(vecs), rng.standard_normal((N, 12))


PROBLEMS = {
    "rosenbrock": dict(memory=5, iters=30,
                       x0=np.random.default_rng(1).uniform(-1.5, 1.5,
                                                           (N, 6))),
    "quadratic": dict(memory=10, iters=10)}


def _optax_lanes(f, x0s, data, memory, iters):
    """jax.vmap over the lanes of ``iters`` optax.lbfgs iterations: the
    iterates (N, iters, n) and line-search step counts (N, iters)."""
    import jax
    import optax

    tx = optax.lbfgs(memory_size=memory)

    def run(x0, d):
        fd = functools.partial(f, d=d)
        vg = optax.value_and_grad_from_state(fd)

        def body(carry, _):
            x, st = carry
            v, g = vg(x, state=st)
            u, st = tx.update(g, st, x, value=v, grad=g, value_fn=fd)
            x = optax.apply_updates(x, u)
            return (x, st), (x, st[2].info.num_linesearch_steps)

        return jax.lax.scan(body, (x0, tx.init(x0)), None, length=iters)[1]

    traj, steps = jax.jit(jax.vmap(run))(x0s, data)
    return np.asarray(traj), np.asarray(steps)


@pytest.fixture(scope="module")
def optax_lanes():
    """optax's side of (a), computed once."""
    import jax
    import jax.numpy as jnp

    out = {}
    with jax.enable_x64(True):
        p = PROBLEMS["rosenbrock"]
        out["rosenbrock"] = _optax_lanes(
            lambda x, d: _rosenbrock(x, jnp) + 0 * d, jnp.asarray(p["x0"]),
            jnp.zeros(N), p["memory"], p["iters"])
        a, b, x0 = _quadratics()
        out["quadratic"] = _optax_lanes(
            lambda x, d: 0.5 * x @ (d[0] @ x) - d[1] @ x, jnp.asarray(x0),
            (jnp.asarray(a), jnp.asarray(b)), PROBLEMS["quadratic"]["memory"],
            PROBLEMS["quadratic"]["iters"])
    return out


def _objective(problem):
    """(x0s (N, n), the lanes' batched f(xs, lanes), lane i's f(x))."""
    if problem == "rosenbrock":
        x0 = PROBLEMS["rosenbrock"]["x0"]
        return (x0, lambda xs, lanes: _rosenbrock(xs, torch),
                lambda i: functools.partial(_rosenbrock, lib=torch))
    a, b, x0 = (torch.from_numpy(v) for v in _quadratics())

    def batched(xs, lanes):
        return (0.5 * torch.einsum("ki,kij,kj->k", xs, a[lanes], xs)
                - (b[lanes] * xs).sum(-1))

    return (x0.numpy(), batched,
            lambda i: lambda x: 0.5 * x @ (a[i] @ x) - b[i] @ x)


def _with_grad(f):
    def value_and_grad(x, *args):
        x = x.detach().requires_grad_()
        v = f(x, *args)
        (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g
    return value_and_grad


@pytest.mark.parametrize("problem", ["rosenbrock", "quadratic"])
def test_zoom_lanes_match_vmap_of_optax_and_single_runs(problem,
                                                        optax_lanes):
    x0, batched, single = _objective(problem)
    memory, iters = PROBLEMS[problem]["memory"], PROBLEMS[problem]["iters"]
    want, want_steps = optax_lanes[problem]
    opt = ZoomLBFGSLanes(N, x0.shape[1], memory, dtype=torch.float64)
    x, got = torch.from_numpy(x0), []
    for _ in range(iters):
        x, _ = opt.step(x, _with_grad(batched))
        got.append(x.numpy())
    got = np.stack(got, 1)
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    assert opt.linesearch_steps == want_steps.tolist()
    for i in range(N):
        one = ZoomLBFGS(x0.shape[1], memory, dtype=torch.float64)
        xi = torch.from_numpy(x0[i])
        for k in range(iters):
            xi, _ = one.step(xi, _with_grad(single(i)))
            np.testing.assert_allclose(got[i, k], xi.numpy(), atol=1e-9,
                                       rtol=0)
        assert one.linesearch_steps == opt.linesearch_steps[i]
        assert opt.evals[i] == one.evals == 1 + sum(want_steps[i])
    # the lanes part ways in some iteration, and each round is one call
    assert (want_steps != want_steps[:1]).any()
    assert opt.calls == 1 + want_steps.max(0).sum()


# ---------------------------------------------------- (b) the fixed step
def test_fixed_step_lanes_equal_single_steps_bit_for_bit():
    """Three least-squares lanes, each gradient taken along its own single
    trajectory; lane 2 is handed its previous gradient again at step 2
    (y = 0: its memory refuses the pair the other lanes admit). Memory 3,
    8 steps, so slots roll."""
    rng = np.random.default_rng(0)
    probs = [(torch.from_numpy(rng.standard_normal((10, 6))),
              torch.from_numpy(rng.standard_normal(10))) for _ in range(N)]
    xs = [torch.from_numpy(rng.standard_normal(6)) for _ in range(N)]
    singles = [lbfgs_fixed_init(6, 3, dtype=torch.float64) for _ in range(N)]
    lanes = lbfgs_fixed_init_lanes(N, 6, 3, dtype=torch.float64)
    prev = None
    for k in range(8):
        grads = [2 * a.T @ (a @ x - b) for (a, b), x in zip(probs, xs)]
        if k == 2:
            grads[2] = prev[2]
        upd, lanes = lbfgs_fixed_step_lanes(torch.stack(grads), lanes, 0.3)
        for i in range(N):
            want, singles[i] = lbfgs_fixed_step(grads[i], singles[i], 0.3)
            assert torch.equal(upd[i], want), (k, i)
            xs[i] = xs[i] + want
        if k == 2:  # pairs admitted so far: steps 1 and 2 (lane 2: 1)
            assert (lanes["rho"] != 0).sum(1).tolist() == [2, 2, 1]
        prev = grads
    for key in ("s_mem", "y_mem", "rho", "h_diag", "prev_d"):
        for i in range(N):
            assert torch.equal(lanes[key][i], singles[i][key][0]), key


# ------------------------------------ the lanes' flat objective itself
@pytest.mark.parametrize("parts,masked", [("net", False),
                                          ("net,input,down", False),
                                          ("net", True)],
                         ids=["net", "net-input-down", "masked"])
def test_lane_objective_is_each_lanes_flat_objective(parts, masked):
    """At one point, each row of the lanes' flat vector is the lane's
    single-run flat vector (exactly, trained z and kernel included), and
    its value and gradient are the single run's (flat_objective) to the
    gradients' bound; a call over a subset of lanes gives those lanes'
    rows."""
    rng = np.random.default_rng(3)
    cfg = dataclasses.replace(TINY, opt_over=parts)
    nets, singles = [], []
    for i in range(N):
        net, down = dip.build(cfg, torch.Generator().manual_seed(i))
        nets.append(net)
    z = torch.from_numpy(rng.random((N, 1, 4, 16, 16)).astype(np.float32))
    lrs = torch.from_numpy(rng.random((N, 1, 3, 8, 8)).astype(np.float32))
    mask = None
    if masked:
        mask = torch.from_numpy(np.stack([
            np.asarray(dip._valid_mask((8, 8), (h // 2, w // 2), "cpu"))
            for h, w in ((12, 14), (16, 10), (10, 16))]))[:, None, None,
                                                           :, :, 0]
    params = dip.stack_lanes(nets, "cpu")
    zl, kernel = z, None
    if "input" in parts:
        zl = z.clone().requires_grad_()
    if "down" in parts:
        kernel = (down.kernel[None].repeat(N, 1, 1)
                  * torch.linspace(0.9, 1.1, N)[:, None, None])
        kernel.requires_grad_()
    x, vg = dip.lane_objective(nets[0], down, params, zl, lrs, kernel, mask)
    values, grads = vg(x, list(range(N)))
    for i, net in enumerate(nets):
        leaves = list(net.parameters())
        zi, ki = z[i], None
        if "input" in parts:
            zi = z[i].clone().requires_grad_()
            leaves.append(zi)
        if "down" in parts:
            ki = kernel[i].detach().clone().requires_grad_()
            leaves.append(ki)
        xi, vgi = dip.flat_objective(net, down, leaves, zi, lrs[i], ki,
                                     None if mask is None else mask[i])
        assert torch.equal(x[i], xi)
        vi, gi = vgi(xi)
        np.testing.assert_allclose(float(values[i]), float(vi), rtol=1e-6)
        np.testing.assert_allclose(grads[i].numpy(), gi.numpy(), rtol=5e-4,
                                   atol=3e-6)
    v1, g1 = vg(x[[2, 0]], [2, 0])
    np.testing.assert_allclose(v1.numpy(), values[[2, 0]].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(g1.numpy(), grads[[2, 0]].numpy(), rtol=5e-4,
                               atol=3e-6)


# ------------------------------------------------- (c) whole DIP lanes
@pytest.fixture
def short_warmup(monkeypatch):
    monkeypatch.setattr(dip, "WARMUP_ITERS", 4)


def _close_lbfgs_runs(batch, singles):
    _close_runs(batch, singles)
    for i, (_, c1) in enumerate(singles):
        np.testing.assert_allclose(batch[1]["loss"][i], c1["loss"], rtol=0,
                                   atol=LOSS_ATOL)


@pytest.mark.parametrize("search", ["fixed", "zoom"])
def test_lbfgs_lanes_equal_single_runs(search, short_warmup):
    cfg = dataclasses.replace(LBFGS, lbfgs_line_search=search)
    lr, hr = _inputs()
    batch = dip.dip_superresolve_batch(lr, hr, _gens(), cfg, device="cpu")
    assert batch[0].shape == (LANES, 1, 16, 16, 3)
    singles = [dip.dip_superresolve(lr[i], hr[i], cfg, g, device="cpu")
               for i, g in enumerate(_gens())]
    _close_lbfgs_runs(batch, singles)
    if search == "zoom":  # the first iteration evaluates, then its trials
        assert (batch[1]["evals"][:, 0] > 3).all()


@pytest.mark.parametrize("search", ["fixed", "zoom"])
def test_bucketed_lbfgs_lanes_equal_single_runs(search, short_warmup):
    cfg = dataclasses.replace(LBFGS, lbfgs_line_search=search)
    lr, hr = _inputs()
    valid = np.array([[12, 14], [16, 10]])
    batch = dip.dip_superresolve_batch_bucketed(lr, hr, valid, _gens(), cfg,
                                                device="cpu")
    singles = [dip.dip_superresolve_bucketed(lr[i], hr[i], valid[i], cfg, g,
                                             device="cpu")
               for i, g in enumerate(_gens())]
    _close_lbfgs_runs(batch, singles)


# ------------------------------------- (d) one iteration against tpusr
@pytest.fixture(scope="module")
def tpusr_lbfgs_step():
    """jax.vmap of one tpusr L-BFGS iteration of each search from two
    lanes' fresh weights, on tpusr's deterministic objective."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpusr.engine.dip import DIPConfig as JaxDIPConfig
    from tpusr.engine.dip import _build as jax_build
    from tpusr.engine.dip import lbfgs_fixed_step_tx

    rng = np.random.default_rng(0)
    z = (rng.random((LANES, 1, HW, HW, 4)) * 0.1).astype(np.float32)
    lr_img = rng.random((LANES, 1, HW // 4, HW // 4, 3)).astype(np.float32)
    net, downsampler = jax_build(JaxDIPConfig(conv_fusion="off", **SMALL))
    keys = jax.random.split(jax.random.PRNGKey(0), LANES)
    variables = jax.jit(jax.vmap(lambda k: net.init(k, jnp.asarray(z[0]))))(
        keys)
    lr_step, memory = SMALL["learning_rate"], 10

    def step(search, params, stats, z_lane, target):
        def f(p):
            out, _ = net.apply({"params": p, "batch_stats": stats}, z_lane,
                               True, mutable=["batch_stats"])
            return jnp.mean((downsampler(out) - target) ** 2)

        if search == "fixed":
            tx = lbfgs_fixed_step_tx(lr_step, memory)
            v, g = jax.value_and_grad(f)(params)
            u, _ = tx.update(g, tx.init(params), params)
            return v, optax.apply_updates(params, u), jnp.int32(1)
        tx = optax.lbfgs(memory_size=memory)
        st = tx.init(params)
        v, g = optax.value_and_grad_from_state(f)(params, state=st)
        u, st = tx.update(g, st, params, value=v, grad=g, value_fn=f)
        return (v, optax.apply_updates(params, u),
                st[2].info.num_linesearch_steps)

    out = {s: jax.jit(jax.vmap(functools.partial(step, s)))(
        variables["params"], variables["batch_stats"], jnp.asarray(z),
        jnp.asarray(lr_img)) for s in ("fixed", "zoom")}
    return z, lr_img, variables, out


@pytest.mark.parametrize("search", ["fixed", "zoom"])
def test_one_lbfgs_lane_iteration_matches_jax_vmap(search, tpusr_lbfgs_step):
    import jax

    from tpusr_torch.io.weights import load_flax_skipnet

    z, lr_img, variables, out = tpusr_lbfgs_step
    loss_j, new_j, steps_j = out[search]
    config = dip.DIPConfig(conv_fusion="off", **SMALL)
    nets = []
    for i in range(LANES):
        lane, down = dip.build(config)
        load_flax_skipnet(lane, jax.tree.map(lambda a: np.asarray(a[i]),
                                             variables["params"]),
                          jax.tree.map(lambda a: np.asarray(a[i]),
                                       variables["batch_stats"]))
        nets.append(lane)
    params = dip.stack_lanes(nets, "cpu")
    before = {k: v.detach().clone() for k, v in params.items()}

    def nchw(a):
        return torch.from_numpy(a).permute(0, 1, 4, 2, 3)

    x, value_and_grad = dip.lane_objective(nets[0], down, params, nchw(z),
                                           nchw(lr_img))
    if search == "fixed":
        losses, g = value_and_grad(x, list(range(LANES)))
        state = lbfgs_fixed_init_lanes(LANES, x.shape[1], 10)
        upd, _ = lbfgs_fixed_step_lanes(g, state, config.learning_rate)
        x1, steps = x + upd, [1] * LANES
    else:
        opt = ZoomLBFGSLanes(LANES, x.shape[1], 10)
        x1, losses = opt.step(x, value_and_grad)
        losses = torch.tensor(losses)
        steps = [s[0] for s in opt.linesearch_steps]
        assert opt.calls == 1 + max(steps)
    assert steps == np.asarray(steps_j).tolist()
    np.testing.assert_allclose(losses.numpy(), np.asarray(loss_j), rtol=1e-5)
    dip._assign(list(params.values()), x1)
    moved = [0.0] * LANES
    apart = [0.0] * LANES
    for mod, leaves in new_j.items():
        for leaf, pj in leaves.items():
            name = f"{mod}.{'weight' if leaf in ('kernel', 'scale') else leaf}"
            p1 = params[name].detach().numpy()
            p0 = before[name].numpy()
            pj = np.asarray(pj)
            if leaf == "kernel":  # OIHW -> HWIO, the lane axis first
                p1, p0 = (a.transpose(0, 3, 4, 2, 1) for a in (p1, p0))
            p0j = np.asarray(variables["params"][mod][leaf])
            np.testing.assert_allclose(p1, pj, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            for i in range(LANES):
                dj = (pj[i] - p0j[i]).astype(np.float64)
                d1 = (p1[i] - p0[i]).astype(np.float64)
                moved[i] += float(np.sum(dj ** 2))
                apart[i] += float(np.sum((d1 - dj) ** 2))
    for i in range(LANES):
        assert moved[i] > 0
        assert np.sqrt(apart[i] / moved[i]) < 5e-4, (i, apart, moved)
