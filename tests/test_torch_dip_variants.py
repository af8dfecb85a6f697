"""tpusr_torch's DIP variants against tpusr's, on the CPU.

L-BFGS ('fixed' against tpusr's lbfgs_fixed_step_tx and torch's LBFGS;
'zoom' against optax.lbfgs), meshgrid input, opt_over net/input/down
(Downsampler.conv2d_with), shape buckets (masked loss, pad_to_bucket, the
grouped run) and the LPIPS curve. One iteration from identical weights,
input, noise and LR image goes through the port and through a JAX
reconstruction of tpusr's _dip_core pieces (tpusr/engine/dip.py:201-436),
as tests/test_torch_dip.py does for the Adam path.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests.test_torch_dip import (HW, SMALL, _flat, _pair, _to_jax_layout,
                                  _torch_key)
from tests.test_torch_lpips import npz  # noqa: F401  (fixture)
from tpusr.engine import dip as jdip
from tpusr.engine.metrics import _valid_mask as jax_valid_mask
from tpusr.ops.resample import Downsampler as JaxDownsampler
from tpusr_torch.engine import dip
from tpusr_torch.engine.lbfgs import (ZoomLBFGS, lbfgs_fixed_init,
                                      lbfgs_fixed_step)
from tpusr_torch.io.weights import load_flax_skipnet
from tpusr_torch.models.lpips import load_lpips_npz, lpips_distance
from tpusr_torch.ops.resample import Downsampler


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# ------------------------------------------------------------- conv2d_with
@pytest.mark.parametrize("factor,preserve", [(4, True), (8, True),
                                             (4, False)])
def test_conv2d_with_matches_tpusr_and_forward(factor, preserve):
    rng = np.random.default_rng(factor)
    x = rng.random((2, 40, 48, 3)).astype(np.float32)
    ours = Downsampler(3, factor, "lanczos2", phase=0.5,
                       preserve_size=preserve)
    theirs = JaxDownsampler(3, factor, "lanczos2", phase=0.5,
                            preserve_size=preserve)
    np.testing.assert_array_equal(ours.kernel.numpy(),
                                  np.float32(theirs.kernel))
    k = ours.kernel.shape[0]
    rand = rng.random((k, k))  # not rank 1, normalized as a resampler's
    rand = (rand / rand.sum()).astype(np.float32)
    got = ours.conv2d_with(_nchw(x), torch.from_numpy(rand))
    want = theirs.conv2d_with(jnp.asarray(x), jnp.asarray(rand))
    # f32 sums of k * k terms in two orders: within 1e-6 (abs + rel)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-6, rtol=1e-6)
    taps = ours.taps
    sep = ours(_nchw(x))
    full = ours.conv2d_with(_nchw(x), torch.outer(taps, taps))
    np.testing.assert_allclose(full.numpy(), sep.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_pad_to_bucket_matches_tpusr():
    rng = np.random.default_rng(0)
    for shape, bucket in (((1, 59, 62, 3), 8), ((472, 496, 3), 64),
                          ((64, 64, 3), 16)):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        got, hw = dip.pad_to_bucket(a, bucket)
        want, hw_j = jdip.pad_to_bucket(a, bucket)
        assert hw == hw_j
        np.testing.assert_array_equal(got, want)


def test_meshgrid_input_equals_tpusr_construction():
    for h, w in ((32, 32), (37, 64), (496, 472), (1, 5)):
        xg = jnp.linspace(0.0, 1.0, w)[None, None, :, None]
        yg = jnp.linspace(0.0, 1.0, h)[None, :, None, None]
        want = jnp.concatenate([jnp.broadcast_to(xg, (1, h, w, 1)),
                                jnp.broadcast_to(yg, (1, h, w, 1))], -1)
        np.testing.assert_array_equal(dip.meshgrid_input(h, w).numpy(),
                                      np.asarray(want))


# ---------------------------------------------------------- fixed L-BFGS
def _quadratic(seed=0, n=12, m=8):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x0 = rng.standard_normal(m).astype(np.float32)
    return A, b, x0


def test_lbfgs_fixed_step_matches_tpusr_on_the_same_gradients():
    """Eight gradients of a least-squares objective (along tpusr's own
    trajectory) through both steppers; memory size 3 so slots roll."""
    A, b, x0 = _quadratic()
    grad = jax.grad(lambda x: jnp.sum((A @ x - b) ** 2))
    tx = jdip.lbfgs_fixed_step_tx(0.3, 3)
    x, st = jnp.asarray(x0), tx.init(jnp.asarray(x0))
    state = lbfgs_fixed_init(x0.size, 3)
    for _ in range(8):
        g = grad(x)
        want, st = tx.update(g, st, x)
        got, state = lbfgs_fixed_step(torch.tensor(np.asarray(g)), state,
                                      0.3)
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-5, err
        x = optax.apply_updates(x, want)
    assert state["count"] == 8


def test_lbfgs_fixed_step_matches_torch_lbfgs():
    """torch.optim.LBFGS(lr, line_search_fn=None) with the tolerance exits
    off, as the reference runs it (tests/test_dip_variants.py:29)."""
    A, b, x0 = _quadratic()
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    lr, mem, iters = 0.7, 10, 15
    xt = torch.tensor(x0, requires_grad=True)
    opt = torch.optim.LBFGS([xt], lr=lr, max_iter=iters, history_size=mem,
                            line_search_fn=None, tolerance_grad=-1,
                            tolerance_change=-1)
    traj = []

    def closure():
        opt.zero_grad()
        loss = torch.sum((At @ xt - bt) ** 2)
        loss.backward()
        traj.append(xt.detach().clone())
        return loss

    opt.step(closure)
    x, state = torch.from_numpy(x0), lbfgs_fixed_init(x0.size, mem)
    for i in range(iters):
        xg = x.clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((At @ xg - bt) ** 2), xg)
        upd, state = lbfgs_fixed_step(g, state, lr)
        x = x + upd
        want = traj[i + 1] if i + 1 < len(traj) else xt.detach()
        np.testing.assert_allclose(x.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)


# ----------------------------------------------------------- zoom L-BFGS
def _optax_run(f, x0, memory, iters):
    tx = optax.lbfgs(memory_size=memory)
    vg = optax.value_and_grad_from_state(f)

    @jax.jit
    def step(x, st):
        v, g = vg(x, state=st)
        u, st = tx.update(g, st, x, value=v, grad=g, value_fn=f)
        return optax.apply_updates(x, u), st

    x, st = jnp.asarray(x0), tx.init(jnp.asarray(x0))
    traj, steps = [], []
    for _ in range(iters):
        x, st = step(x, st)
        traj.append(np.asarray(x))
        steps.append(int(st[2].info.num_linesearch_steps))
    return traj, steps


def _zoom_run(f, x0, memory, iters):
    def value_and_grad(x):
        x = x.detach().requires_grad_()
        v = f(x)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    opt = ZoomLBFGS(x0.size, memory, dtype=torch.float64)
    x, traj = torch.from_numpy(x0), []
    for _ in range(iters):
        x, _ = opt.step(x, value_and_grad)
        traj.append(x.numpy())
    return traj, opt


def _quadratic_f64(n=50, cond=100.0):
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = (q * np.logspace(0, np.log10(cond), n)) @ q.T
    return a, rng.standard_normal(n), rng.standard_normal(n)


def _rosenbrock(x, lib):
    return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock"])
def test_zoom_lbfgs_matches_optax(problem):
    """f64: a convex quadratic (n 50, condition number 100, 10 iterations,
    iterates within 1e-6) and the non-convex 6-D Rosenbrock from a seeded
    start (30 iterations, memory 5: the zoom phase with its cubic and
    quadratic steps runs; iterates within 1e-9). Both take the same number
    of line-search steps as optax in every iteration."""
    if problem == "quadratic":
        a, b, x0 = _quadratic_f64()
        fj = lambda x: 0.5 * x @ (jnp.asarray(a) @ x) - jnp.asarray(b) @ x
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        ft = lambda x: 0.5 * x @ (at @ x) - bt @ x
        memory, iters, tol = 10, 10, 1e-6
    else:
        x0 = np.random.default_rng(1).uniform(-1.5, 1.5, 6)
        fj = functools.partial(_rosenbrock, lib=jnp)
        ft = functools.partial(_rosenbrock, lib=torch)
        memory, iters, tol = 5, 30, 1e-9
    with jax.enable_x64(True):
        want, steps = _optax_run(fj, x0, memory, iters)
    got, opt = _zoom_run(ft, x0, memory, iters)
    assert opt.linesearch_steps == steps
    assert opt.evals == 1 + sum(steps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    if problem == "rosenbrock":
        assert max(steps) > 1  # the zoom phase ran


# ------------------------------------- one iteration against a JAX rebuild
def _variables_of(net):
    """The port net's weights as flax SkipNet variables (the inverse of
    load_flax_skipnet), so the JAX side needs no init of its own."""
    names = {"running_mean": ("batch_stats", "mean"),
             "running_var": ("batch_stats", "var"), "bias": ("params", "bias")}
    variables = {"params": {}, "batch_stats": {}}
    for key, v in net.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        a = v.numpy()
        if leaf == "weight":
            coll, name = ("params", "kernel") if a.ndim == 4 else (
                "params", "scale")
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
        else:
            coll, name = names[leaf]
        variables[coll].setdefault(mod, {})[name] = jnp.asarray(a)
    return variables


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    z = (rng.random((1, HW, HW, 8)) * 0.1).astype(np.float32)
    noise = rng.standard_normal((1, HW, HW, 8)).astype(np.float32)
    lr_img = rng.random((1, HW // 4, HW // 4, 3)).astype(np.float32)
    net, down = jdip._build(jdip.DIPConfig(conv_fusion="off", **SMALL))
    variables = _variables_of(dip.build(
        dip.DIPConfig(**SMALL), torch.Generator().manual_seed(0))[0])
    return z, noise, lr_img, net, down, variables


VALID = (24, 28)  # an HR extent inside the 32^2 bucket canvas


@functools.lru_cache(maxsize=None)
def _jax_iteration(variant):
    """tpusr's loss_fn for one variant, its gradients and its stats."""
    z, noise, lr_img, net, down, variables = _inputs()
    std = SMALL["reg_noise_std"]
    t = {"net": variables["params"]}
    if variant == "opt_over":
        t.update(z=jnp.asarray(z), down=jnp.asarray(down.kernel, jnp.float32))
    lr_mask = None
    if variant == "masked":
        lr_mask = jax_valid_mask(lr_img.shape[1:3],
                                 jnp.asarray(VALID) // SMALL["factor"])
        lr_count = jnp.maximum(jnp.sum(lr_mask), 1.0) * 3

    def loss_fn(t):
        if variant == "lbfgs_fixed":  # deterministic: no reg noise
            z_iter = jnp.asarray(z)
        else:
            z_iter = t.get("z", jnp.asarray(z)) + jnp.asarray(noise) * std
        out, upd = net.apply({"params": t["net"],
                              "batch_stats": variables["batch_stats"]},
                             z_iter, True, mutable=["batch_stats"])
        out_lr = (down.conv2d_with(out, t["down"]) if "down" in t
                  else down(out))
        err = (out_lr - lr_img) ** 2
        loss = (jnp.mean(err) if lr_mask is None
                else jnp.sum(err * lr_mask) / lr_count)
        return loss, upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(t)
    return float(loss), grads, _flat(stats)


def _check_grad(name, got, want):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=3e-6,
                               err_msg=name)


def _check_adam_step(name, g, before, after, lr):
    """Adam after one step, computed by optax from the same gradient."""
    tx = optax.adam(lr)
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(before)))
    np.testing.assert_allclose(after - before, np.asarray(upd), rtol=1e-4,
                               atol=1e-7, err_msg=name)


@pytest.mark.parametrize("variant", ["lbfgs_fixed", "opt_over", "masked"])
def test_one_iteration_matches_jax(variant):
    z, noise, lr_img, _, _, variables = _inputs()
    loss_j, grads_j, stats_j = _jax_iteration(variant)
    config = dip.DIPConfig(conv_fusion="auto", **SMALL)
    net, down = dip.build(config)
    load_flax_skipnet(net, variables["params"], variables["batch_stats"])
    params = dict(net.named_parameters())
    before = {k: v.detach().clone() for k, v in params.items()}
    lr_t = _nchw(lr_img)

    if variant == "lbfgs_fixed":
        stats0 = {k: v.clone() for k, v in net.state_dict().items()}
        leaves = list(params.values())
        loss = dip.dip_loss(net, down, _nchw(z), lr_t, update_stats=False)
        grads = dict(zip(params, torch.autograd.grad(loss, leaves)))
        flat = torch.cat([grads[k].reshape(-1) for k in params])
        upd, _ = lbfgs_fixed_step(flat, lbfgs_fixed_init(flat.numel(), 10),
                                  0.01)
        # the first step is -min(1, 1/||g||_1) * lr * g, as tpusr's
        t = min(1.0, 1.0 / float(flat.abs().sum())) * 0.01
        np.testing.assert_allclose(upd.numpy(), -t * flat.numpy(),
                                   rtol=1e-6, atol=1e-12)
        # running statistics untouched by the deterministic objective
        for k, v in net.state_dict().items():
            assert torch.equal(v, stats0[k]), k
    else:
        zt, kernel, mask = _nchw(z), None, None
        leaves = list(params.values())
        if variant == "opt_over":
            zt = zt.clone().requires_grad_()
            kernel = down.kernel.clone().requires_grad_()
            leaves += [zt, kernel]
            z0, k0 = zt.detach().clone(), kernel.detach().clone()
        else:
            mask = torch.from_numpy(np.array(jax_valid_mask(
                lr_img.shape[1:3], np.asarray(VALID) // 4)))
            mask = mask[..., 0][None, None]
        opt = torch.optim.Adam(leaves, lr=config.learning_rate)
        loss = dip.dip_iteration(net, down, opt, zt, _nchw(noise), lr_t,
                                 config.reg_noise_std, kernel, mask)
        grads = {k: p.grad for k, p in params.items()}
        state = net.state_dict()
        for key, v in stats_j.items():
            np.testing.assert_allclose(state[_torch_key(key)].numpy(), v,
                                       rtol=2e-4, atol=1e-5, err_msg=key)
        if variant == "opt_over":
            gz = zt.grad.permute(0, 2, 3, 1).numpy()
            _check_grad("z", gz, np.asarray(grads_j["z"]))
            _check_grad("down", kernel.grad.numpy(),
                        np.asarray(grads_j["down"]))
            _check_adam_step("z", gz, z0.permute(0, 2, 3, 1).numpy(),
                             zt.detach().permute(0, 2, 3, 1).numpy(),
                             config.learning_rate)
            _check_adam_step("down", kernel.grad.numpy(), k0.numpy(),
                             kernel.detach().numpy(), config.learning_rate)
    assert float(loss.detach()) == pytest.approx(loss_j, rel=1e-5)
    for key, gj in _flat(grads_j["net"]).items():
        name = _torch_key(key)
        g = _to_jax_layout(key, grads[name].numpy())
        _check_grad(key, g, gj)
        if variant != "lbfgs_fixed":
            _check_adam_step(
                key, g, _to_jax_layout(key, before[name].numpy()),
                _to_jax_layout(key, params[name].detach().numpy()),
                config.learning_rate)


# ----------------------------------------------------- short engine runs
def _run(lr, hr, seed=0, **kw):
    cfg = dip.DIPConfig(**{**SMALL, "num_iter": 20, "log_freq": 10, **kw})
    return dip.dip_superresolve(lr, hr, cfg, torch.Generator().manual_seed(
        seed), device="cpu")


@pytest.mark.parametrize("search", ["fixed", "zoom"])
def test_lbfgs_runs_lower_the_loss(search):
    lr, hr = _pair(hw=32)
    resolved, curves = _run(lr, hr, optimizer="lbfgs",
                            lbfgs_line_search=search, learning_rate=0.5)
    assert resolved.shape == hr.shape
    assert np.all(np.isfinite(curves["loss"]))
    assert curves["loss"][-1] < curves["loss"][0]
    if search == "fixed":
        assert list(curves["evals"]) == [10, 10]
    else:  # the first iteration evaluates, then one per trial point
        assert curves["evals"][0] >= 11 and curves["evals"][1] >= 10


def test_meshgrid_and_opt_over_runs():
    lr, hr = _pair(hw=32)
    mesh, c_mesh = _run(lr, hr, input_method="meshgrid", input_depth=2)
    assert mesh.shape == hr.shape and np.all(np.isfinite(c_mesh["psnr"]))
    base, _ = _run(lr, hr, reg_noise_std=0.0)
    for parts in ("net,input", "net,down", "net,input,down"):
        got, curves = _run(lr, hr, reg_noise_std=0.0, opt_over=parts)
        assert np.all(np.isfinite(curves["loss"]))
        assert curves["loss"][-1] < curves["loss"][0]
        assert not torch.allclose(got, base)  # the extra leaves trained


def test_bucketed_run_masks_and_group_equals_separate_runs():
    """A bucketed image gives the same curves whatever the padding holds,
    and the grouped run equals separate bucketed runs with the same
    generators."""
    lr, hr = _pair(hw=32)
    lr2, hr2 = _pair(seed=1, hw=32)
    pads = [(np.pad(l[:, :6, :7], ((0, 0), (0, 2), (0, 1), (0, 0))),
             np.pad(h[:, :24, :28], ((0, 0), (0, 8), (0, 4), (0, 0))))
            for l, h in ((lr, hr), (lr2, hr2))]
    cfg = dip.DIPConfig(**{**SMALL, "num_iter": 6, "log_freq": 3})
    sep = [dip.dip_superresolve_bucketed(l, h, VALID, cfg,
                                         torch.Generator().manual_seed(i),
                                         "cpu")
           for i, (l, h) in enumerate(pads)]
    res, curves = dip.dip_superresolve_scan_bucketed(
        np.stack([p[0] for p in pads]), np.stack([p[1] for p in pads]),
        [VALID, VALID], [torch.Generator().manual_seed(i) for i in (0, 1)],
        cfg, "cpu")
    assert res.shape == (2, 1, 32, 32, 3)
    for i, (r, c) in enumerate(sep):
        assert torch.equal(res[i], r)
        for k in c:
            np.testing.assert_array_equal(curves[k][i], c[k])
    # garbage in the padding changes nothing (loss and curves are masked;
    # the net sees only z)
    junk = [pads[0][0].copy(), pads[0][1].copy()]
    junk[0][:, 6:] = 0.7
    junk[1][:, 24:] = 0.3
    r_junk, c_junk = dip.dip_superresolve_bucketed(
        *junk, VALID, cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(r_junk, sep[0][0])
    for k in ("psnr", "ssim", "loss"):
        np.testing.assert_array_equal(c_junk[k], sep[0][1][k])


def test_lpips_curve_is_the_clean_forward_at_each_chunk_head(
        npz):  # noqa: F811
    """The LPIPS curve (NaN before this port repaired it) is finite and is
    lpips_fn of the same forward that gives PSNR at each chunk head."""
    params = load_lpips_npz(npz)
    seen = []

    def lpips_fn(x, y):
        seen.append(x.clone())
        return lpips_distance(params, x, y)

    lr, hr = _pair(hw=32)
    cfg = dip.DIPConfig(**{**SMALL, "num_iter": 6, "log_freq": 3})
    _, curves = dip.dip_superresolve(lr, hr, cfg, device="cpu",
                                     lpips_fn=lpips_fn)
    assert len(seen) == 2 and np.all(np.isfinite(curves["lpips"]))
    hr_t = torch.from_numpy(hr)
    for i, out in enumerate(seen):
        assert float(lpips_distance(params, out, hr_t)) == curves["lpips"][i]
        assert float(dip.psnr_fn(out, hr_t)) == curves["psnr"][i]
