"""tpusr_torch's DIP lane batch (tpusr's vmap) on the CPU.

* One batched iteration from two lanes' tpusr weights, numpy z and reg
  noise equals ``jax.vmap`` of tpusr's step (loss_fn + optax.adam) lane by
  lane: losses to 1e-5 relative, gradients to 5e-4 relative / 3e-6
  absolute and the Adam update where the gradient is clearly nonzero to
  1e-5, the tolerances tests/test_torch_dip.py holds one lane to.
* Whole runs: each lane equals the single-image ``conv_fusion='off'`` run
  with the same generator (noise, opt_over net,input,down, meshgrid, and
  the bucketed form with a mask per lane): PSNR / SSIM curves within 1e-4,
  losses within 1e-5 relative, and the images by tpusr's own criteria for
  a batched-against-unbatched run (tests/test_parallel.py:183-190: median
  abs difference < 1e-5, under a quarter of the pixels above 1e-3), since
  Adam moves a BatchNorm-fed conv bias by up to lr on the sign of its
  rounding-noise gradient.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusr_torch.engine import dip

TINY = dip.DIPConfig(factor=2, num_iter=6, log_freq=4, input_depth=4,
                     skip_n33d=8, skip_n33u=8, skip_n11=2, num_scales=2,
                     conv_fusion="off")
SMALL = dict(factor=4, learning_rate=0.01, reg_noise_std=0.05, input_depth=4,
             skip_n33d=8, skip_n33u=8, skip_n11=2, num_scales=2)
HW, LANES = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _inputs(n=LANES, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 1, 8, 8, 3)).astype(np.float32),
            rng.random((n, 1, 16, 16, 3)).astype(np.float32))


def _gens(n=LANES):
    return [torch.Generator().manual_seed(10 + i) for i in range(n)]


def _close_runs(batch, singles):
    res, curves = batch
    for i, (r1, c1) in enumerate(singles):
        diff = (res[i] - r1).abs().numpy()
        assert np.median(diff) < 1e-5, i
        assert (diff > 1e-3).mean() < 0.25, i
        for k in ("psnr", "ssim"):
            np.testing.assert_allclose(curves[k][i], c1[k], rtol=0,
                                       atol=1e-4, err_msg=k)
        np.testing.assert_allclose(curves["loss"][i], c1["loss"], rtol=1e-5)
        np.testing.assert_array_equal(curves["evals"][i], c1["evals"])
        assert np.isnan(curves["lpips"][i]).all()


@pytest.mark.parametrize("variant", [
    {}, {"opt_over": "net,input,down"},
    {"input_method": "meshgrid", "input_depth": 2}],
    ids=["noise", "opt_over-net-input-down", "meshgrid"])
def test_lanes_equal_single_runs(variant):
    cfg = dataclasses.replace(TINY, **variant)
    lr, hr = _inputs()
    batch = dip.dip_superresolve_batch(lr, hr, _gens(), cfg, device="cpu")
    assert batch[0].shape == (LANES, 1, 16, 16, 3)
    singles = [dip.dip_superresolve(lr[i], hr[i], cfg, g, device="cpu")
               for i, g in enumerate(_gens())]
    _close_runs(batch, singles)


def test_bucketed_lanes_mask_each_lane():
    """Lanes of different true sizes in one bucket: each equals its
    single bucketed run, and what lies outside a lane's valid region
    changes neither its curves nor its valid pixels."""
    lr, hr = _inputs()
    valid = np.array([[12, 14], [16, 10]])
    batch = dip.dip_superresolve_batch_bucketed(lr, hr, valid, _gens(), TINY,
                                                device="cpu")
    singles = [dip.dip_superresolve_bucketed(lr[i], hr[i], valid[i], TINY, g,
                                             device="cpu")
               for i, g in enumerate(_gens())]
    _close_runs(batch, singles)
    lr2, hr2 = lr.copy(), hr.copy()
    lr2[0, :, 6:] = 0.9  # lane 0's LR is valid in rows < 12 // 2
    hr2[0, :, 12:] = 0.1
    res2, curves2 = dip.dip_superresolve_batch_bucketed(
        lr2, hr2, valid, _gens(), TINY, device="cpu")
    for k in ("psnr", "ssim", "loss"):
        np.testing.assert_allclose(curves2[k][0], batch[1][k][0], rtol=1e-6,
                                   err_msg=k)
    torch.testing.assert_close(res2[0, :, :12, :14], batch[0][0, :, :12, :14],
                               rtol=0, atol=1e-6)


def test_lane_batch_runs_adam_only():
    lr, hr = _inputs()
    with pytest.raises(ValueError, match="lane batch runs Adam"):
        dip.dip_superresolve_batch(
            lr, hr, _gens(), dataclasses.replace(TINY, optimizer="lbfgs"),
            device="cpu")


def test_one_lane_iteration_matches_jax_vmap():
    import jax
    import jax.numpy as jnp
    import optax

    from tpusr.engine.dip import DIPConfig as JaxDIPConfig
    from tpusr.engine.dip import _build as jax_build
    from tpusr_torch.io.weights import load_flax_skipnet

    rng = np.random.default_rng(0)
    z = (rng.random((LANES, 1, HW, HW, 4)) * 0.1).astype(np.float32)
    noise = rng.standard_normal((LANES, 1, HW, HW, 4)).astype(np.float32)
    lr_img = rng.random((LANES, 1, HW // 4, HW // 4, 3)).astype(np.float32)
    net, downsampler = jax_build(JaxDIPConfig(conv_fusion="off", **SMALL))
    keys = jax.random.split(jax.random.PRNGKey(0), LANES)
    variables = jax.jit(jax.vmap(lambda k: net.init(k, jnp.asarray(z[0]))))(
        keys)
    tx = optax.adam(SMALL["learning_rate"])

    def step(params, stats, z_iter, target):
        def loss_fn(p):
            out, _ = net.apply({"params": p, "batch_stats": stats}, z_iter,
                               True, mutable=["batch_stats"])
            return jnp.mean((downsampler(out) - target) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    z_iter = z + noise * SMALL["reg_noise_std"]
    loss_j, grads_j, new_j = jax.jit(jax.vmap(step))(
        variables["params"], variables["batch_stats"], jnp.asarray(z_iter),
        jnp.asarray(lr_img))

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
    optimizer = torch.optim.Adam(params.values(), lr=config.learning_rate)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 1, 4, 2, 3)

    losses = dip.lane_iteration(nets[0], down, params, optimizer, nchw(z),
                                nchw(noise), nchw(lr_img),
                                config.reg_noise_std)
    np.testing.assert_allclose(losses.numpy(), np.asarray(loss_j), rtol=1e-5)
    for mod, leaves in grads_j.items():
        for leaf, gj in leaves.items():
            name = f"{mod}.{'weight' if leaf in ('kernel', 'scale') else leaf}"
            g = params[name].grad.numpy()
            p1 = params[name].detach().numpy()
            if leaf == "kernel":  # OIHW -> HWIO, the lane axis first
                g, p1 = (a.transpose(0, 3, 4, 2, 1) for a in (g, p1))
            gj = np.asarray(gj)
            np.testing.assert_allclose(g, gj, rtol=5e-4, atol=3e-6,
                                       err_msg=name)
            big = np.abs(gj) > 1e-5
            np.testing.assert_allclose(p1[big],
                                       np.asarray(new_j[mod][leaf])[big],
                                       rtol=1e-5, atol=1e-5, err_msg=name)
