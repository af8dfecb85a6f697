"""tpusr_torch DIP engine against the JAX DIP step, and a short CPU run.

One iteration from identical parameters, input z and reg noise (made with
numpy, handed to both packages) must give the same loss, parameter
gradients, BatchNorm running stats and Adam update as a JAX reconstruction
of ``_dip_core``'s loss_fn plus ``optax.adam`` (tpusr/engine/dip.py:285-314).
``dip_iteration`` shares its step with every eager iteration of the port's
single-image call (``_eager_step``), so this also holds the iteration the
engine runs on the CPU.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tpusr.engine.dip import DIPConfig as JaxDIPConfig
from tpusr.engine.dip import _build as jax_build
from tpusr_torch.engine import dip
from tpusr_torch.io.weights import load_flax_skipnet

SMALL = dict(factor=4, learning_rate=0.01, reg_noise_std=0.05, input_depth=8,
             skip_n33d=16, skip_n33u=16, skip_n11=4, num_scales=3)
HW = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _flat(tree):
    return {f"{m}.{k}": np.asarray(v) for m, leaves in tree.items()
            for k, v in leaves.items()}


_TORCH_NAME = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _torch_key(key):
    mod, leaf = key.split(".")
    return f"{mod}.{_TORCH_NAME[leaf]}"


def _to_jax_layout(key, a):
    return a.transpose(2, 3, 1, 0) if key.endswith(".kernel") else a


@functools.lru_cache(maxsize=None)
def _jax_step():
    """Inputs and the JAX iteration: loss, grads, new stats, new params."""
    rng = np.random.default_rng(0)
    z = (rng.random((1, HW, HW, 8)) * 0.1).astype(np.float32)
    noise = rng.standard_normal((1, HW, HW, 8)).astype(np.float32)
    lr_img = rng.random((1, HW // 4, HW // 4, 3)).astype(np.float32)
    net, downsampler = jax_build(JaxDIPConfig(conv_fusion="off", **SMALL))
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(z))
    tx = optax.adam(SMALL["learning_rate"])

    def step(params, stats, z_iter):
        def loss_fn(p):
            out, upd = net.apply({"params": p, "batch_stats": stats}, z_iter,
                                 True, mutable=["batch_stats"])
            out_lr = downsampler(out)
            return jnp.mean((out_lr - lr_img) ** 2), upd["batch_stats"]
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, grads, new_stats, optax.apply_updates(params, updates)

    z_iter = jnp.asarray(z) + jnp.asarray(noise) * SMALL["reg_noise_std"]
    loss, grads, new_stats, new_params = jax.jit(step)(
        variables["params"], variables["batch_stats"], z_iter)
    return (z, noise, lr_img, variables, float(loss), _flat(grads),
            _flat(new_stats), _flat(new_params))


@pytest.mark.parametrize("fusion", ["auto", "off"])
def test_one_iteration_matches_jax(fusion):
    (z, noise, lr_img, variables, loss_j, grads_j, stats_j,
     params_j) = _jax_step()
    config = dip.DIPConfig(conv_fusion=fusion, **SMALL)
    net, downsampler = dip.build(config)
    load_flax_skipnet(net, variables["params"], variables["batch_stats"])
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    optimizer = dip.make_optimizer(net, config)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    loss = dip.dip_iteration(net, downsampler, optimizer, nchw(z),
                             nchw(noise), nchw(lr_img),
                             config.reg_noise_std)
    assert float(loss) == pytest.approx(loss_j, rel=1e-5)

    params = dict(net.named_parameters())
    state = net.state_dict()
    for key, v in stats_j.items():
        np.testing.assert_allclose(state[_torch_key(key)].numpy(), v,
                                   rtol=2e-4, atol=1e-5, err_msg=key)
    # Adam(lr) after one step: each parameter moves by
    # -lr * g / (|g| + eps), which optax computes from the same gradients
    tx = optax.adam(config.learning_rate)
    for key, gj in grads_j.items():
        name = _torch_key(key)
        g = _to_jax_layout(key, params[name].grad.numpy())
        np.testing.assert_allclose(g, gj, rtol=5e-4, atol=3e-6, err_msg=key)
        p0 = _to_jax_layout(key, before[name].numpy())
        upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p0)))
        step = _to_jax_layout(key, params[name].detach().numpy()) - p0
        np.testing.assert_allclose(step, np.asarray(upd), rtol=1e-4,
                                   atol=1e-7, err_msg=key)
        # against the JAX update where the gradient is clearly nonzero (a
        # BN-cancelled conv bias has |g| ~ 1e-10 on one side, 0 on the other)
        big = np.abs(gj) > 1e-5
        np.testing.assert_allclose(
            (p0 + step)[big], params_j[key][big], rtol=1e-5, atol=1e-5,
            err_msg=key)


def _pair(seed=0, hw=64, factor=4):
    yy, xx = np.mgrid[0:hw, 0:hw]
    hr = np.stack([0.5 + 0.4 * np.sin(xx / 5.0), 0.5 + 0.4 * np.cos(yy / 7.0),
                   0.5 + 0.3 * np.sin((xx + yy) / 9.0)], -1)[None]
    hr = np.clip(hr + np.random.default_rng(seed).normal(0, 0.01, hr.shape),
                 0, 1).astype(np.float32)
    down = dip.Downsampler(3, factor, "lanczos2", phase=0.5,
                           preserve_size=True)
    lr = down(torch.from_numpy(hr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return lr.numpy(), hr


def test_short_run_raises_psnr_and_resolves_with_last_draw():
    lr, hr = _pair()
    cfg = dip.DIPConfig(num_iter=40, log_freq=10, **SMALL)
    run = functools.partial(dip.dip_superresolve, lr, hr, device="cpu")
    resolved, curves = run(cfg, torch.Generator().manual_seed(0))
    assert resolved.shape == hr.shape
    for k in ("psnr", "ssim", "lpips", "loss"):
        assert curves[k].shape == (4,), k
    assert np.all(np.isfinite(curves["psnr"])) and np.all(
        np.isfinite(curves["loss"]))
    assert curves["psnr"][-1] > curves["psnr"][0]
    assert curves["loss"][-1] < curves["loss"][0]
    assert np.all(np.isnan(curves["lpips"]))
    # the same seed with resolve_clean differs only in the final input:
    # the default keeps the last reg-noise draw (DIP.py:102)
    clean, curves_c = run(dip.DIPConfig(num_iter=40, log_freq=10,
                                        resolve_clean=True, **SMALL),
                          torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(curves_c["loss"], curves["loss"])
    assert not torch.equal(clean, resolved)
    # without reg noise there is no draw to keep
    quiet = {**SMALL, "reg_noise_std": 0.0}
    a, _ = run(dip.DIPConfig(num_iter=5, log_freq=5, **quiet),
               torch.Generator().manual_seed(1))
    b, _ = run(dip.DIPConfig(num_iter=5, log_freq=5, resolve_clean=True,
                             **quiet), torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


def test_unported_variants_and_missing_card_raise():
    """Every variant is ported; what tpusr rejects, the port rejects: an
    unknown opt_over part, meshgrid input with input_depth != 2, an unknown
    optimizer or line search; and 'cuda' without a card."""
    lr, hr = _pair(hw=32)
    for kw, match in (({"opt_over": "net,bogus"}, "bogus"),
                      ({"input_method": "meshgrid"}, "input_depth=2"),
                      ({"optimizer": "sgd"}, "optimizer"),
                      ({"optimizer": "lbfgs", "lbfgs_line_search": "armijo"},
                       "lbfgs_line_search")):
        with pytest.raises(ValueError, match=match):
            dip.dip_superresolve(lr, hr, dip.DIPConfig(num_iter=1, **kw),
                                 device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dip.dip_superresolve(lr, hr, dip.DIPConfig(num_iter=1))
