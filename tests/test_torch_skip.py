"""tpusr_torch SkipNet against the JAX SkipNet with the same weights.

The JAX net runs with conv_fusion='off' (its unfused XLA dataflow); the
port runs both its fused dataflow ('auto', through the fused conv's plain
versions on the CPU) and its unfused one ('off'). Weights cross through
tpusr_torch.io.weights. Tolerances are those of tests/test_skip_fusion.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpusr.models.skip import SkipNet as JaxSkipNet
from tpusr_torch.io.weights import load_flax_skipnet
from tpusr_torch.models.layers import _batch_moments
from tpusr_torch.models.skip import SkipNet, build_dip_net

CFGS = {
    "2scales_reflect": dict(num_channels_down=(32, 32),
                            num_channels_up=(32, 32),
                            num_channels_skip=(4, 4), pad="reflection",
                            upsample_mode="bilinear"),
    "3scales_zero": dict(num_channels_down=(16, 24, 32),
                         num_channels_up=(16, 24, 32),
                         num_channels_skip=(4, 0, 4), pad="zero",
                         upsample_mode="nearest"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _cfg(cfg_name):
    return dict(num_input_channels=8, num_output_channels=3,
                act_fun="LeakyReLU", **CFGS[cfg_name])


@functools.lru_cache(maxsize=None)
def _jax_side(cfg_name, seed):
    """Inputs, variables, and the JAX forward, updated stats and parameter
    gradients of mean(y^2), from one jitted program per configuration."""
    jnet = JaxSkipNet(conv_fusion="off", **_cfg(cfg_name))
    x = np.random.default_rng(seed).standard_normal(
        (1, 32, 32, 8)).astype(np.float32)
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(seed), jnp.asarray(x))

    def run(params, stats, xj):
        def loss(p):
            y, upd = jnet.apply({"params": p, "batch_stats": stats}, xj,
                                mutable=["batch_stats"])
            return jnp.mean(jnp.square(y)), (y, upd["batch_stats"])
        grads, (y, new_stats) = jax.grad(loss, has_aux=True)(params)
        return y, new_stats, grads

    y, new_stats, grads = jax.jit(run)(variables["params"],
                                       variables["batch_stats"],
                                       jnp.asarray(x))
    return x, variables, np.asarray(y), _flat(new_stats), _flat(grads)


def _pair(cfg_name, fusion, seed=0):
    x, variables, y, stats, grads = _jax_side(cfg_name, seed)
    tnet = SkipNet(conv_fusion=fusion, **_cfg(cfg_name))
    load_flax_skipnet(tnet, variables["params"], variables["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    return variables, tnet, xt, y, stats, grads


def _flat(tree, sep="."):
    return {f"{m}{sep}{k}": np.asarray(v) for m, leaves in tree.items()
            for k, v in leaves.items()}


_TORCH_NAME = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _torch_key(key):
    mod, leaf = key.split(".")
    return f"{mod}.{_TORCH_NAME[leaf]}"


@pytest.mark.parametrize("fusion", ["auto", "off"])
@pytest.mark.parametrize("cfg_name", list(CFGS))
def test_forward_and_running_stats_match_jax(cfg_name, fusion):
    _, tnet, xt, yj, stats_j, _ = _pair(cfg_name, fusion)
    yt = tnet(xt)
    np.testing.assert_allclose(yt.permute(0, 2, 3, 1).detach().numpy(), yj,
                               rtol=2e-4, atol=2e-5)
    state = tnet.state_dict()
    for key, v in stats_j.items():
        np.testing.assert_allclose(state[_torch_key(key)].numpy(), v,
                                   rtol=2e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("fusion", ["auto", "off"])
@pytest.mark.parametrize("cfg_name", list(CFGS))
def test_parameter_gradients_match_jax(cfg_name, fusion):
    _, tnet, xt, _, _, gj = _pair(cfg_name, fusion)
    tnet(xt).square().mean().backward()
    params = dict(tnet.named_parameters())
    assert set(params) == {_torch_key(k) for k in gj}
    for key, g in gj.items():
        if key.endswith(".kernel"):
            g = g.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(params[_torch_key(key)].grad.numpy(), g,
                                   rtol=5e-4, atol=3e-6, err_msg=key)


def test_update_stats_false_leaves_running_stats():
    """The DIP metric forward is train-mode but discards its stat update."""
    _, tnet, xt, *_ = _pair("2scales_reflect", "auto")
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    with torch.no_grad():
        tnet(xt, update_stats=False)
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_f64_unfused_net_stays_f64():
    """chip_smoke.py holds the fused f32 net to the unfused net in f64: that
    net computes in f64 throughout, batch moments and running stats too."""
    _, tnet, xt, *_ = _pair("2scales_reflect", "off")
    assert all(m.dtype == torch.float64
               for m in _batch_moments(xt.double())[:2])
    ref = SkipNet(conv_fusion="off", **_cfg("2scales_reflect"))
    ref.load_state_dict(tnet.state_dict())
    ref.double()
    y = tnet(xt)
    y64 = ref(xt.double())
    np.testing.assert_allclose(y.detach().numpy(), y64.detach().numpy(),
                               rtol=2e-4, atol=2e-5)
    for (k, v), v64 in zip(tnet.state_dict().items(),
                           ref.state_dict().values()):
        assert v64.dtype == torch.float64, k
        np.testing.assert_allclose(v.numpy(), v64.numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=k)


def test_full_width_parameter_count():
    """build_dip_net(): input 32, 128 channels, 5 scales — the JAX count
    (PARITY.md)."""
    net = build_dip_net(generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in net.parameters()) == 2_217_831
    assert tuple(net.up0_conv.weight.shape) == (128, 132, 3, 3)
    assert tuple(net.merge0_bn.weight.shape) == (132,)


def test_bridge_rejects_missing_and_misshapen_keys():
    variables, tnet, *_ = _pair("2scales_reflect", "off")
    params = {k: dict(v) for k, v in variables["params"].items()}
    params.pop("head_conv")
    with pytest.raises(KeyError, match="head_conv"):
        load_flax_skipnet(tnet, params, variables["batch_stats"])
    params = {k: dict(v) for k, v in variables["params"].items()}
    params["head_conv"]["bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="head_conv.bias"):
        load_flax_skipnet(tnet, params, variables["batch_stats"])
