"""tpusr_torch's RRDBNet against tpusr's with the same weights.

Weights cross through ``load_flax_rrdbnet``. The JAX net runs its unfused
dataflow (``fusion='off'``) and, once, its Pallas route in interpret mode;
the port runs its fused route ('auto': kernels C and A through their plain
versions on the CPU) and its unfused one ('off'). Tolerances are those of
tests/test_rrdb.py and tests/test_pallas_dense.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpusr.models.rrdb import RRDBNet as JaxRRDBNet
from tpusr_torch.io.weights import load_flax_rrdbnet
from tpusr_torch.models import layers, rrdb
from tpusr_torch.models.rrdb import DenseBlock, RRDBNet


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_side(nf, gc, nb, h, w, dtype=None, fusion="off"):
    """LR input (NHWC), params and the JAX net's output."""
    x = np.random.default_rng(h * w).random((1, h, w, 3)).astype(np.float32)
    v = JaxRRDBNet(nf=nf, gc=gc, nb=nb).init(jax.random.key(nb),
                                             jnp.zeros((1, 8, 8, 3)))
    y = JaxRRDBNet(nf=nf, gc=gc, nb=nb, dtype=dtype, fusion=fusion).apply(
        v, jnp.asarray(x))
    return x, v["params"], np.asarray(y)


def _port(params, **kw):
    net = RRDBNet(device="cpu", **kw)
    load_flax_rrdbnet(net, params)
    return net


def test_canonical_param_count():
    """ESRGAN RRDBNet(3->3, nf64, nb23, gc32, x4) = 16,697,987 params."""
    net = RRDBNet(device="cpu")
    assert sum(p.numel() for p in net.parameters()) == 16_697_987


@pytest.mark.parametrize("nf,gc", [(64, 32), (16, 8)])
def test_fused_dense_block_matches_unfused(nf, gc):
    """'auto' (kernel C's route at nf 64 / gc 32, kernel A per conv else)
    against the concat form on F.conv2d, from the same weights."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, nf, 12, 10)).astype(np.float32))
    fused = DenseBlock(nf=nf, gc=gc, fusion="auto",
                       generator=torch.Generator().manual_seed(0))
    plain = DenseBlock(nf=nf, gc=gc, fusion="off")
    plain.load_state_dict(fused.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), rtol=1e-5, atol=1e-5)


def test_fused_net_matches_unfused():
    x = _nchw(np.random.default_rng(6).random((1, 12, 16, 3), np.float32))
    kw = dict(nf=16, nb=2, gc=8, scale=2, device="cpu")
    net_f = RRDBNet(fusion="auto", generator=torch.Generator().manual_seed(0),
                    **kw)
    net_p = RRDBNet(fusion="off", **kw)
    net_p.load_state_dict(net_f.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(net_f(x), net_p(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale,batch,h,w", [(4, 1, 12, 16), (2, 2, 8, 8)])
def test_forward_shape(scale, batch, h, w):
    net = RRDBNet(nf=16, nb=2, gc=8, scale=scale, device="cpu")
    x = torch.rand(batch, 3, h, w, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = net(x)
    assert y.shape == (batch, 3, h * scale, w * scale)
    assert y.dtype == torch.float32 and torch.isfinite(y).all()


@pytest.mark.parametrize("fusion", ["auto", "off"])
@pytest.mark.parametrize("nf,gc,nb,h,w", [(64, 32, 1, 16, 64),
                                          (16, 8, 2, 12, 20)])
def test_net_matches_jax(nf, gc, nb, h, w, fusion):
    """nf 64 / gc 32 takes kernel C's route on 'auto'; nf 16 / gc 8 runs
    every dense-block conv through kernel A (_conv3)."""
    x, params, want = _jax_side(nf, gc, nb, h, w)
    net = _port(params, nf=nf, gc=gc, nb=nb, fusion=fusion)
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert got.shape == want.shape == (1, 4 * h, 4 * w, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_jax_pallas_route_matches_the_port():
    """tpusr's line kernel and fused conv in interpret mode against the
    port's fused route, from the same weights."""
    x, params, _ = _jax_side(64, 32, 1, 16, 64)
    _, _, want = _jax_side(64, 32, 1, 16, 64, fusion="interpret")
    net = _port(params, nf=64, gc=32, nb=1, fusion="auto")
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bf16_net_matches_jax():
    """bf16 activations round at other places in the two packages (the
    dense block rounds c1..c4 once from f32 with f32 biases; XLA rounds
    each bf16 op): within 2e-2 of the largest entry."""
    x, params, want = _jax_side(64, 32, 1, 16, 64, dtype="bfloat16")
    net = _port(params, nf=64, gc=32, nb=1, dtype=torch.bfloat16)
    with torch.no_grad():
        y = net(_nchw(x))
    assert y.dtype == torch.float32
    err = np.abs(_nhwc(y) - want).max()
    assert err <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("fusion,nf,gc,dense,fused", [
    ("auto", 64, 32, 3, 4),        # kernel C per block, kernel A x 4
    ("auto", 16, 8, 0, 3 * 5 + 4),  # kernel A for every conv
    ("off", 64, 32, 0, 0),
])
def test_routing(monkeypatch, fusion, nf, gc, dense, fused):
    """Which wrapper each conv goes through (the launch counters move only
    on the card, so the calls are counted here)."""
    calls = {"dense": 0, "fused": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(rrdb, "dense_block",
                        counting("dense", rrdb.dense_block))
    monkeypatch.setattr(rrdb, "fused_conv3x3",
                        counting("fused", rrdb.fused_conv3x3))
    monkeypatch.setattr(layers, "fused_conv3x3",
                        counting("fused", layers.fused_conv3x3))
    net = RRDBNet(nf=nf, gc=gc, nb=1, fusion=fusion, device="cpu")
    with torch.no_grad():
        net(torch.zeros(1, 3, 4, 4))
    assert calls == {"dense": dense, "fused": fused}


@pytest.mark.parametrize("case", ["missing", "extra", "shape"])
def test_bridge_rejects_a_mismatch(case):
    _, params, _ = _jax_side(16, 8, 2, 12, 20)
    params = jax.tree.map(np.asarray, params)  # a copy of the cached tree
    if case == "missing":
        del params["rrdb1"]["rdb2"]["conv3_bias"]
    elif case == "extra":
        params["conv_last"]["scale"] = np.ones(3, np.float32)
    else:
        params["conv_first"]["kernel"] = params["conv_first"]["kernel"][:2]
    net = RRDBNet(nf=16, nb=2, gc=8, device="cpu")
    with pytest.raises(KeyError if case != "shape" else ValueError):
        load_flax_rrdbnet(net, params)


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RRDBNet(nf=16, nb=1, gc=8)
