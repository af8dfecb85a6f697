"""tpusr_torch's SRGAN Generator and generator_forward against tpusr's.

Weights cross through ``load_flax_generator``, with random running BN
statistics so that eval's normalisation is exercised. The JAX generator
runs its XLA path (no interpret-mode kernel on the CPU); the port runs its
fused route (g_fuse 'eval': kernel A's plain version on the CPU) and its
unfused one ('off'). f32 within 1e-5, as tests/test_torch_rrdb.py. bf16
within 2e-2 of the largest entry: bf16 rounds at other places in the two
packages (the plain kernel A rounds its f32 output once and adds the bias
after; XLA rounds each bf16 op).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr.engine.gan import GANTrainConfig as JaxConfig
from tpusr.engine.gan import generator_forward as jax_generator_forward
from tpusr.models import layers as jl
from tpusr.models.srgan import Generator as JaxGenerator
from tpusr_torch.engine.gan import GANTrainConfig, generator_forward
from tpusr_torch.io.weights import load_flax_generator
from tpusr_torch.models import layers
from tpusr_torch.models.srgan import Generator


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def random_variables(factor, blocks, seed=0):
    """tpusr Generator params and random running stats (numpy)."""
    v = JaxGenerator(factor=factor, residual_blocks_count=blocks).init(
        jax.random.key(seed), jnp.zeros((1, 8, 8, 3)), False)
    rng = np.random.default_rng(seed)
    lims = {"mean": (-0.2, 0.2), "var": (0.5, 1.5)}

    def randomize(tree):
        return {k: randomize(a) if k not in lims else
                rng.uniform(*lims[k], a.shape).astype(np.float32)
                for k, a in tree.items()}

    return (jax.tree.map(np.asarray, v["params"]),
            randomize(v["batch_stats"]))


@functools.lru_cache(maxsize=None)
def _jax_side(factor, blocks, h, w, dtype=None, train=False):
    x = np.random.default_rng(h * w).random((1, h, w, 3)).astype(np.float32)
    params, stats = random_variables(factor, blocks)
    cfg = JaxConfig(factor=factor, residual_blocks_count=blocks, dtype=dtype)
    y = jax_generator_forward(params, stats, jnp.asarray(x), cfg,
                              train=train)
    return x, params, stats, np.asarray(y)


def _port(factor, blocks, params, stats, dtype=None):
    g = Generator(factor=factor, residual_blocks_count=blocks, dtype=dtype,
                  device="cpu")
    load_flax_generator(g, params, stats)
    return g


@pytest.mark.parametrize("factor,count", [(8, 1_697_175), (16, 1_844_888)])
def test_param_count(factor, count):
    g = Generator(factor=factor, device="cpu")
    assert sum(p.numel() for p in g.parameters()) == count


@pytest.mark.parametrize("g_fuse", ["eval", "off"])
@pytest.mark.parametrize("factor,h,w", [(8, 16, 24), (4, 12, 10)])
def test_generator_forward_matches_jax(factor, h, w, g_fuse):
    x, params, stats, want = _jax_side(factor, 2, h, w)
    g = _port(factor, 2, params, stats)
    cfg = GANTrainConfig(factor=factor, residual_blocks_count=2,
                         g_fuse=g_fuse)
    with torch.no_grad():
        got = generator_forward(g, torch.from_numpy(x), cfg).numpy()
    assert got.shape == want.shape == (1, factor * h, factor * w, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_train_mode_forward_matches_jax_and_keeps_stats():
    """train=True normalises with batch statistics and, as tpusr, discards
    their update."""
    x, params, stats, want = _jax_side(8, 2, 16, 24, train=True)
    g = _port(8, 2, params, stats)
    before = {k: v.clone() for k, v in g.state_dict().items()}
    with torch.no_grad():
        got = generator_forward(g, torch.from_numpy(x),
                                GANTrainConfig(residual_blocks_count=2),
                                train=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    for k, v in g.state_dict().items():
        assert torch.equal(v, before[k])


def test_bf16_forward_matches_jax():
    x, params, stats, want = _jax_side(8, 2, 16, 24, dtype="bfloat16")
    g = _port(8, 2, params, stats, dtype=torch.bfloat16)
    with torch.no_grad():
        got = generator_forward(g, torch.from_numpy(x), GANTrainConfig(
            residual_blocks_count=2, dtype="bfloat16"))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_prelu_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 5, 6, 4)).astype(
        np.float32)
    want = np.asarray(jl.PReLU().apply({"params": {"alpha": jnp.asarray(
        [0.3])}}, jnp.asarray(x)))
    p = layers.PReLU()
    assert float(p.alpha.detach()) == 0.25
    with torch.no_grad():
        p.alpha.fill_(0.3)
        got = p(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pixel_shuffle_matches_jax():
    x = np.arange(2 * 3 * 5 * 16, dtype=np.float32).reshape(2, 3, 5, 16)
    want = np.asarray(jl.pixel_shuffle(jnp.asarray(x), 2))
    got = layers.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("g_fuse,fused", [("eval", 36), ("off", 0)])
def test_routing(monkeypatch, g_fuse, fused):
    """Every 3x3 conv of the x8 net through kernel A's wrapper (32 in the
    residual blocks, conv2, 3 pixel-shuffle convs); the 9x9 convs not.
    The launch counters move only on the card, so calls are counted."""
    calls = []
    real = layers.fused_conv3x3

    def counting(x, w, *a, **k):
        calls.append((x.shape[-1], w.shape[-1]))
        return real(x, w, *a, **k)

    monkeypatch.setattr(layers, "fused_conv3x3", counting)
    g = Generator(factor=8, device="cpu")
    with torch.no_grad():
        y = generator_forward(g, torch.zeros(1, 3, 4, 3),
                              GANTrainConfig(g_fuse=g_fuse))
    assert y.shape == (1, 24, 32, 3)
    assert len(calls) == fused
    if fused:
        assert calls.count((64, 256)) == 3 and calls.count((64, 64)) == 33


@pytest.mark.parametrize("case", ["missing", "extra", "shape"])
def test_bridge_rejects_a_mismatch(case):
    _, params, stats, _ = _jax_side(8, 2, 16, 24)
    params = jax.tree.map(np.array, params)  # a copy of the cached tree
    stats = jax.tree.map(np.array, stats)
    if case == "missing":
        del stats["res1"]["bn2"]["var"]
    elif case == "extra":
        params["ps0"]["prelu1"]["beta"] = np.ones(1, np.float32)
    else:
        params["conv3"]["kernel"] = params["conv3"]["kernel"][:8]
    g = Generator(factor=8, residual_blocks_count=2, device="cpu")
    with pytest.raises(KeyError if case != "shape" else ValueError):
        load_flax_generator(g, params, stats)


def test_config_carries_tpusr_fields_and_defaults():
    """Every field and default of tpusr's config, and besides them only the
    port's generator switch (ESRGAN's RRDBNet on the eval entry, which
    tpusr's engine has not), whose defaults keep the SRGAN path."""
    ours = {f.name: f.default for f in dataclasses.fields(GANTrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_only = {"generator": "srgan", "rrdb_blocks": 23}
    assert {k: v for k, v in ours.items() if k not in port_only} == theirs
    assert {k: ours[k] for k in port_only} == port_only


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Generator(factor=8, residual_blocks_count=1)
