"""tpusr_torch's SRGAN Discriminator against tpusr's, on the CPU.

Weights cross through ``load_flax_discriminator`` (with random running
statistics); the forward is held in f32 to 1e-5 relative to the largest
logit, in eval and train mode, at hr_patch 32 and at 40 (not a multiple of
16: its last map is 3 x 3, ceil-halving). The reference's .pth interchange
is held both ways against tpusr's exporter and importer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr.io.checkpoint import disc_feature_hw as jax_feature_hw
from tpusr.io.checkpoint import export_torch_discriminator as jax_export
from tpusr.io.checkpoint import import_torch_discriminator as jax_import
from tpusr.models.srgan import Discriminator as JaxD
from tpusr_torch.io.checkpoint import (export_torch_discriminator,
                                       import_torch_discriminator)
from tpusr_torch.io.weights import _flat_discriminator, load_flax_discriminator
from tpusr_torch.models.srgan import (Discriminator, disc_feature_hw,
                                      discriminator_prob)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _variables(hr, seed=0):
    v = jax.jit(JaxD().init)(jax.random.key(seed), jnp.zeros((1, hr, hr, 3)))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), v["batch_stats"])
    return jax.tree.map(np.asarray, v["params"]), stats


def _port(hr, params, stats):
    d = Discriminator(hr_patch=hr, device="cpu")
    load_flax_discriminator(d, params, stats)
    return d


@pytest.mark.parametrize("hr", [32, 40])
def test_forward_matches_tpusr(hr):
    params, stats = _variables(hr)
    x = np.random.default_rng(hr).uniform(-1, 1, (3, hr, hr, 3)).astype(
        np.float32)
    d = _port(hr, params, stats)
    for train in (False, True):
        want, _ = jax.jit(functools.partial(
            JaxD().apply, train=train, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
        with torch.no_grad():
            got = d(torch.from_numpy(x).permute(0, 3, 1, 2), train,
                    update_stats=False)
        assert got.dtype == torch.float32 and got.shape == (3, 1)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_feature_side_and_parameter_count():
    for n in (32, 40, 192, 200):
        assert disc_feature_hw(n) == jax_feature_hw(n)
    assert disc_feature_hw(200) == 13
    d = Discriminator(hr_patch=192, device="cpu")
    assert d.dense1.weight.shape == (1024, 12 * 12 * 512)
    assert 79e6 < sum(p.numel() for p in d.parameters()) < 81e6
    assert torch.equal(discriminator_prob(torch.zeros(2, 1)),
                       torch.full((2, 1), 0.5))


def test_stat_groups_equal_two_sequential_calls():
    params, stats = _variables(32)
    gen = torch.Generator().manual_seed(2)
    real, fake = (torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1
                  for _ in range(2))
    seq, cat = _port(32, params, stats), _port(32, params, stats)
    with torch.no_grad():
        want = torch.cat([seq(real, True), seq(fake, True)])
        got = cat(torch.cat([real, fake]), True, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    want_sd = seq.state_dict()
    for k, v in cat.state_dict().items():
        torch.testing.assert_close(v, want_sd[k], rtol=1e-5, atol=1e-7,
                                   msg=k)


@pytest.mark.parametrize("hr", [32, 40])
def test_pth_round_trip_with_tpusr(hr):
    """tpusr's export imports here to tpusr's own weights, and the port's
    export imports in tpusr to the same: dense1 leaves and returns in the
    reference's C, H, W column order."""
    params, stats = _variables(hr)
    ref_sd = jax_export(params, stats, hr_patch=hr)
    d = Discriminator(hr_patch=hr, device="cpu")
    d.load_state_dict(import_torch_discriminator(ref_sd, hr))
    want = _port(hr, params, stats).state_dict()
    for k, v in d.state_dict().items():
        assert torch.equal(v, want[k]), k
    ours = export_torch_discriminator(d.state_dict(), hr)
    assert ours.keys() == ref_sd.keys()
    for k, v in ref_sd.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    back_p, back_s = jax_import({k: v.numpy() for k, v in ours.items()},
                                hr_patch=hr)
    flat = _flat_discriminator(jax.tree.map(np.asarray, back_p))
    for k, v in _flat_discriminator(params).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
