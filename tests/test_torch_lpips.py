"""tpusr_torch's LPIPS against tpusr's, with random npz weights in tpusr's
layout. f32, within 1e-5 (convs summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr.models import lpips as jlp
from tpusr_torch.models import lpips as tlp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """Random AlexNet + head weights: HWIO kernels at 1/sqrt(fan in),
    non-negative heads."""
    rng = np.random.default_rng(0)
    arrays, cin = {}, 3
    for i, (name, cout, k, _, _) in enumerate(tlp._ALEX_CONVS):
        arrays[f"{name}.kernel"] = (rng.standard_normal((k, k, cin, cout))
                                    / np.sqrt(k * k * cin)).astype(np.float32)
        arrays[f"{name}.bias"] = (rng.standard_normal(cout) * 0.1).astype(
            np.float32)
        arrays[f"lin{i}.kernel"] = rng.random(
            cout).astype(np.float32)
        cin = cout
    path = tmp_path_factory.mktemp("lpips") / "alex.npz"
    np.savez(path, **arrays)
    return str(path)


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("h,w", [(64, 64), (71, 90)])
def test_distance_matches_tpusr(npz, h, w):
    x, y = _images(h, w, h)
    want = float(jlp.lpips_distance(jlp.load_lpips_npz(npz), jnp.asarray(x),
                                    jnp.asarray(y)))
    got = float(tlp.lpips_distance(tlp.load_lpips_npz(npz),
                                   torch.from_numpy(x), torch.from_numpy(y)))
    assert want > 0
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_taps_match_tpusr(npz):
    x, _ = _images(64, 64, 1)
    want = jlp.alexnet_taps(jlp.load_lpips_npz(npz), jnp.asarray(x))
    got = tlp.alexnet_taps(tlp.load_lpips_npz(npz),
                           torch.from_numpy(x).permute(0, 3, 1, 2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), atol=1e-5)


def test_make_lpips_follows_the_env(npz, monkeypatch):
    monkeypatch.delenv(tlp.LPIPS_WEIGHTS_ENV, raising=False)
    assert tlp.make_lpips() is None
    monkeypatch.setenv(tlp.LPIPS_WEIGHTS_ENV, npz + ".missing")
    assert tlp.make_lpips() is None
    monkeypatch.setenv(tlp.LPIPS_WEIGHTS_ENV, npz)
    fn = tlp.make_lpips()
    x, y = _images(64, 64, 2)
    want = float(jlp.make_lpips()(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(
        float(fn(torch.from_numpy(x), torch.from_numpy(y))), want,
        atol=1e-5)
