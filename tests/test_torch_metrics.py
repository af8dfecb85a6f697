"""tpusr_torch PSNR / SSIM against the JAX package's on random pairs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpusr.engine import metrics as jm
from tpusr_torch.engine import metrics as tm


@pytest.mark.parametrize("seed,shape", [(0, (1, 32, 32, 3)),
                                        (1, (1, 24, 40, 3)),
                                        (2, (2, 16, 16, 1))])
def test_psnr_ssim_match_jax(seed, shape):
    rng = np.random.default_rng(seed)
    target = rng.random(shape).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.1, shape), 0, 1).astype(
        np.float32)
    p, t = torch.from_numpy(pred), torch.from_numpy(target)
    pj, tj = jnp.asarray(pred), jnp.asarray(target)
    for dr in (None, 1.0):
        assert float(tm.psnr(p, t, dr)) == pytest.approx(
            float(jm.psnr(pj, tj, dr)), abs=1e-5)
    assert float(tm.ssim(p, t)) == pytest.approx(float(jm.ssim(pj, tj)),
                                                 abs=1e-5)
    assert float(tm.ssim(t, t)) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("seed,shape,valid", [(0, (1, 32, 40, 3), (24, 27)),
                                              (1, (1, 64, 64, 3), (64, 50)),
                                              (2, (2, 24, 24, 1), (13, 24))])
def test_masked_psnr_ssim_match_jax(seed, shape, valid):
    """On zero-padded images: the valid region's range, mean and SSIM map."""
    rng = np.random.default_rng(seed)
    target = np.zeros(shape, np.float32)
    target[:, :valid[0], :valid[1]] = rng.random(
        (shape[0], *valid, shape[3])) * 0.8 + 0.1
    pred = np.clip(target + rng.normal(0, 0.1, shape), 0, 1).astype(
        np.float32)
    p, t = torch.from_numpy(pred), torch.from_numpy(target)
    pj, tj = jnp.asarray(pred), jnp.asarray(target)
    vj = jnp.asarray(valid, jnp.int32)
    for dr in (None, 1.0):
        assert float(tm.psnr_masked(p, t, valid, dr)) == pytest.approx(
            float(jm.psnr_masked(pj, tj, vj, dr)), abs=1e-5)
    assert float(tm.ssim_masked(p, t, valid)) == pytest.approx(
        float(jm.ssim_masked(pj, tj, vj)), abs=1e-5)
    # the full extent is the unmasked metric
    full = shape[1:3]
    assert float(tm.psnr_masked(p, t, full)) == pytest.approx(
        float(tm.psnr(p, t)), abs=1e-5)
    assert float(tm.ssim_masked(p, t, full)) == pytest.approx(
        float(tm.ssim(p, t)), abs=1e-5)
