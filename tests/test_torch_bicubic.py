"""tpusr_torch's bicubic resize and degradation ops against tpusr and PIL.

Tolerances: the float resize within 1e-4 of tpusr's (f32 contractions
summed in another order); the uint8 resize byte-exact against tpusr and
against PIL.Image.resize(BICUBIC); degrade_pipeline without noise within
1 LSB of tpusr's (a value that lands on .5 can round either way after f32
sums in another order); the noisy ops by their statistics, as the random
streams differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpusr.ops import bicubic as jb
from tpusr.ops.degrade import degrade_pipeline as jax_degrade_pipeline
from tpusr_torch.ops import bicubic as tb
from tpusr_torch.ops.degrade import (add_gaussian_noise,
                                     add_salt_pepper_noise,
                                     degrade_pipeline)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _rand_img(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((64, 48), (32, 24)),     # x2 down
    ((80, 96), (10, 12)),     # x8 down
    ((24, 20), (48, 40)),     # x2 up
])
def test_resize_bicubic_matches_tpusr(in_hw, out_hw):
    img = _rand_img(*in_hw).astype(np.float32)
    want = np.asarray(jb.resize_bicubic(jnp.asarray(img[None]), *out_hw))
    got = tb.resize_bicubic(torch.from_numpy(img[None]), *out_hw)
    assert got.shape == (1, *out_hw, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # HWC in, HWC out
    np.testing.assert_allclose(
        tb.resize_bicubic(torch.from_numpy(img), *out_hw).numpy(), want[0],
        atol=1e-4)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((64, 48), (32, 24)),
    ((63, 49), (31, 24)),
    ((33, 57), (16, 28)),
    ((20, 30), (160, 240)),
])
def test_resize_bicubic_u8_is_byte_exact(in_hw, out_hw):
    img = _rand_img(*in_hw, seed=1)
    pil = np.asarray(Image.fromarray(img).resize(out_hw[::-1],
                                                 Image.BICUBIC))
    theirs = np.asarray(jb.resize_bicubic_u8(jnp.asarray(img), *out_hw))
    got = tb.resize_bicubic_u8(torch.from_numpy(img), *out_hw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), pil.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), theirs)


def test_resize_matrices_match_tpusr():
    for n_in, n_out in [(64, 32), (17, 5), (8, 24)]:
        np.testing.assert_array_equal(tb.resize_matrix(n_in, n_out),
                                      jb.resize_matrix(n_in, n_out))
        np.testing.assert_array_equal(tb.resize_matrix_u8(n_in, n_out),
                                      jb.resize_matrix_u8(n_in, n_out))


def test_pil_downsample_size_rule():
    out = tb.pil_downsample(torch.zeros(1, 37, 53, 3), 2)
    assert out.shape == (1, 18, 26, 3)


def test_degrade_pipeline_without_noise_matches_tpusr():
    hr = _rand_img(64, 96, seed=2)[None]
    want = np.asarray(jax_degrade_pipeline(jax.random.key(0),
                                           jnp.asarray(hr), 4))
    got = degrade_pipeline(torch.Generator(), torch.from_numpy(hr), 4)
    assert got.shape == (1, 16, 24, 3)
    assert np.abs(got.numpy() - want).max() <= 1.0


def test_add_gaussian_noise_statistics():
    img = torch.full((2, 64, 64, 3), 128.0)
    out = add_gaussian_noise(torch.Generator().manual_seed(0), img, std=0.1)
    assert torch.equal(out, out.floor())
    assert out.min() >= 0 and out.max() <= 255
    assert abs(float(out.mean()) - 128) < 1.5
    assert 23 < float(out.std()) < 28  # 25.5, floored


def test_add_salt_pepper_noise_statistics():
    img = torch.full((2, 64, 64, 3), 128.0)
    out = add_salt_pepper_noise(torch.Generator().manual_seed(1), img,
                                s=0.1, p=0.1)
    salt, pepper = out == 255, out == 0
    assert torch.equal(salt.all(-1), salt.any(-1))
    assert torch.equal(pepper.all(-1), pepper.any(-1))
    # pepper wins where both are drawn: salt ~ 0.1 * 0.9, pepper ~ 0.1
    assert 0.07 < float(salt[..., 0].float().mean()) < 0.11
    assert 0.08 < float(pepper[..., 0].float().mean()) < 0.12
    assert torch.all(out[~salt & ~pepper] == 128.0)


@pytest.mark.parametrize("noise", [{"type": "Gaussian", "std": 0.05},
                                   {"type": "SaltAndPepper", "s": 0.1,
                                    "p": 0.1}])
def test_degrade_pipeline_with_noise(noise):
    hr = torch.from_numpy(_rand_img(32, 48, seed=3)[None])
    gen = torch.Generator().manual_seed(2)
    out = degrade_pipeline(gen, hr, 2, noise)
    clean = degrade_pipeline(gen, hr, 2)
    assert out.shape == clean.shape == (1, 16, 24, 3)
    assert torch.equal(out, out.floor()) and not torch.equal(out, clean)
    with pytest.raises(ValueError, match="unknown noise type"):
        degrade_pipeline(gen, hr, 2, {"type": "Speckle"})
