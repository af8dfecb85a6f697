"""tpusr_torch's degradation kernels' plain versions against tpusr.

The kernels (D, E) run only on a card (tests/test_torch_kernels_cuda.py,
chip_smoke.py); here their plain versions, which the wrappers take for a
CPU tensor, are held to:
  * Random123's known answers for Philox4x32-10 (exact);
  * tpusr's bit-to-uniform conversion, transcribed in numpy (exact);
  * tpusr's Pallas kernels in interpret mode, whose PRNG returns zero bits
    on the CPU, fed zero uniforms (exact);
  * the kernel bodies transcribed in numpy, fed the same uniforms: salt and
    pepper exact; Gaussian equal except where log/cos of two libraries
    differ by an ulp next to an integer, a fraction <= 1e-4 of elements,
    each off by exactly 1;
  * the statistics of tests/test_pallas.py, and tpusr's jax.random
    add_gaussian_noise on the same image (mean and std within 0.6, about
    four standard errors at 24,576 samples).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr.ops.degrade import add_gaussian_noise as jax_add_gaussian_noise
from tpusr.ops.pallas_degrade import (pallas_add_gaussian_noise,
                                      pallas_add_salt_pepper_noise)
from tpusr_torch.ops import fused_degrade as fd


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _img(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.float32)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    out = fd.philox4x32_10(torch.tensor([ctr], dtype=torch.int64), key)
    assert tuple(int(v) for v in out[0]) == want


def test_uniform_from_bits_matches_tpusr_conversion():
    """pallas_degrade.py:30-35 in numpy: (b >> 9) | 0x3F800000 as f32,
    minus 1."""
    bits = np.random.default_rng(1).integers(0, 2 ** 32, 4096,
                                             dtype=np.uint64)
    bits = np.concatenate([bits, [0, 0xFFFFFFFF]]).astype(np.uint32)
    want = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    got = fd.uniform_from_bits(torch.from_numpy(bits.astype(np.int64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == 0.0 and got.max() == 1.0 - 2.0 ** -23


@pytest.mark.parametrize("std", [0.05, 0.3])
def test_gaussian_on_zero_uniforms_matches_interpreted_kernel(std):
    """(300, 17, 3): two of the TPU kernel's 256-row tiles, the second
    ragged. Zero bits give u1 = 1e-7, u2 = 0, z = 5.6777."""
    img = _img((300, 17, 3))
    want = np.asarray(pallas_add_gaussian_noise(jnp.asarray(img), 3,
                                                std=std, interpret=True))
    got = fd.gaussian_from_uniforms(torch.from_numpy(img), 0.0, 0.0, std)
    np.testing.assert_array_equal(got.numpy(), want)


def test_salt_pepper_on_zero_uniforms_matches_interpreted_kernel():
    img = _img((300, 17, 3))
    want = np.asarray(pallas_add_salt_pepper_noise(
        jnp.asarray(img), 3, s=0.01, p=0.01, interpret=True))
    got = fd.salt_pepper_from_uniforms(torch.from_numpy(img), 0.0, 0.0,
                                       0.01, 0.01)
    assert not want.any()
    np.testing.assert_array_equal(got.numpy(), want)


def _uniforms(shape, seed):
    """f32 uniforms on the kernels' grid, zeros and the top value among
    them."""
    u = np.random.default_rng(seed).random(shape).astype(np.float32)
    u.flat[0], u.flat[-1] = 0.0, 1.0 - 2.0 ** -23
    return u


@pytest.mark.parametrize("std", [0.05, 1.0])
def test_gaussian_from_uniforms_matches_the_kernel_body(std):
    """pallas_degrade.py:38-49 in numpy f32."""
    img = _img((96, 64, 3), 2)
    u1, u2 = _uniforms(img.shape, 3), _uniforms(img.shape, 4)
    u1c = np.maximum(u1, np.float32(1e-7))
    z = (np.sqrt(np.float32(-2.0) * np.log(u1c))
         * np.cos(np.float32(2.0 * math.pi) * u2))
    want = np.floor(np.clip(img + z * np.float32(std * 255.0), 0.0, 255.0))
    got = fd.gaussian_from_uniforms(torch.from_numpy(img),
                                    torch.from_numpy(u1),
                                    torch.from_numpy(u2), std).numpy()
    diff = np.abs(got - want)
    assert set(np.unique(diff)) <= {0.0, 1.0}
    assert (diff > 0).mean() <= 1e-4


def test_salt_pepper_from_uniforms_matches_the_kernel_body():
    """pallas_degrade.py:52-63 in numpy, masks broadcast over channels."""
    img = _img((96, 64, 3), 5)
    us, up = _uniforms((96, 64, 1), 6), _uniforms((96, 64, 1), 7)
    want = np.where(us < np.float32(0.2), 255.0, img)
    want = np.where(up < np.float32(0.1), 0.0, want)
    got = fd.salt_pepper_from_uniforms(torch.from_numpy(img),
                                       torch.from_numpy(us),
                                       torch.from_numpy(up), 0.2, 0.1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 9, 3), (5, 3, 1)])
def test_counter_layout(shape):
    """Gaussian: element e takes words (0, 1) or (2, 3) of counter
    (e // 2, 0, 0, 0); salt and pepper: pixel (h, w) takes words 0 and 1 of
    counter (h * W + w, 1, 0, 0). Odd element counts included."""
    img = torch.from_numpy(_img(shape, 8))
    seed = -5  # key (2**32 - 5, 0)
    key = (2 ** 32 - 5, 0)
    n = img.numel()
    u1, u2 = [], []
    for e in range(n):
        words = fd.uniform_from_bits(fd.philox4x32_10(
            torch.tensor([[e // 2, 0, 0, 0]]), key))[0]
        u1.append(words[2 * (e % 2)])
        u2.append(words[2 * (e % 2) + 1])
    want = fd.gaussian_from_uniforms(img.reshape(-1), torch.stack(u1),
                                     torch.stack(u2), 0.4).view(shape)
    torch.testing.assert_close(fd.fused_add_gaussian_noise(img, seed, 0.4),
                               want, rtol=0, atol=0)
    h, w, _ = shape
    ctr = torch.tensor([[i, 1, 0, 0] for i in range(h * w)])
    u = fd.uniform_from_bits(fd.philox4x32_10(ctr, key)).view(h, w, 4)
    want = fd.salt_pepper_from_uniforms(img, u[..., :1], u[..., 1:2], 0.3,
                                        0.3)
    torch.testing.assert_close(
        fd.fused_add_salt_pepper_noise(img, seed, 0.3, 0.3), want, rtol=0,
        atol=0)


@pytest.mark.parametrize("fn,kw", [
    (fd.fused_add_gaussian_noise, dict(std=0.2)),
    (fd.fused_add_salt_pepper_noise, dict(s=0.05, p=0.05)),
])
def test_deterministic_seed_sensitive_and_rows_differ(fn, kw):
    """tests/test_pallas.py:35-48, for both functions: one seed gives one
    image, another seed another, and rows 0-255 do not repeat in rows
    256-511 (the TPU kernel's row tiles)."""
    img = torch.full((512, 128, 3), 100.0)
    a, b, c = fn(img, 1, **kw), fn(img, 1, **kw), fn(img, 2, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[:256], a[256:])


def test_gaussian_statistics():
    """tests/test_pallas.py:25-32."""
    out = fd.fused_add_gaussian_noise(torch.full((64, 128, 3), 128.0), 7,
                                      std=0.1).numpy()
    assert out.shape == (64, 128, 3) and out.dtype == np.float32
    assert out.min() >= 0 and out.max() <= 255
    assert np.all(out == np.floor(out))
    assert 20 < out.std() < 32
    assert abs(out.mean() - 128) < 3


def test_salt_pepper_statistics():
    """tests/test_pallas.py:51-63: channel-shared masks, rates near s and
    p, untouched pixels unchanged."""
    out = fd.fused_add_salt_pepper_noise(torch.full((128, 128, 3), 128.0), 5,
                                         s=0.05, p=0.05).numpy()
    is_salt, is_pepper = out == 255, out == 0
    assert np.all(is_salt.all(-1) == is_salt.any(-1))
    assert np.all(is_pepper.all(-1) == is_pepper.any(-1))
    assert 0.02 < is_salt[..., 0].mean() < 0.08
    assert 0.02 < is_pepper[..., 0].mean() < 0.08
    untouched = ~is_salt[..., 0] & ~is_pepper[..., 0]
    assert np.all(out[untouched] == 128.0)


def test_gaussian_statistics_match_tpusr_xla_noise():
    img = np.full((64, 128, 3), 128.0, np.float32)
    ours = fd.fused_add_gaussian_noise(torch.from_numpy(img), 11,
                                       std=0.1).numpy()
    theirs = np.asarray(jax_add_gaussian_noise(jax.random.key(11),
                                               jnp.asarray(img), std=0.1))
    assert abs(ours.mean() - theirs.mean()) < 0.6
    assert abs(ours.std() - theirs.std()) < 0.6


def test_uint8_input_and_launch_counts_on_the_cpu():
    """A uint8 image is read as f32; the CPU path runs the plain version
    and counts no launch."""
    img = np.random.default_rng(9).integers(0, 256, (6, 5, 3), np.uint8)
    before = dict(fd.LAUNCHES)
    got = fd.fused_add_salt_pepper_noise(torch.from_numpy(img), 4, 0.5, 0.5)
    want = fd.fused_add_salt_pepper_noise_reference(
        torch.from_numpy(img.astype(np.float32)), 4, 0.5, 0.5)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert fd.LAUNCHES == before


@pytest.mark.parametrize("image,seed,err", [
    (torch.zeros(4, 4), 0, "must be \\(H, W, C\\)"),
    (torch.zeros(0, 4, 3), 0, "must be \\(H, W, C\\)"),
    (torch.zeros(4, 4, 3), 2 ** 31, "int32"),
])
def test_rejects_bad_input(image, seed, err):
    with pytest.raises(ValueError, match=err):
        fd.fused_add_gaussian_noise(image, seed)
