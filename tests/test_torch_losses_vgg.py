"""tpusr_torch's SRGAN losses and VGG19 content path against tpusr's.

The four losses and the perceptual sum within 1e-6; the ImageNet
preprocess (antialiased bilinear resize, centre crop, normalisation) within
1e-5 of its largest output at 192^2 and at 40 x 56; the VGG19 conv stack
on random weights at 2 x 32 x 32 within 1e-5 of the largest activation;
and the weight loaders (npz in tpusr's layout, a torchvision .pth written
here) to tpusr's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr.engine import losses as JL
from tpusr.models import vgg19 as jv
from tpusr_torch.engine import losses as L
from tpusr_torch.models import vgg19 as pv


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return np.asarray(x, np.float64)


def test_losses_match_tpusr():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(0, 1, (2, 8, 8, 3)).astype(np.float32)
            for _ in range(2))
    real, fake = (rng.normal(0, 3, (4, 1)).astype(np.float32)
                  for _ in range(2))
    targets = rng.random((4, 1)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [
        (JL.mse(ja, jb), L.mse(ta, tb)),
        (JL.bce_with_logits(jnp.asarray(real), jnp.asarray(targets)),
         L.bce_with_logits(torch.from_numpy(real), torch.from_numpy(targets))),
        (JL.adversarial_loss(jnp.asarray(fake)),
         L.adversarial_loss(torch.from_numpy(fake))),
        (JL.discriminator_loss(jnp.asarray(real), jnp.asarray(fake)),
         L.discriminator_loss(torch.from_numpy(real), torch.from_numpy(fake))),
        (JL.perceptual_loss(JL.mse, ja, jb, jnp.asarray(fake), 1e-3),
         L.perceptual_loss(L.mse, ta, tb, torch.from_numpy(fake), 1e-3)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert L.make_content_loss(None) is L.mse
    # the stable form at logits where sigmoid saturates in f32
    big = torch.tensor([[60.0], [-60.0]])
    assert float(L.bce_with_logits(big, torch.tensor([[0.0], [1.0]]))) == \
        pytest.approx(60.0)


@pytest.mark.parametrize("shape", [(2, 192, 192, 3), (1, 40, 56, 3)])
def test_preprocess_matches_tpusr(shape):
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jv.vgg_preprocess(jnp.asarray(x)))
    got = pv.vgg_preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _random_npz(path, seed=0):
    rng = np.random.default_rng(seed)
    arrays, cin = {}, 3
    for b, (cout, n) in enumerate(pv._VGG19_BLOCKS, 1):
        for i in range(1, n + 1):
            arrays[f"conv{b}_{i}.kernel"] = rng.normal(
                0, (2.0 / (9 * cin)) ** 0.5, (3, 3, cin, cout)).astype(
                np.float32)
            arrays[f"conv{b}_{i}.bias"] = rng.normal(0, 0.01, cout).astype(
                np.float32)
            cin = cout
    np.savez(path, **arrays)
    return arrays


@pytest.mark.parametrize("upto", ["conv2_2", "conv5_4"])
def test_features_match_tpusr(tmp_path, upto):
    _random_npz(tmp_path / "vgg.npz")
    jp = jv.load_vgg19_npz(str(tmp_path / "vgg.npz"))
    tp = pv.load_vgg19_npz(str(tmp_path / "vgg.npz"))
    x = np.random.default_rng(2).normal(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, v: jv.vgg19_features(p, v, upto))(
        jp, jnp.asarray(x)))
    got = pv.vgg19_features(tp, torch.from_numpy(x), upto).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert pv.vgg19_layer_names() == jv.vgg19_layer_names()


@pytest.mark.parametrize("kind", ["npz", "pth"])
def test_try_load_vgg19(tmp_path, monkeypatch, kind):
    arrays = _random_npz(tmp_path / "vgg.npz", seed=3)
    path = tmp_path / "vgg.npz"
    if kind == "pth":  # a torchvision vgg19 state dict: features.{idx}
        sd, idx = {}, 0
        for b, (_, n) in enumerate(pv._VGG19_BLOCKS, 1):
            for i in range(1, n + 1):
                k = arrays[f"conv{b}_{i}.kernel"]
                sd[f"features.{idx}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
                sd[f"features.{idx}.bias"] = torch.from_numpy(
                    arrays[f"conv{b}_{i}.bias"])
                idx += 2
            idx += 1
        path = tmp_path / "vgg19.pth"
        torch.save(sd, path)
    monkeypatch.setenv(pv.VGG19_WEIGHTS_ENV, str(path))
    got, want = pv.try_load_vgg19(), jv.try_load_vgg19()
    assert got.keys() == want.keys()
    for name, p in want.items():
        np.testing.assert_array_equal(
            got[name]["weight"].numpy(),
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got[name]["bias"].numpy(),
                                      np.asarray(p["bias"]))
    assert L.make_content_loss(got) is not L.mse
    monkeypatch.delenv(pv.VGG19_WEIGHTS_ENV)
    assert pv.try_load_vgg19() is None
