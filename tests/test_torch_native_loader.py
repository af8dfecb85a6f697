"""tpusr_torch's native (C++/libpng) loader, byte for byte, on the CPU.

Its decode and bicubic resize must equal PIL's and tpusr's own native
loader exactly (RGB, grayscale and odd-sized PNGs), and ``get_image_pair``
must give the same arrays through the native route, through PIL and in
tpusr. Exact equality everywhere: the loader is a host path with the
reference's bytes, or it is not used.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from tpusr_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(not native.available(),
                                reason=f"native loader {native.status()}")


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """(array, path) of an RGB, a grayscale and an odd-sized RGB PNG."""
    rng = np.random.default_rng(42)
    root = tmp_path_factory.mktemp("png")
    out = {}
    for name, arr, mode in (
            ("rgb", rng.integers(0, 256, (137, 201, 3), np.uint8), "RGB"),
            ("gray", rng.integers(0, 256, (50, 61), np.uint8), "L"),
            ("odd", rng.integers(0, 256, (1, 7, 3), np.uint8), "RGB")):
        path = str(root / f"{name}.png")
        Image.fromarray(arr, mode=mode).save(path)
        out[name] = (arr, path)
    return out


@pytest.mark.parametrize("name", ["rgb", "gray", "odd"])
def test_decode_matches_pil_and_tpusr(pngs, name):
    from tpusr import native as jax_native

    _, path = pngs[name]
    got = native.decode_png(path)
    np.testing.assert_array_equal(got,
                                  np.array(Image.open(path).convert("RGB")))
    if jax_native.available():
        np.testing.assert_array_equal(got, jax_native.decode_png(path))


@pytest.mark.parametrize("oh,ow", [(68, 100), (137, 402), (274, 100),
                                   (17, 25), (137, 201), (3, 1)])
def test_resize_matches_pil_and_tpusr(pngs, oh, ow):
    from tpusr import native as jax_native

    arr, _ = pngs["rgb"]
    got = native.resize_bicubic_u8(arr, oh, ow)
    np.testing.assert_array_equal(got, np.array(
        Image.fromarray(arr).resize((ow, oh), Image.BICUBIC)))
    if jax_native.available():
        np.testing.assert_array_equal(
            got, jax_native.resize_bicubic_u8(arr, oh, ow))


@pytest.mark.parametrize("hw", [(257, 321), (64, 83)])
@pytest.mark.parametrize("downsample", [False, True])
def test_get_image_pair_native_equals_pil_and_tpusr(tmp_path, monkeypatch,
                                                     hw, downsample):
    """The whole chain, with LR noise on: the native route, the PIL route
    and tpusr's get_image_pair give the same arrays."""
    from tpusr.data.div2k import DatasetConfig as JaxConfig
    from tpusr.data.div2k import get_image_pair as jax_pair
    from tpusr_torch.data.div2k import DatasetConfig, get_image_pair

    rng = np.random.default_rng(3)
    (tmp_path / "HR").mkdir()
    (tmp_path / "LR").mkdir()
    hr = rng.integers(0, 256, hw + (3,), np.uint8)
    Image.fromarray(hr).save(tmp_path / "HR" / "0001.png")
    Image.fromarray(hr).resize((hw[1] // 8, hw[0] // 8), Image.BICUBIC).save(
        tmp_path / "LR" / "0001x8.png")
    kw = dict(LR_dir=str(tmp_path / "LR"), HR_dir=str(tmp_path / "HR"),
              scale_factor=8, downsample=downsample,
              noise_type={"type": "Gaussian", "std": 0.05})
    nat = get_image_pair(DatasetConfig(**kw), "0001.png",
                         np.random.default_rng(0))
    want = jax_pair(JaxConfig(**kw), "0001.png", np.random.default_rng(0))
    monkeypatch.setattr(native, "available", lambda: False)
    pil = get_image_pair(DatasetConfig(**kw), "0001.png",
                         np.random.default_rng(0))
    for a, b, c in zip(nat[:2], pil[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert nat[2] == pil[2] == want[2] == "0001"


def test_switch_off_keeps_the_pil_path():
    """TPUSR_NATIVE_LOADER=off: unavailable, with the reason; the library
    is keyed on its source (tpusr_torch/_build/loader-<hash>.so)."""
    env = dict(os.environ, TPUSR_NATIVE_LOADER="off")
    proc = subprocess.run(
        [sys.executable, "-c", "from tpusr_torch import native; "
         "print(native.available(), native.status())"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert proc.stdout.strip() == \
        "False unavailable: TPUSR_NATIVE_LOADER=off", proc.stderr
    assert native.status() == "built"
    path = native._lib_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "tpusr_torch",
                                                 "_build")
