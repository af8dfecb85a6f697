"""Generator .pth files travel between tpusr, the reference naming and
tpusr_torch: loads, exports, DDP prefixes, architecture inference. Outputs
are held to tpusr's generator_forward within 1e-5 (f32, as
tests/test_torch_srgan.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_srgan import random_variables
from tpusr.engine.gan import GANTrainConfig as JaxConfig
from tpusr.engine.gan import generator_forward as jax_generator_forward
from tpusr.io import checkpoint as jck
from tpusr_torch.cli.eval_gan import load_generator
from tpusr_torch.engine.gan import GANTrainConfig, generator_forward
from tpusr_torch.io import checkpoint as tck
from tpusr_torch.models.srgan import Generator


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tpusr_pth(tmp_path_factory):
    """A 2-block x8 generator written by tpusr's export, its variables and
    the JAX output on a 12 x 14 LR image."""
    params, stats = random_variables(8, 2, seed=4)
    path = str(tmp_path_factory.mktemp("pth") / "G.pth")
    jck.save_torch_pth(jck.export_torch_generator(
        params, stats, residual_blocks_count=2, n_shuffles=3), path)
    x = np.random.default_rng(5).random((1, 12, 14, 3)).astype(np.float32)
    want = np.asarray(jax_generator_forward(
        params, stats, jnp.asarray(x), JaxConfig(residual_blocks_count=2)))
    return path, x, want


def _forward(g, x, config):
    with torch.no_grad():
        return generator_forward(g, torch.from_numpy(x), config).numpy()


def test_tpusr_export_loads_in_the_port(tpusr_pth):
    path, x, want = tpusr_pth
    g, config = load_generator(path, GANTrainConfig(residual_blocks_count=2),
                               "cpu")
    np.testing.assert_allclose(_forward(g, x, config), want, atol=1e-5)


def test_port_export_loads_in_tpusr(tpusr_pth, tmp_path):
    path, x, want = tpusr_pth
    g, config = load_generator(path, GANTrainConfig(residual_blocks_count=2),
                               "cpu")
    out = str(tmp_path / "sub" / "G2.pth")
    tck.save_torch_pth(tck.export_torch_generator(g.state_dict(), 2, 3), out)
    sd = jck.load_torch_state_dict(out)
    assert sd.keys() == jck.load_torch_state_dict(path).keys()
    params, stats = jck.import_torch_generator(sd, 2, 3)
    got = np.asarray(jax_generator_forward(
        params, stats, jnp.asarray(x), JaxConfig(residual_blocks_count=2)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_ddp_prefix_is_stripped(tpusr_pth, tmp_path):
    path, x, want = tpusr_pth
    sd = torch.load(path, weights_only=True)
    ddp = str(tmp_path / "ddp.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, ddp)
    assert tck.load_torch_state_dict(ddp).keys() == sd.keys()
    g, config = load_generator(ddp, GANTrainConfig(residual_blocks_count=2),
                               "cpu")
    np.testing.assert_allclose(_forward(g, x, config), want, atol=1e-5)


@pytest.mark.parametrize("style", ["reference", "port", "tpusr_tree"])
def test_infer_generator_arch(style):
    if style == "tpusr_tree":
        tree, _ = random_variables(4, 3, seed=1)
    else:
        g = Generator(factor=4, residual_blocks_count=3, device="cpu")
        tree = g.state_dict()
        if style == "reference":
            tree = tck.export_torch_generator(tree, 3, 2)
    assert tck.infer_generator_arch(tree) == (3, 2)
    with pytest.raises(ValueError, match="not a generator checkpoint"):
        tck.infer_generator_arch({"foo.weight": 0})


def test_a_directory_raises(tmp_path):
    """A --model_path directory is read as an orbax checkpoint: one without
    _METADATA, and a zarr3 one, raise with their reasons (an orbax
    directory itself loads: tests/test_torch_orbax.py)."""
    with pytest.raises(ValueError, match="not an orbax checkpoint"):
        load_generator(str(tmp_path), GANTrainConfig(), "cpu")
    (tmp_path / "_METADATA").write_text(
        '{"tree_metadata": {}, "use_ocdbt": true, "use_zarr3": true}')
    with pytest.raises(ValueError, match="zarr3"):
        load_generator(str(tmp_path), GANTrainConfig(), "cpu")


def test_checkpoint_arch_overrides_and_factor_mismatch(tpusr_pth):
    path, _, _ = tpusr_pth
    with pytest.warns(UserWarning, match="2 residual blocks"):
        g, config = load_generator(path, GANTrainConfig(), "cpu")
    assert config.residual_blocks_count == 2 and g.blocks == 2
    with pytest.raises(ValueError, match="holds a x8 generator"):
        load_generator(path, GANTrainConfig(factor=4), "cpu")


def test_import_raises_on_a_missing_key(tpusr_pth):
    sd = tck.load_torch_state_dict(tpusr_pth[0])
    del sd["residual_blocks.1.bn2.running_var"]
    with pytest.raises(KeyError, match="running_var"):
        tck.import_torch_generator(sd, 2, 3)
    assert not os.path.isdir(tpusr_pth[0])
