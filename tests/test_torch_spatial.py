"""tpusr_torch's exact tiled SRGAN inference against tpusr's, on the CPU.

A 2-block x8 generator with seeded weights and running statistics goes
through both packages (load_flax_generator carries the weights); LR heights
that the tile count does not divide, so cores and windows are ragged and
edge windows shift inward. Within 1e-5 of tpusr's tiled forward and of the
port's whole-image forward.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_srgan import random_variables
from tpusr.engine.gan import GANTrainConfig as JaxConfig
from tpusr.parallel import spatial as jsp
from tpusr_torch.engine.gan import (GANTrainConfig, build_generator,
                                    generator_forward)
from tpusr_torch.io.weights import load_flax_generator
from tpusr_torch.parallel import spatial


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def nets():
    params, stats = random_variables(8, 2, seed=3)
    config = GANTrainConfig(factor=8, residual_blocks_count=2)
    g = build_generator(config, "cpu")
    load_flax_generator(g, params, stats)
    return g, config, params, stats


@pytest.mark.parametrize("h,w,n_tiles,halo", [(70, 5, 3, None),
                                              (50, 7, 3, 6), (10, 9, 4, 3)])
def test_tiled_forward_matches_tpusr_and_the_whole_image(nets, h, w,
                                                         n_tiles, halo):
    g, config, params, stats = nets
    lr = np.random.default_rng(h).uniform(-1, 1, (1, h, w, 3)).astype(
        np.float32)
    with torch.inference_mode():
        got = spatial.tiled_generator_forward(
            g, torch.from_numpy(lr), config, n_tiles=n_tiles, halo=halo)
        whole = generator_forward(g, torch.from_numpy(lr), config)
    want = jsp.tiled_generator_forward(
        params, stats, jnp.asarray(lr), JaxConfig(factor=8,
                                                  residual_blocks_count=2),
        n_tiles=n_tiles, halo=halo)
    assert got.shape == (1, 8 * h, 8 * w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if halo is None or halo >= spatial.generator_receptive_halo(config):
        np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5,
                                   rtol=0)
    assert spatial.generator_receptive_halo(config) == \
        jsp.generator_receptive_halo(JaxConfig(residual_blocks_count=2))
