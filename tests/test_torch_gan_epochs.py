"""tpusr_torch's on-device epoch trainer against tpusr's pieces, on the CPU.

``crop_at`` at tpusr's offsets gives tpusr's ``_crop_pair`` patches
exactly (uint8 / 255 in f32), legacy_scale both ways; the offsets drawn
stay in tpusr's range; ``stack_dataset_for_device`` equals tpusr's; and
``gan_train_epochs`` over 2 epochs equals a loop of ``gan_train_step``
over the same crops, losses and metrics exactly (one process, one thread:
the same operations in the same order).
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusr.engine.gan_epochs import _crop_pair as jax_crop_pair
from tpusr.engine.gan_epochs import \
    stack_dataset_for_device as jax_stack_dataset
from tpusr_torch.engine import gan as pg
from tpusr_torch.engine.gan_epochs import (_crop_pair, crop_at, draw_offsets,
                                           gan_train_epochs,
                                           stack_dataset_for_device)
from tpusr_torch.engine.metrics import psnr


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _stacks(n=4, lh=12, lw=14, f=4, seed=0):
    rng = np.random.default_rng(seed)
    lr = rng.integers(0, 256, (n, lh, lw, 3), dtype=np.uint8)
    hr = rng.integers(0, 256, (n, lh * f, lw * f, 3), dtype=np.uint8)
    valid = np.array([[lh, lw], [lh - 3, lw], [lh, lw - 5], [8, 9]][:n],
                     np.int32)
    return lr, hr, valid


@pytest.mark.parametrize("legacy_scale", [False, True])
def test_crop_at_matches_tpusr(legacy_scale):
    lr, hr, valid = _stacks()
    p, f = 8, 4
    keys = jax.random.split(jax.random.key(5), len(lr))
    want_lr, want_hr = jax.vmap(partial(
        jax_crop_pair, lr_patch=p, factor=f, legacy_scale=legacy_scale))(
        jnp.asarray(lr), jnp.asarray(hr), jnp.asarray(valid), keys)
    tops, lefts = [], []  # tpusr's draws, as its _crop_pair makes them
    for k, (vh, vw) in zip(keys, valid):
        kx, ky = jax.random.split(k)
        lefts.append(int(jax.random.randint(kx, (), 0, max(vw - p, 1))))
        tops.append(int(jax.random.randint(ky, (), 0, max(vh - p, 1))))
    got_lr, got_hr = crop_at(torch.from_numpy(lr), torch.from_numpy(hr),
                             torch.tensor(tops), torch.tensor(lefts), p, f,
                             legacy_scale)
    np.testing.assert_array_equal(got_lr.numpy(), np.asarray(want_lr))
    np.testing.assert_array_equal(got_hr.numpy(), np.asarray(want_hr))


def test_offsets_stay_in_range():
    valid = torch.tensor([[12, 14], [8, 8], [9, 30]] * 200)
    gen = torch.Generator().manual_seed(0)
    top, left = draw_offsets(valid, 8, gen)
    high = torch.clamp(valid - 8, min=1)
    assert bool(((top >= 0) & (top < high[:, 0])).all())
    assert bool(((left >= 0) & (left < high[:, 1])).all())
    assert int(left[2::3].max()) == 21 and int(top[1::3].max()) == 0


class _Dataset:
    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.items = []
        for i, (h, w) in enumerate([(10, 12), (8, 14), (11, 9)]):
            lr = rng.random((h, w, 3)).astype(np.float32)
            hr = rng.random((4 * h, 4 * w, 3)).astype(np.float32)
            if i == 1:
                lr = (lr * 255).astype(np.uint8)
                hr = (hr * 255).astype(np.uint8)
            self.items.append((lr, hr, f"{i:04d}"))

    def __len__(self):
        return len(self.items)

    def base_pair(self, i):
        return self.items[i]


def test_stack_dataset_matches_tpusr():
    ds = _Dataset()
    got, want = stack_dataset_for_device(ds, 2), jax_stack_dataset(ds, 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[0] == 4  # wrapped to a multiple of the batch


def test_epochs_equal_a_loop_of_steps():
    cfg = pg.GANTrainConfig(factor=4, batch_size=2, hr_patch=32,
                            residual_blocks_count=2)
    state = pg.create_gan_state(cfg, 1e-4, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    twin = copy.deepcopy(state)
    lr, hr, valid = (torch.from_numpy(a) for a in _stacks())
    state, logs = gan_train_epochs(state, lr, hr, valid,
                                   torch.Generator().manual_seed(7), cfg,
                                   n_epochs=2)
    gen = torch.Generator().manual_seed(7)
    losses, psnrs = [], []
    for epoch in range(2):
        for s in range(2):
            sl = slice(2 * s, 2 * s + 2)
            lo, hi = _crop_pair(lr[sl], hr[sl], valid[sl], gen, 8, 4)
            twin, step_logs = pg.gan_train_step(twin, lo, hi, cfg)
            losses.append((float(step_logs["loss_D"]),
                           float(step_logs["loss_G"])))
            if epoch == 0:
                with torch.no_grad():
                    psnrs.append(float(psnr(pg.generator_forward(
                        twin.G, lo, cfg, train=True), hi)))
    assert logs["losses_D"].shape == logs["losses_G"].shape == (2, 2)
    assert [(float(d), float(g)) for d, g in zip(
        logs["losses_D"].flatten(), logs["losses_G"].flatten())] == losses
    assert float(logs["psnr"]) == pytest.approx(np.mean(psnrs), rel=1e-6)
    assert np.isnan(float(logs["lpips"])) and np.isfinite(float(logs["ssim"]))
    assert state.step == twin.step == 4
    for k, v in state.G.state_dict().items():
        assert torch.equal(v, twin.G.state_dict()[k]), k
