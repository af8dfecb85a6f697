"""tpusr_torch's dense block (kernel C's plain version) against tpusr's.

The port's ``dense_block_reference`` and ``dense_block`` (which runs the
plain version on a CPU tensor) are held to tpusr's ``dense_block_reference``
and to the line-buffer Pallas kernel in interpret mode, with the TPU's lane
and row padding sliced off. The backward, a recompute through the plain
version, is held to ``jax.grad`` of tpusr's line function. Tolerances are
those of tests/test_pallas_dense.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpusr.ops.pallas_dense import dense_block_line
from tpusr.ops.pallas_dense import dense_block_reference as jax_reference
from tpusr_torch.ops import dense_block as db

NF, GC = 64, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    ks = [rng.normal(0, 0.05, (3, 3, NF + i * GC, GC if i < 4 else NF))
          .astype(np.float32) for i in range(5)]
    bs = [rng.normal(0, 0.02, (GC if i < 4 else NF,)).astype(np.float32)
          for i in range(5)]
    return ks, bs


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, (*shape, NF)).astype(
        np.float32)


def _torch(arrays, requires_grad=False):
    return [torch.from_numpy(a).requires_grad_(requires_grad) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _padded_line(x, ks, bs, interpret=True):
    """tpusr's line kernel on x (1, H, W, 64), padded as it wants."""
    _, h, _, _ = x.shape
    hb = max(-(-h // 8) * 8, 16)
    xp = jnp.pad(x, ((0, 0), (0, hb - h), (0, 0), (0, 128 - NF)))
    return dense_block_line(xp, ks, bs, h, interpret=interpret)[:, :h, :, :NF]


@pytest.mark.parametrize("fn", ["dense_block_reference", "dense_block"])
@pytest.mark.parametrize("shape", [(1, 32, 64), (1, 27, 80), (2, 7, 9)])
def test_matches_jax_reference(fn, shape):
    ks, bs = _params()
    x = _x(shape, sum(shape))
    want = np.asarray(jax_reference(jnp.asarray(x), _jax(ks), _jax(bs)))
    with torch.no_grad():
        got = getattr(db, fn)(torch.from_numpy(x), _torch(ks), _torch(bs))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_matches_the_line_kernel_in_interpret_mode():
    ks, bs = _params(1)
    x = _x((1, 16, 64), 2)
    want = np.asarray(_padded_line(jnp.asarray(x), _jax(ks), _jax(bs)))
    counts = dict(db.LAUNCHES)
    with torch.no_grad():
        got = db.dense_block(torch.from_numpy(x), _torch(ks), _torch(bs))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert db.LAUNCHES == counts  # a CPU tensor launches no kernel


def test_backward_matches_jax_grad():
    ks, bs = _params(3)
    x = _x((1, 16, 64), 4)

    def loss_line(x_, ks_, bs_):
        return jnp.sum(_padded_line(x_, ks_, bs_) ** 2)

    want = jax.grad(loss_line, argnums=(0, 1, 2))(
        jnp.asarray(x), _jax(ks), _jax(bs))
    xt, kt, bt = (_torch([x], True)[0], _torch(ks, True), _torch(bs, True))
    db.dense_block(xt, kt, bt).square().sum().backward()
    got = [xt.grad] + [k.grad for k in kt] + [b.grad for b in bt]
    for g, w in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=1e-4)


def test_bf16_matches_jax_reference():
    """bf16 rounds at other places in the two (the port rounds c1..c4 and y
    once from f32 with f32 biases; XLA rounds each bf16 op): within 1e-2 of
    the largest entry, about three bf16 steps."""
    ks, bs = _params(5)
    x = _x((1, 20, 24), 6)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_reference(xb, _jax(ks), _jax(bs)), np.float32)
    with torch.no_grad():
        got = db.dense_block(torch.from_numpy(x).bfloat16(), _torch(ks),
                             _torch(bs))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("case", ["channels", "kernel", "bias", "count"])
def test_rejects_bad_shapes(case):
    ks, bs = _torch(_params()[0]), _torch(_params()[1])
    x = torch.zeros(1, 4, 4, NF)
    if case == "channels":
        x = torch.zeros(1, 4, 4, 32)
    elif case == "kernel":
        ks[2] = ks[2][:, :, :64]
    elif case == "bias":
        bs[4] = bs[4][:32]
    else:
        ks = ks[:4]
    with pytest.raises(ValueError, match="dense_block"):
        db.dense_block(x, ks, bs)
