"""The numerics that kernels A and B rest on in f32: 3xTF32.

On the card the f32 kernels split each operand once, big = tf32(a) and
small = tf32(a - big) with ``cvt.rna.tf32.f32`` (round to nearest, ties
away from zero, 10 stored mantissa bits), and accumulate small*big +
big*small + big*big on the tensor cores in f32. Here the rounding is
emulated on the bits of f32 tensors and the three products run through
PyTorch's conv on the CPU, against the same conv in f64.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F


def tf32_rna(x):
    """cvt.rna.tf32.f32: add half of the 13 dropped bits' weight to the
    magnitude, then drop them (sign-magnitude, so ties go away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def _operands(seed, size=32, c=128):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, c, size, size),
                                             dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((c, c, 3, 3)) * 0.03)
                         .astype(np.float32))
    return x, w


def _rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max())


def test_tf32_rounding_keeps_eleven_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -12, 3.0e-30, -7.25], dtype=torch.float32)
    r = tf32_rna(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    # a tie rounds away from zero; 1 + 2^-10 is a TF32 number
    assert r.tolist()[:5] == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                              -(1.0 + 2 ** -10), 1.0 + 2 ** -10]
    big, small = split(torch.randn(10_000, generator=torch.Generator()
                                   .manual_seed(0)))
    v = big.double() + small.double()
    ref = (big + small).double()
    assert float(((v - ref).abs() / ref.abs()).max()) < 2 ** -21


@pytest.mark.parametrize("acc", [torch.float64, torch.float32])
def test_three_tf32_products_hold_f32_accuracy_in_a_conv(acc):
    """A 3x3, 128 -> 128 conv at 32^2 from the split operands stays within
    1e-5 of f64 (the f32 kernels' gate is 1e-4), whether the three products
    are summed in f64 or, as the tensor cores do, in f32; each TF32 product
    is exact in f32 (11 x 11 significant bits)."""
    x, w = _operands(0)
    ref = F.conv2d(x.double(), w.double(), padding=1)
    (xb, xs), (wb, ws) = split(x), split(w)
    y = sum(F.conv2d(a.to(acc), b.to(acc), padding=1)
            for a, b in ((xs, wb), (xb, ws), (xb, wb)))
    assert _rel(y, ref) < 1e-5


def test_one_tf32_product_does_not():
    """Plain TF32 (big*big alone) misses the 1e-4 gate of the f32 kernels,
    which is why they take three products."""
    x, w = _operands(1)
    ref = F.conv2d(x.double(), w.double(), padding=1)
    y = F.conv2d(tf32_rna(x).double(), tf32_rna(w).double(), padding=1)
    assert _rel(y, ref) > 1e-4
