"""ops/window_attention.py's kernel against its plain version — needs an
NVIDIA card.

Marked ``cuda``: each test skips without a card. The kernel runs at
SwinIR-M's shape on the benchmark's frame, (1, 272 * 480, 540) with 6 heads
of 30, and at an odd small one (2 images of 24 x 40, 2 heads of 30), with
and without the shift, against the plain chain in f64 on the same values
(bf16 values are exact in f64). Two measures: max |kernel - plain| /
max |plain|, and the kernel's own part, the largest rms of the error over
the image's 8 x 8 windows over the rms of the plain output (a fault in a
few windows, as the mask's, is a small share of the whole image). f32
(3xTF32) is held at 1e-4; bf16 at 2e-2, since the probabilities enter the
second product rounded to bf16 and the output is stored in bf16 (2^-9
each). Each planted fault must read above the limit in the own-part
measure: the mask dropped, a wrong shift, one head's bias zeroed. On a
machine with a card, without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_window_attention_cuda.py
"""

import pytest
import torch
import torch.nn.functional as F

from tpusr_torch.ops import window_attention as wa

pytestmark = pytest.mark.cuda

# (B, Hp, Wp, heads, hd): SwinIR-M on a 270 x 480 frame padded to 272, and
# a small ragged batch
SHAPES = [(1, 272, 480, 6, 30), (2, 24, 40, 2, 30)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(shape, dtype, gen):
    b, h, w, heads, hd = shape
    qkv = torch.randn((b, h * w, 3 * heads * hd), generator=gen,
                      device="cuda").to(dtype)
    table = torch.randn(((2 * wa.WINDOW - 1) ** 2, heads), generator=gen,
                        device="cuda")
    return qkv, table


def _plain(qkv, table, hw, heads, shift):
    return wa.window_attention_reference(qkv.double(), table.double(), hw,
                                         heads, shift)


def _measures(got, want, hw):
    """(max-relative, own part): see the module's docstring."""
    d, r = got.double() - want, want
    rel = float(d.abs().max() / r.abs().max())
    b, n, c = d.shape
    per_px = d.square().mean(-1).view(b, 1, *hw)
    worst = F.avg_pool2d(per_px, wa.WINDOW).sqrt().max()
    return rel, float(worst / r.square().mean().sqrt())


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_the_kernel_matches_the_plain_chain(gen, shape, dtype, shift):
    qkv, table = _operands(shape, dtype, gen)
    hw, heads = shape[1:3], shape[3]
    before = wa.LAUNCHES["window_attention"]
    got = wa.window_attention(qkv, table, hw, heads, shift)
    torch.cuda.synchronize()
    assert wa.LAUNCHES["window_attention"] == before + 1
    assert got.shape == (shape[0], hw[0] * hw[1], heads * shape[4])
    assert got.dtype == dtype
    rel, own = _measures(got, _plain(qkv, table, hw, heads, shift), hw)
    print(f"{shape} {dtype} shift {shift}: rel {rel:.3e} own {own:.3e}")
    assert rel < TOL[dtype] and own < TOL[dtype], (rel, own)


def _unmasked(qkv, table, hw, heads, shift):
    """The shifted windows without the mask: the plain chain unshifted on
    the rolled image, rolled back."""
    b, n, c3 = qkv.shape
    x = torch.roll(qkv.double().view(b, *hw, c3), (-shift, -shift), (1, 2))
    y = _plain(x.reshape(b, n, c3), table, hw, heads, 0)
    return torch.roll(y.view(b, *hw, -1), (shift, shift), (1, 2)).reshape(
        b, n, -1)


@pytest.mark.parametrize("fault", ["mask", "shift", "bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_planted_faults_fail_the_measure(gen, shape, dtype, fault):
    qkv, table = _operands(shape, dtype, gen)
    hw, heads = shape[1:3], shape[3]
    got = wa.window_attention(qkv, table, hw, heads, 4)
    sound = _measures(got, _plain(qkv, table, hw, heads, 4), hw)
    if fault == "mask":  # against the shifted windows without the mask
        want = _unmasked(qkv, table, hw, heads, 4)
    elif fault == "shift":  # against the windows shifted by 2
        want = _plain(qkv, table, hw, heads, 2)
    else:  # the kernel with head 1's bias zeroed
        zeroed = table.clone()
        zeroed[:, 1] = 0.0
        got = wa.window_attention(qkv, zeroed, hw, heads, 4)
        want = _plain(qkv, table, hw, heads, 4)
    faulty = _measures(got, want, hw)
    print(f"{fault} {shape} {dtype}: own {sound[1]:.3e} -> {faulty[1]:.3e}, "
          f"rel {sound[0]:.3e} -> {faulty[0]:.3e}")
    assert faulty[1] > TOL[dtype], faulty


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernel_is_deterministic(gen, dtype):
    qkv, table = _operands(SHAPES[1], dtype, gen)
    a = wa.window_attention(qkv, table, SHAPES[1][1:3], 2, 4)
    b = wa.window_attention(qkv, table, SHAPES[1][1:3], 2, 4)
    assert torch.equal(a, b)


def test_the_wrapper_refuses_what_the_kernel_does_not_take(gen):
    qkv, table = _operands(SHAPES[1], torch.float32, gen)
    with pytest.raises(ValueError, match="whole 8 x 8 windows"):
        wa.window_attention(qkv, table, (20, 48), 2, 0)
    with pytest.raises(ValueError, match="shift"):
        wa.window_attention(qkv, table, (24, 40), 2, 8)
    with pytest.raises(ValueError, match="dtype"):
        wa.window_attention(qkv.half(), table, (24, 40), 2, 0)
