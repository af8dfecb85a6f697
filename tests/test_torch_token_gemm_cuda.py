"""ops/token_gemm.py's kernel against its plain chain — needs an NVIDIA card.

Marked ``cuda``: each test skips without a card. The kernel runs the four
products of a SwinIR-M layer on the benchmark's frame (130,560 tokens of a
272 x 480 image): 180 -> 540 + bias (qkv), 180 -> 180 + bias + residual
(proj), 180 -> 360 + bias then GELU (fc1), 360 -> 180 + bias + residual
(fc2), and at ragged token counts: an odd count, whose last tile ends 8
bytes past a 16-byte boundary (the kernel moves those 8 bytes by hand),
two 24 x 40 images as (2, 960, 180) tokens, one token, 65 tokens. Against
the plain chain in f64 on the same values (bf16 values are exact in f64):
max |kernel - plain| / max |plain| under 1e-2 and the rms of the error over
the rms of the plain output under 5e-3 (the kernel rounds its f32 result
to bf16 once, 2^-9 relative at most). Each planted fault must read above
the limits: K's tail dropped (columns 176-179 at K = 180, 352-359 at 360,
the k-step that runs past K), the residual left out, the bias left out, and
A read one row off. On a machine with a card, without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_token_gemm_cuda.py
"""

import pytest
import torch

from tpusr_torch.ops import token_gemm as tg

pytestmark = pytest.mark.cuda

FRAME = 272 * 480  # tokens of the benchmark's padded frame
# (K, N, epilogue): qkv, proj, fc1, fc2
PRODUCTS = [(180, 540, "bias"), (180, 180, "residual"), (180, 360, "gelu"),
            (360, 180, "residual")]
REL, RMS = 1e-2, 5e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(lead, k, n, epi, gen):
    """x N(0, 1), weight U(+-1/sqrt(K)) as nn.Linear's, bias and residual
    N(0, 1), so that leaving either out moves the output."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = rnd(*lead, k).bfloat16()
    w = ((torch.rand((n, k), generator=gen, device="cuda") * 2 - 1)
         / k ** 0.5).bfloat16()
    b = rnd(n).bfloat16()
    res = rnd(*lead, n).bfloat16() if epi == "residual" else None
    return x, w, b, res


def _plain(x, w, b, res, epi):
    return tg.token_linear_reference(
        x.double(), w.double(), b.double(),
        None if res is None else res.double(), epi == "gelu")


def _measures(got, want):
    d = got.double() - want
    return (float(d.abs().max() / want.abs().max()),
            float(d.square().mean().sqrt() / want.square().mean().sqrt()))


def _kernel(x, w, b, res, epi):
    return tg.token_linear(x, w, b, residual=res, gelu=epi == "gelu",
                           packed=tg.pack(w, epi))


def _run(x, w, b, res, epi):
    before = tg.LAUNCHES["token_gemm"]
    got = _kernel(x, w, b, res, epi)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["token_gemm"] == before + 1
    assert got.shape == (*x.shape[:-1], w.shape[0])
    assert got.dtype == torch.bfloat16
    return got


@pytest.mark.parametrize("k,n,epi", PRODUCTS)
def test_the_cell_shapes_match_f64(gen, k, n, epi):
    x, w, b, res = _operands((FRAME,), k, n, epi, gen)
    got = _run(x, w, b, res, epi)
    rel, rms = _measures(got, _plain(x, w, b, res, epi))
    print(f"{FRAME} x {k} -> {n} {epi}: rel {rel:.3e} rms {rms:.3e}")
    assert rel < REL and rms < RMS, (rel, rms)


@pytest.mark.parametrize("lead", [(1919,), (2, 960), (1,), (65,)])
@pytest.mark.parametrize("k,n,epi", PRODUCTS)
def test_ragged_token_counts_match_f64(gen, lead, k, n, epi):
    x, w, b, res = _operands(lead, k, n, epi, gen)
    got = _run(x, w, b, res, epi)
    rel, rms = _measures(got, _plain(x, w, b, res, epi))
    print(f"{lead} x {k} -> {n} {epi}: rel {rel:.3e} rms {rms:.3e}")
    assert rel < REL and rms < RMS, (rel, rms)


FAULTS = [(k, n, epi, f) for k, n, epi in PRODUCTS
          for f in ("k_tail", "bias", "row_shift")
          ] + [(k, n, epi, "residual") for k, n, epi in PRODUCTS
               if epi == "residual"]


@pytest.mark.parametrize("k,n,epi,fault", FAULTS)
def test_planted_faults_fail_the_measures(gen, k, n, epi, fault):
    x, w, b, res = _operands((FRAME,), k, n, epi, gen)
    got = _kernel(x, w, b, res, epi)
    sound = _measures(got, _plain(x, w, b, res, epi))
    if fault == "k_tail":  # the k-step that runs past K, its valid part out
        tail = k - k % 16
        x = x.clone()
        x[:, tail:] = 0
    elif fault == "bias":
        b = torch.zeros_like(b)
    elif fault == "residual":
        res = torch.zeros_like(res)
    else:  # every row's A one row on
        x = torch.roll(x, -1, 0)
    faulty = _measures(got, _plain(x, w, b, res, epi))
    print(f"{fault} {k} -> {n} {epi}: rel {sound[0]:.3e} -> {faulty[0]:.3e}, "
          f"rms {sound[1]:.3e} -> {faulty[1]:.3e}")
    assert faulty[0] > REL and faulty[1] > RMS, faulty


@pytest.mark.parametrize("k,n,epi", PRODUCTS)
def test_the_kernel_is_deterministic_and_takes_its_packing(gen, k, n, epi):
    x, w, b, res = _operands((1919,), k, n, epi, gen)
    a = _kernel(x, w, b, res, epi)
    packed = tg.pack(w, epi)
    c = tg.token_linear(x, w, b, residual=res, gelu=epi == "gelu",
                        packed=packed)
    assert torch.equal(a, c)
    assert torch.equal(a, _kernel(x, w, b, res, epi))


def test_f32_and_plain_take_the_chain(gen):
    x, w, b, res = _operands((130,), 180, 180, "residual", gen)
    before = tg.LAUNCHES["token_gemm"]
    got = tg.token_linear(x.float(), w.float(), b.float(),
                          residual=res.float())
    want = tg.token_linear_reference(x.float(), w.float(), b.float(),
                                     res.float())
    assert torch.equal(got, want)
    got = tg.token_linear(x, w, b, residual=res)  # bf16, nothing packed
    assert torch.equal(got, tg.token_linear_reference(x, w, b, res))
    assert tg.LAUNCHES["token_gemm"] == before


def test_the_wrapper_refuses_what_the_kernel_does_not_take(gen):
    x, w, b, res = _operands((130,), 180, 180, "residual", gen)
    packed = tg.pack(w, "residual")
    with pytest.raises(ValueError, match="16-byte aligned"):
        tg._cuda(x[1:], w, b, res[1:], False, packed)
    with pytest.raises(ValueError, match="instances"):
        tg._cuda(x[:, :176], w[:, :176], b, res, False, packed)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tg._cuda(x, w, b.cpu(), res, False, packed)
