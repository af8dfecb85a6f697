"""ops/token_gemm.py: SwinIR's token linears, on the CPU.

Without packed weights ``token_linear`` runs its plain twin, which must be
the chain the Swin layer ran before the kernel (``F.linear``, ``F.gelu``,
``+``) bit for bit in f32 and bf16, for the four products' epilogues and
for a whole Swin layer. The card's route through the model is held here
too, with the kernel's launcher replaced by an f64 version of its contract
that reads the weights only through ``pack``'s layout: a bf16 SwinIR-M
frame ('auto') makes 144 calls (4 a layer, 36 layers), each with weights
packed once a forward, and gives the chain's numbers to bf16 rounding;
'off', f32 and plain CPU tensors make none. Then the kernel's profiler name for the
benchmark's trace readers, and what the launcher refuses. The kernel itself
is held to the plain chain on a card (tests/test_torch_token_gemm_cuda.py).
"""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from srbench.tracing import is_glue, port_kernel
from tpusr_torch.models import swinir
from tpusr_torch.ops import token_gemm as tg

CSRC = Path(tg.__file__).parent.parent / "csrc" / "token_gemm.cu"
# (K, N, epilogue) of a layer at SwinIR-M's widths: qkv, proj, fc1, fc2
PRODUCTS = [(180, 540, "bias"), (180, 180, "residual"), (180, 360, "gelu"),
            (360, 180, "residual")]
# SwinIR-M's body: 6 x 6 Swin layers at embed 180 (6 heads of 30), the
# widths of the kernel's instances
ARCH = {"embed_dim": 180, "depths": (6,) * 6, "num_heads": (6,) * 6}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rnd(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------------------------ the plain twin
def _chain(x, w, b, res, epi):
    """The Swin layer's chain before the kernel, as it was written."""
    if epi == "residual":
        return res + F.linear(x, w, b)
    if epi == "gelu":
        return F.gelu(F.linear(x, w, b))
    return F.linear(x, w, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,epi", PRODUCTS)
def test_the_twin_is_the_chain(dtype, k, n, epi):
    x = _rnd(2, 37, k, seed=1, dtype=dtype)
    w, b = _rnd(n, k, seed=2, dtype=dtype) / k ** 0.5, _rnd(n, seed=3,
                                                          dtype=dtype)
    res = _rnd(2, 37, n, seed=4, dtype=dtype) if epi == "residual" else None
    tg.reset_launch_counts()
    got = tg.token_linear(x, w, b, residual=res, gelu=epi == "gelu")
    assert _same(got, _chain(x, w, b, res, epi))
    assert tg.LAUNCHES["token_gemm"] == 0


def _old_layer(blk, x, hw, ops):
    """SwinLayer.forward as it was before the kernel."""
    (n1w, n1b, qkv_w, qkv_b, proj_w, proj_b, n2w, n2b, fc1_w, fc1_b,
     fc2_w, fc2_b) = ops
    c = x.shape[-1]
    qkv = F.linear(F.layer_norm(x, (c,), n1w, n1b, swinir.EPS), qkv_w, qkv_b)
    a = swinir.window_attention(qkv, blk.attn.relative_position_bias_table,
                                hw, blk.attn.heads, blk.shift, blk.plain)
    x = x + F.linear(a, proj_w, proj_b)
    y = F.gelu(F.linear(F.layer_norm(x, (c,), n2w, n2b, swinir.EPS), fc1_w,
                        fc1_b))
    return x + F.linear(y, fc2_w, fc2_b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 4])
def test_a_swin_layer_is_the_old_chain(dtype, shift):
    g = torch.Generator().manual_seed(5)
    blk = swinir.SwinLayer(60, 2, 2.0, shift, plain=False, generator=g)
    with torch.no_grad():
        for p in (blk.norm1.weight, blk.norm1.bias, blk.norm2.weight,
                  blk.norm2.bias):  # away from LayerNorm's 1 and 0
            p.add_(torch.randn(p.shape, generator=g) * 0.1)
    ops = [p.detach().to(dtype) for p in blk.operand_leaves()]
    hw = (16, 24)
    x = _rnd(1, hw[0] * hw[1], 60, seed=6, dtype=dtype)
    with torch.no_grad():
        assert _same(blk(x, hw, ops, None), _old_layer(blk, x, hw, ops))


# ------------------------------------------------- the card's route, emulated
def _unpack(packed, n, k):
    """The (N, K) weights from pack()'s layout, read as the kernel reads it:
    packed[s, ks, g, h, r, e] is column s * NR + 8 g + r, k 16 ks + 8 h + e;
    the padding must be zero."""
    splits, ks, ng = packed.shape[:3]
    w = packed.permute(0, 2, 4, 1, 3, 5).reshape(splits * ng * 8, ks * 16)
    assert not w[n:].any() and not w[:, k:].any()
    return w[:n, :k]


class _Emulated:
    """The launcher's contract in f64: one rounding to the output's dtype."""

    def __init__(self):
        self.calls, self.packed = 0, 0

    def __call__(self, x, weight, bias, residual, gelu, packed):
        self.calls += 1
        n, k = weight.shape
        if packed is not None:
            self.packed += 1
            assert _same(_unpack(packed, n, k), weight)
        y = F.linear(x.double(), weight.double(), bias.double())
        if residual is not None:
            y = y + residual.double()
        if gelu:
            y = F.gelu(y)
        return y.to(x.dtype)


@pytest.fixture
def emulated(monkeypatch):
    """The card's route through ops/token_gemm.py on CPU tensors."""
    emu = _Emulated()
    monkeypatch.setattr(tg, "on_kernel",
                        lambda x: x.dtype == torch.bfloat16)
    monkeypatch.setattr(tg, "_cuda", emu)
    return emu


def _frame(net, seed=8):
    lr = torch.rand((1, 3, 12, 20), generator=torch.Generator().manual_seed(
        seed))
    with torch.inference_mode():
        return net(lr)


def _net(dtype, fusion):
    return swinir.SwinIR(upscale=4, dtype=dtype, fusion=fusion, device="cpu",
                         generator=torch.Generator().manual_seed(9), **ARCH)


def test_a_bf16_frame_makes_four_calls_a_layer_with_packed_weights(emulated):
    got = _frame(_net(torch.bfloat16, "auto"))
    assert emulated.calls == emulated.packed == 144 == 4 * sum(ARCH["depths"])
    with pytest.MonkeyPatch.context() as mp:  # the chain on the same net
        mp.setattr(tg, "on_kernel", lambda x: False)
        want = _frame(_net(torch.bfloat16, "auto"))
    assert emulated.calls == 144
    ref = _frame(_net(None, "auto"))
    # the emulated kernel rounds once where the chain rounds two or three
    # times: both stay within bf16's reach of the f32 net
    err = [float((y - ref).abs().max() / ref.abs().max()) for y in (got, want)]
    assert err[0] < 1e-2 and err[1] < 1e-2, err


@pytest.mark.parametrize("dtype,fusion", [(torch.bfloat16, "off"),
                                          (None, "auto")])
def test_off_and_f32_make_no_calls(emulated, dtype, fusion):
    _frame(_net(dtype, fusion))
    assert emulated.calls == 0


def test_cpu_tensors_take_the_chain():
    """Unpatched, a bf16 frame on the CPU launches nothing and packs
    nothing; the launcher refuses a CPU tensor, packed weights and all,
    instead of falling back."""
    tg.reset_launch_counts()
    _frame(_net(torch.bfloat16, "auto"))
    assert tg.LAUNCHES == {"token_gemm": 0}
    x, w, b = (_rnd(*s, dtype=torch.bfloat16) for s in ((64, 180),
                                                        (540, 180), (540,)))
    with pytest.raises(ValueError, match="CUDA"):
        tg._cuda(x, w, b, None, False, tg.pack(w, "bias"))


@pytest.mark.parametrize("k,n,epi", PRODUCTS)
def test_pack_lays_out_the_plan(k, n, epi):
    ks, chunks, splits = tg.PLANS[n, k, epi]
    assert splits * chunks * tg.PRODUCT_COLS >= n > (splits * chunks - 1) \
        * tg.PRODUCT_COLS and ks * 16 >= k > ks * 16 - 16
    w = _rnd(3, n, k, dtype=torch.bfloat16)
    packed = tg.pack(w, epi)  # a stack of three layers at once
    assert packed.shape == (3, splits, ks, chunks * 12, 2, 8, 8)
    for i in range(3):
        assert _same(_unpack(packed[i], n, k), w[i])


# ------------------------------------------------------ the kernel's name
def test_the_kernel_name_reads_as_a_gemm_not_glue():
    """The profiler names token_gemm_kernel's instances as (anonymous
    namespace)::token_gemm_kernel<...>: the benchmark's trace readers
    count it with the library GEMMs it replaces (``is_glue`` false), so
    glue_ms_per_frame.swinir keeps reading LayerNorm and the rest."""
    names = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s+)?"
                       r"(\w+)\(", CSRC.read_text())
    assert names == ["token_gemm_kernel"]
    for inst in ("12, 3, 0", "12, 2, 1", "12, 2, 2", "23, 1, 1"):
        name = f"void (anonymous namespace)::token_gemm_kernel<{inst}>(" \
               f"(anonymous namespace)::Args)"
        assert not is_glue(name) and port_kernel(name) is None


# ------------------------------------------------------ what it refuses
def test_the_launcher_refuses_what_the_kernel_does_not_take():
    bf = torch.bfloat16
    x, w, b = _rnd(130, 180, dtype=bf), _rnd(180, 180, dtype=bf), _rnd(
        180, dtype=bf)
    res = _rnd(130, 180, dtype=bf)
    packed = tg.pack(w, "residual")
    cases = [
        ((x.float(), w.float(), b.float(), res.float()), "bfloat16"),
        ((x.half(), w, b, res), "bfloat16"),
        ((x, w[:, :176], b, res), "do not make"),
        ((x, w, b[:90], res), "do not make"),
        ((x[0], w, b, res), r"\(\.\.\., K\)"),
        ((x[:, :176].contiguous(), w[:, :176].contiguous(), b, res),
         "instances"),
        ((x, w, b, res[:, :90]), "output's"),
        ((x.t().contiguous().t(), w, b, res), "contiguous"),
        ((x[1:], w, b, res[1:]), "16-byte aligned"),
        ((x, w, b, res.t().contiguous().t()), "contiguous"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            tg._cuda(*args, False, packed)
    with pytest.raises(ValueError, match="bfloat16"):
        tg._cuda(x, w, b, res, False, packed.float())
    with pytest.raises(ValueError, match="GELU together"):
        tg._cuda(x, w, b, res, True, packed)
    with pytest.raises(ValueError, match="pack"):  # fc1's layout
        tg._cuda(x, w, b, res, False, tg.pack(torch.cat([w, w]), "gelu"))
    with pytest.raises(ValueError, match="instances"):
        tg.pack(w[:, :176], "residual")
    with pytest.raises(ValueError, match="CUDA"):  # well formed, on the CPU
        tg._cuda(x, w, b, res, False, packed)
