"""The CUDA kernels against their plain versions — needs an NVIDIA card.

Marked ``cuda``: each test skips without a card. On a machine with one,
run them without the JAX conftest (the port needs no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from tpusr_torch.ops import fused_conv as fc

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    """A card-side generator; the plain versions' cuDNN convs in full f32
    (PyTorch's default lets them round through TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cudnn.allow_tf32 = True


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-12))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 7, 9, 5, 6), (2, 33, 70, 132, 128),
                                   (1, 2, 2, 16, 64)])
@pytest.mark.parametrize("reflect", [True, False])
def test_kernels_match_plain_versions(gen, dtype, tol, shape, reflect):
    n, h, w, cin, cout = shape

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    x = rnd(n, h, w, cin).to(dtype)
    wt = (rnd(3, 3, cin, cout) * 0.1).to(dtype)
    es, eb = rnd(cin).abs() + 0.5, rnd(cin) * 0.1
    base, g = rnd(n, h, w, cout).to(dtype), rnd(n, h, w, cout).to(dtype)
    # the plain side: the same values, f32 ones in f64 (exact sums)
    xp, wp, bp, gp = (t.double() if dtype == torch.float32 else t
                      for t in (x, wt, base, g))
    before = dict(fc.LAUNCHES)
    y, st = fc.fused_conv3x3_fwd(x, wt, es, eb, base, act="leaky_relu",
                                 reflect=reflect, stats=True)
    yr, sr = fc.fused_conv3x3_fwd_reference(xp, wp, es, eb, bp,
                                            act="leaky_relu",
                                            reflect=reflect, stats=True)
    dw = fc.fused_conv3x3_wgrad(x, g, es, eb, act="leaky_relu",
                                reflect=reflect)
    dwr = fc.fused_conv3x3_wgrad_reference(xp, gp, es, eb, act="leaky_relu",
                                           reflect=reflect)
    torch.cuda.synchronize()
    assert _rel(y, yr) < tol and _rel(st, sr) < tol and _rel(dw, dwr) < tol
    assert fc.LAUNCHES["fused_conv3x3_fwd"] == before["fused_conv3x3_fwd"] + 1
    assert (fc.LAUNCHES["fused_conv3x3_wgrad"]
            == before["fused_conv3x3_wgrad"] + 1)


def test_autograd_on_the_card_matches_the_cpu(gen):
    """The Function's backward (dgrad + wgrad kernels, reflect folds,
    prologue backward) on the card against the same Function on the CPU."""
    x = torch.randn(1, 19, 23, 40, generator=gen, device="cuda")
    w = torch.randn(3, 3, 40, 24, generator=gen, device="cuda") * 0.1
    es = torch.rand(40, generator=gen, device="cuda") + 0.5
    eb = torch.randn(40, generator=gen, device="cuda") * 0.1
    base = torch.randn(1, 19, 23, 24, generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (x, w, es, eb, base)]
        y, st = fc.fused_conv3x3(*leaves[:4], act="leaky_relu",
                                 pad_mode="reflection", stats=True,
                                 base=leaves[4])
        (0.5 * y.square().sum() + 0.1 * st[0].sum()
         + 0.01 * st[1].sum()).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _rel(a, b) < 1e-4


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x = torch.randn(1, 8, 8, 4, generator=gen, device="cuda")
    w = torch.randn(3, 3, 4, 4, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_conv3x3_fwd(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="dtype"):
        fc.fused_conv3x3_fwd(x.half(), w.half())
    with pytest.raises(ValueError, match="w must be"):
        fc.fused_conv3x3_fwd(x, w[:, :, :3].contiguous())
