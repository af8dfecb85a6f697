"""ops/bn_act.py's kernels against their plain versions — needs an NVIDIA
card.

Marked ``cuda``: each test skips without a card. Each kernel runs at the
DIP skip net's shapes (512^2, 256^2 and 16^2 at 128 channels, the 512^2
skip branch at 4, and a ragged 27 x 45 batch of 2) against its plain
version: in f64 for the f32 kernels, on the same bf16 values in f64 for
the bf16 ones. The measure is max |kernel - plain| / max |plain|; the
(C,) f32 sums are held at 1e-4 in both dtypes (the bf16 inputs are exact
in f64 and the kernels sum in f32), the bf16 activations at 2e-2. Each
planted fault (LeakyReLU's slope 0.25, one channel's eff_scale zeroed,
one block's partial left out of a sum) must read above the limit. On a
machine with a card, without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_bn_act_cuda.py
"""

import pytest
import torch

from tpusr_torch.ops import bn_act

pytestmark = pytest.mark.cuda

# (N, H, W, C): up0 at 512^2, down0 at 256^2, the deepest level's 16^2,
# the 512^2 skip branch, and a ragged batch
SHAPES = [(1, 512, 512, 128), (1, 256, 256, 128), (1, 16, 16, 128),
          (1, 512, 512, 4), (2, 27, 45, 128)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SUM_TOL = 1e-4  # the f32 sums (moments, des, deb), both dtypes


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def _operands(shape, dtype, gen):
    c = shape[-1]

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    x = (rnd(*shape) * 1.5 + 0.3).to(dtype)
    g = rnd(*shape).to(dtype)
    es, eb = rnd(c).abs() + 0.5, rnd(c) * 0.5
    dm1, dm2 = rnd(c), rnd(c)
    return x, g, es, eb, dm1, dm2


def _plain(x, g, es, eb, dm1, dm2, act, slope=bn_act.SLOPE):
    """Every kernel's function in f64 from the same values (NHWC)."""
    x, g, es, eb, dm1, dm2 = (t.double() for t in (x, g, es, eb, dm1, dm2))
    n = x.numel() // x.shape[-1]
    a = x * es + eb
    leaky = act == "leaky_relu"
    y = torch.where(a < 0, slope * a, a) if leaky else a
    d = torch.where(a < 0, slope * g, g) if leaky else g
    dx_mom = (dm1 + 2 * x * dm2) / n
    return {"m1": x.mean((0, 1, 2)), "m2": x.square().mean((0, 1, 2)),
            "y": y, "dx": d * es, "des": (d * x).sum((0, 1, 2)),
            "deb": d.sum((0, 1, 2)), "dx_moments": dx_mom,
            "dx_folded": dx_mom + d * es}


def _kernels(x, g, es, eb, dm1, dm2, act):
    m1, m2 = bn_act._moments_cuda(x)
    y = bn_act._affine_act_cuda(x, es, eb, act)
    dx, des, deb = bn_act._affine_act_grad_cuda(g, x, es, eb, act, True)
    none, des_r, deb_r = bn_act._affine_act_grad_cuda(g, x, es, eb, act,
                                                      False)
    assert none is None
    return {"m1": m1, "m2": m2, "y": y, "dx": dx, "des": des, "deb": deb,
            "des_reduce": des_r, "deb_reduce": deb_r,
            "dx_moments": bn_act._moments_grad_cuda(x, dm1, dm2),
            "dx_folded": bn_act._moments_grad_cuda(x, dm1, dm2,
                                                   (g, es, eb, act))}


def _errors(got, want, dtype):
    """{name: (measure, limit)}."""
    return {k: (_rel(got[k], want[k]),
                SUM_TOL if got[k].dim() == 1 else TOL[dtype])
            for k in got if k in want}


@pytest.mark.parametrize("act", ["leaky_relu", None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions(gen, shape, dtype, act):
    ops = _operands(shape, dtype, gen)
    before = dict(bn_act.LAUNCHES)
    got = _kernels(*ops, act)
    torch.cuda.synchronize()
    # the reduce-only pass (a folded backward) sums what the full pass does
    assert torch.equal(got.pop("des_reduce"), got["des"])
    assert torch.equal(got.pop("deb_reduce"), got["deb"])
    bad = {k: v for k, v in _errors(got, _plain(*ops, act), dtype).items()
           if not v[0] < v[1]}
    assert not bad
    assert {k: n - before[k] for k, n in bn_act.LAUNCHES.items()} == {
        "channel_moments": 1, "affine_act": 1, "affine_act_grad": 2,
        "moments_grad": 2, "partials_sum": 3}


def _dropped_block(x, what):
    """The sum over the pixels of block 0 of a reduction's grid, which a
    partial left out would lose: block b visits pixels p with
    (p // by) % grid_x == b (the kernels' Place)."""
    p, c = x.numel() // x.shape[-1], x.shape[-1]
    vec = bn_act.vec_width(c, x.dtype, x.data_ptr())
    bx, gx = bn_act.launch_geometry(
        p, c, vec, torch.cuda.get_device_properties(x.device)
        .multi_processor_count)
    rows = torch.arange(p, device=x.device)
    mask = ((rows // (bn_act.NTHREADS // bx)) % gx == 0).view(x.shape[:-1])
    return what.double()[mask].sum(0)


@pytest.mark.parametrize("fault", ["slope", "es0", "drop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[4]])
def test_planted_faults_fail_the_measure(gen, shape, dtype, fault):
    """Each fault reads above its limit on the numbers it touches: the
    slope on y and the gradients (affine_act, affine_act_grad,
    moments_grad), a zeroed eff_scale on y and dx, a dropped partial on the
    moments and on des / deb (channel_moments, affine_act_grad,
    partials_sum)."""
    x, g, es, eb, dm1, dm2 = _operands(shape, dtype, gen)
    act = "leaky_relu"
    got = _kernels(x, g, es, eb, dm1, dm2, act)
    want = _plain(x, g, es, eb, dm1, dm2, act)
    sound = _errors(got, want, dtype)
    if fault == "slope":  # the kernels' results against slope 0.25
        want = _plain(x, g, es, eb, dm1, dm2, act, slope=0.25)
        touched = ("y", "dx", "des", "deb", "dx_folded")
    elif fault == "es0":  # the kernels run with channel 1's scale zeroed
        es0 = es.clone()
        es0[1] = 0.0
        got = _kernels(x, g, es0, eb, dm1, dm2, act)
        touched = ("y", "dx", "dx_folded")
    else:  # block 0's partial left out of the sums
        n = x.numel() // x.shape[-1]
        xd, gd = x.double(), g.double()
        a = xd * es.double() + eb.double()
        d = torch.where(a < 0, 0.2 * gd, gd)
        got = dict(got, m1=got["m1"] - _dropped_block(x, xd) / n,
                   m2=got["m2"] - _dropped_block(x, xd.square()) / n,
                   des=got["des"] - _dropped_block(x, d * xd),
                   deb=got["deb"] - _dropped_block(x, d))
        touched = ("m1", "m2", "des", "deb")
    errors = _errors({k: got[k] for k in touched},
                     {k: want[k] for k in touched}, dtype)
    print(f"{fault} {shape} {dtype}: " + " ".join(
        f"{k} {sound[k][0]:.3e} -> {v[0]:.3e}" for k, v in errors.items()))
    assert all(v[0] > v[1] for v in errors.values()), errors


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_are_deterministic(gen, dtype):
    ops = _operands(SHAPES[0], dtype, gen)
    a, b = _kernels(*ops, "leaky_relu"), _kernels(*ops, "leaky_relu")
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_captured_graph_replays_the_eager_launches(gen, dtype):
    """The launchers allocate through torch.empty and never synchronise:
    a CUDA graph captures them, and its replay writes what the eager
    launches wrote, bit for bit."""
    ops = _operands(SHAPES[1], dtype, gen)
    eager = _kernels(*ops, "leaky_relu")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm the side stream's allocations
        _kernels(*ops, "leaky_relu")
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _kernels(*ops, "leaky_relu")
    for t in captured.values():
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(captured[k], eager[k]) for k in eager)


def test_autograd_on_the_card_matches_the_cpu(gen):
    """The card's Functions and Fold in a small skip net (conv_fusion
    'auto', f32, a ragged batch of 2): outputs and gradients against the
    same net on the CPU, which runs the plain versions."""
    from tpusr_torch.models.skip import SkipNet

    torch.backends.cudnn.allow_tf32 = False
    try:
        nets = [SkipNet(num_input_channels=8, num_channels_down=(32, 32, 32),
                        num_channels_up=(32, 32, 32),
                        num_channels_skip=(4, 4, 4), pad="reflection",
                        upsample_mode="bilinear",
                        generator=torch.Generator().manual_seed(0))
                .to(dev, memory_format=torch.channels_last)
                for dev in ("cpu", "cuda")]
        x = torch.rand(2, 8, 27, 45, generator=torch.Generator().manual_seed(1))
        before = dict(bn_act.LAUNCHES)
        outs, grads = [], []
        for net in nets:
            xd = x.to(next(net.parameters()).device).contiguous(
                memory_format=torch.channels_last)
            y = net(xd)
            y.square().mean().backward()
            outs.append(y.detach().cpu())
            grads.append(torch.cat([p.grad.flatten().cpu()
                                    for p in net.parameters()]))
        launched = {k: n - before[k] for k, n in bn_act.LAUNCHES.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert _rel(outs[1], outs[0]) < 1e-4 and _rel(grads[1], grads[0]) < 1e-3
    # 3 levels of 5 moments and 5 normalizes; 7 normalize backwards, 5 of
    # them folded into the moments' backward
    assert launched == {"channel_moments": 15, "affine_act": 15,
                        "affine_act_grad": 21, "moments_grad": 15,
                        "partials_sum": 36}


def test_wrapper_rejects_what_the_kernels_do_not_take(gen):
    x = torch.zeros(1, 4, 4, 8, device="cuda")
    v = torch.ones(8, device="cuda")
    for bad, msg in ((x.double(), "dtype"), (x.permute(0, 3, 1, 2), "NHWC"),
                     (x[:, :, :, :0], "empty")):
        with pytest.raises(ValueError, match=msg):
            bn_act._moments_cuda(bad)
    with pytest.raises(ValueError, match="eff_scale"):
        bn_act._affine_act_cuda(x, v.double(), v, None)
    with pytest.raises(ValueError, match="act"):
        bn_act._affine_act_cuda(x, v, v, "relu")
    with pytest.raises(ValueError, match="g must"):
        bn_act._affine_act_grad_cuda(x[:, :2], x, v, v, None, True)
