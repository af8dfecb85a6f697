"""ops/bn_act.py: the skip net's BatchNorm + LeakyReLU glue.

On the CPU each op runs its plain version, which must be the eager
composition the skip net ran before the kernels, bit for bit: outputs,
gradients and running statistics. The card's dataflow (the autograd
Functions and the Fold between a normalize's backward and the moments'
backward) is held here too, with each kernel launcher replaced by a
straightforward f64 version of its contract: in an f64 net it must give the
plain dataflow's numbers to rounding, with the launches the card makes.
The kernels themselves are held to the plain versions on a card
(tests/test_torch_bn_act_cuda.py).
"""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from srbench.tracing import is_glue, port_kernel
from tpusr_torch.models import layers, skip
from tpusr_torch.models.layers import BatchNorm, SplitBatchNorm, _per_channel
from tpusr_torch.models.skip import SkipNet
from tpusr_torch.ops import bn_act, fused_conv
from tpusr_torch.ops.fused_conv import fused_conv3x3

CSRC = Path(bn_act.__file__).parent.parent / "csrc" / "bn_act.cu"

# the DIP configurations of tests/test_torch_skip.py, 8 input channels
CFGS = {
    "2scales_reflect": dict(num_channels_down=(32, 32),
                            num_channels_up=(32, 32),
                            num_channels_skip=(4, 4), pad="reflection",
                            upsample_mode="bilinear"),
    "3scales_zero": dict(num_channels_down=(16, 24, 32),
                         num_channels_up=(16, 24, 32),
                         num_channels_skip=(4, 0, 4), pad="zero",
                         upsample_mode="nearest"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _rnd(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _grads(out, leaves):
    return torch.autograd.grad(out, leaves, allow_unused=True)


# ------------------------------------------------------------ the plain twins
def _eager_moments(x):
    """models/layers.py's moments before the kernels."""
    dims = (0, 2, 3)
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.mean(dims, dtype=acc), x.square().mean(dims, dtype=acc)


def _eager_prologue_backward(dpa, x, es, eb, act):
    """FusedConv3x3.backward's prologue backward before the kernels."""
    dpre = dpa
    if act == "leaky_relu":
        a0 = x * es.to(x.dtype) + eb.to(x.dtype)
        dpre = torch.where(a0 >= 0, dpa, dpa * 0.2)
    return (dpre * es.to(x.dtype), (dpre.float() * x.float()).sum((0, 1, 2)),
            dpre.float().sum((0, 1, 2)))


SHAPES = [(1, 4, 16, 16), (3, 5, 7, 9), (2, 32, 27, 45)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_moments_twin_is_the_eager_moments(dtype, shape):
    x = _cl(_rnd(*shape, dtype=dtype)).requires_grad_()
    m1, m2, fold = bn_act.channel_moments(x)
    w1, w2 = _eager_moments(x)
    assert fold is None and _same(m1, w1) and _same(m2, w2)
    d1, d2 = _rnd(shape[1], seed=1), _rnd(shape[1], seed=2)
    (got,) = _grads((m1 * d1).sum() + (m2 * d2).sum(), [x])
    (want,) = _grads((w1 * d1).sum() + (w2 * d2).sum(), [x])
    assert _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "leaky_relu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_prologue_backward_twin_is_the_eager_one(dtype, act, shape):
    n, c, h, w = shape
    x, g = (_rnd(n, h, w, c, seed=s, dtype=dtype) for s in (3, 4))
    es, eb = _rnd(c, seed=5).abs() + 0.5, _rnd(c, seed=6)
    got = bn_act.prologue_backward(g, x, es, eb, act)
    want = _eager_prologue_backward(g, x, es, eb, act)
    assert all(_same(a, b) for a, b in zip(got, want))


def _site(kind, bn, x, act, fold_route):
    """One BatchNorm + act site, as the skip net's fused dataflow runs it
    (``fold_route``: BatchNorm.affine + affine_act) or as it ran it before
    (forward + F.leaky_relu)."""
    ura = kind == "eval"
    stats = None
    if kind == "conv_stats":  # the producing conv's sums, its bias pending
        n = x.numel() // x.shape[1]
        stats = (x.float().sum((0, 2, 3)), x.float().square().sum((0, 2, 3)),
                 n, _rnd(x.shape[1], seed=9))
    if fold_route:
        es, eb, fold = bn.affine(x, ura, conv_stats=stats)
        assert fold is None  # the CPU makes none
        return bn_act.affine_act(x, es, eb, act, fold)
    if kind == "moments":  # the affine into a consumer: applied here by hand
        es, eb = bn(x, ura, return_affine=True)
        y = x * _per_channel(es, x.dtype) + _per_channel(eb, x.dtype)
    else:
        y = bn(x, ura, conv_stats=stats)
    return F.leaky_relu(y, 0.2) if act == "leaky_relu" else y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "leaky_relu"])
@pytest.mark.parametrize("kind", ["full", "moments", "conv_stats", "eval"])
@pytest.mark.parametrize("shape", SHAPES[1:])
def test_batchnorm_sites_match_the_eager_composition(dtype, act, kind, shape):
    """Output, gradients of x and of the BatchNorm's weight and bias, and
    the running statistics, bit for bit."""
    runs = []
    for fold_route in (True, False):
        torch.manual_seed(0)
        bn = BatchNorm(shape[1])
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
            bn.running_mean.uniform_(-0.1, 0.1)
        x = _cl(_rnd(*shape, seed=7, dtype=dtype)).requires_grad_()
        y = _site(kind, bn, x, act, fold_route)
        gy = _cl(_rnd(*shape, seed=8, dtype=dtype))
        grads = _grads((y * gy).sum(), [x, bn.weight, bn.bias])
        runs.append((y, *grads, bn.running_mean, bn.running_var))
    for a, b in zip(*runs):
        assert (a is None and b is None) or _same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_batchnorm_affine_is_return_affine(dtype):
    xs = [_cl(_rnd(2, c, 9, 11, seed=c, dtype=dtype)) for c in (4, 12)]
    got_bn, want_bn = SplitBatchNorm((4, 12)), SplitBatchNorm((4, 12))
    got = got_bn.affine(xs)
    want = want_bn(xs, return_affine=True)
    for (es, eb, fold), (wes, web) in zip(got, want):
        assert fold is None and _same(es, wes) and _same(eb, web)
    assert _same(got_bn.running_var, want_bn.running_var)
    assert _same(got_bn.running_mean, want_bn.running_mean)


# ------------------------------------------------ the skip net, CPU routes
def _net(cfg_name, fusion, act_fun="LeakyReLU", dtype=None):
    net = SkipNet(num_input_channels=8, num_output_channels=3,
                  act_fun=act_fun, conv_fusion=fusion, dtype=dtype,
                  generator=torch.Generator().manual_seed(0), **CFGS[cfg_name])
    return net.to(memory_format=torch.channels_last)


def _run(net, n=1, hw=(32, 32)):
    x = _cl(_rnd(n, 8, *hw, seed=11)).to(next(net.parameters()).dtype)
    y = net(x)
    y.square().mean().backward()
    return (y.detach(), {k: p.grad for k, p in net.named_parameters()},
            {k: b.clone() for k, b in net.named_buffers()})


def _eager_glue(monkeypatch):
    """The skip net's fused dataflow with the glue as it was before the
    kernels: return_affine in place of affine, x * es + eb then the act."""

    def affine(self, x, ura=False, *, update_stats=True, **kw):
        out = type(self).forward(self, x, ura, return_affine=True,
                                 update_stats=update_stats, **kw)
        if isinstance(self, SplitBatchNorm):
            return [(es, eb, None) for es, eb in out]
        return (*out, None)

    def glue(x, es, eb, act=None, fold=None):
        y = x * _per_channel(es, x.dtype) + _per_channel(eb, x.dtype)
        return F.leaky_relu(y, 0.2) if act == "leaky_relu" else y

    monkeypatch.setattr(BatchNorm, "affine", affine)
    monkeypatch.setattr(SplitBatchNorm, "affine", affine)
    monkeypatch.setattr(skip, "affine_act", glue)
    monkeypatch.setattr(layers, "affine_act", glue)


@pytest.mark.parametrize("act_fun", ["LeakyReLU", "none"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("cfg_name", list(CFGS))
def test_skipnet_auto_is_its_eager_glue_bit_for_bit(cfg_name, dtype, act_fun,
                                                    monkeypatch):
    """SkipNet(conv_fusion='auto') on the CPU: outputs, every parameter's
    gradient and the running statistics equal those of the same dataflow
    with the glue as the skip net ran it before the kernels."""
    got = _run(_net(cfg_name, "auto", act_fun, dtype), n=2, hw=(27, 45))
    _eager_glue(monkeypatch)
    want = _run(_net(cfg_name, "auto", act_fun, dtype), n=2, hw=(27, 45))
    assert _same(got[0], want[0])
    for k in want[1]:
        assert _same(got[1][k], want[1][k]), k
    for k in want[2]:
        assert _same(got[2][k], want[2][k]), k


# ------------------------------------------ the card's dataflow, emulated
class _Emulated:
    """Each kernel launcher of ops/bn_act.py as a straightforward f64
    version of its contract, on CPU tensors, counting its launches."""

    def __init__(self):
        self.calls = {k: 0 for k in bn_act.LAUNCHES}

    @staticmethod
    def _acc(x):
        return torch.promote_types(x.dtype, torch.float32)

    def moments(self, xh):
        self.calls["channel_moments"] += 1
        self.calls["partials_sum"] += 1
        x = xh.double()
        return (x.mean((0, 1, 2)).to(self._acc(xh)),
                x.square().mean((0, 1, 2)).to(self._acc(xh)))

    def affine_act(self, xh, es, eb, act):
        self.calls["affine_act"] += 1
        a = xh.double() * es.double() + eb.double()
        if act == "leaky_relu":
            a = torch.where(a < 0, 0.2 * a, a)
        return a.to(xh.dtype)

    @staticmethod
    def _d(g, xh, es, eb, act):
        d = g.double()
        if act == "leaky_relu":
            a = xh.double() * es.double() + eb.double()
            d = torch.where(a < 0, 0.2 * d, d)
        return d

    def grad(self, g, xh, es, eb, act, want_dx):
        self.calls["affine_act_grad"] += 1
        self.calls["partials_sum"] += 1
        d = self._d(g, xh, es, eb, act)
        dx = (d * es.double()).to(xh.dtype) if want_dx else None
        return (dx, (d * xh.double()).sum((0, 1, 2)).to(self._acc(xh)),
                d.sum((0, 1, 2)).to(self._acc(xh)))

    def moments_grad(self, xh, dm1, dm2, pending=None):
        self.calls["moments_grad"] += 1
        self.calls["folded"] = self.calls.get("folded", 0) + (
            pending is not None)
        n = xh.numel() // xh.shape[-1]
        dx = (dm1.double() + 2 * xh.double() * dm2.double()) / n
        if pending is not None:
            g, es, eb, act = pending
            dx = dx + self._d(g, xh, es, eb, act) * es.double()
        return dx.to(xh.dtype)


@pytest.fixture
def emulated(monkeypatch):
    """The card's route through ops/bn_act.py on CPU tensors."""
    emu = _Emulated()
    monkeypatch.setattr(bn_act, "_plain", lambda x: False)
    for name, fn in (("_moments_cuda", emu.moments),
                     ("_affine_act_cuda", emu.affine_act),
                     ("_affine_act_grad_cuda", emu.grad),
                     ("_moments_grad_cuda", emu.moments_grad)):
        monkeypatch.setattr(bn_act, name, fn)
    return emu


def _close(a, b, tol):
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) <= tol * float(b.abs().max() + 1e-30)


def _per_level(cfg):
    """(moments, normalizes) of one forward, summed over the levels: a
    level's skip BN, down BN1, merge parts and 1x1 BN take moments; its
    skip BN, down BN2, merge skip part, up BN and 1x1 BN normalize."""
    skips = sum(1 for s in cfg["num_channels_skip"] if s)
    levels = len(cfg["num_channels_down"])
    return 3 * levels + 2 * skips, 3 * levels + 2 * skips


@pytest.mark.parametrize("cfg_name", list(CFGS))
@pytest.mark.parametrize("n", [1, 2])
def test_card_dataflow_gives_the_plain_numbers(cfg_name, n, emulated):
    """An f64 net through the card's route (Functions, Fold, the launchers'
    contracts in f64) against the plain route: outputs, gradients and
    running statistics to rounding; and the launches the card makes: every
    moments' backward takes its consumer's pass through the fold."""
    net = _net(cfg_name, "auto").double()
    ref = _net(cfg_name, "auto").double()
    got = _run(net, n=n, hw=(27, 45))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bn_act, "_plain", lambda x: True)
        want = _run(ref, n=n, hw=(27, 45))
    assert _close(got[0], want[0], 1e-12)
    # all gradients as one vector, against its largest entry: a conv bias
    # that a BatchNorm cancels has zero gradient in exact arithmetic
    assert _close(torch.cat([g.flatten() for g in got[1].values()]),
                  torch.cat([g.flatten() for g in want[1].values()]), 1e-12)
    for k in want[2]:
        assert _close(got[2][k], want[2][k], 1e-12), k
    moments, normalizes = _per_level(CFGS[cfg_name])
    levels = len(CFGS[cfg_name]["num_channels_down"])
    assert emulated.calls == {
        "channel_moments": moments, "affine_act": normalizes,
        # every moments site folds; the two conv_stats sites a level do not
        "affine_act_grad": moments + 2 * levels,
        "moments_grad": moments, "folded": moments,
        "partials_sum": 2 * moments + 2 * levels}


def test_fold_takes_one_consumer_and_only_on_a_card(emulated):
    x = _cl(_rnd(1, 4, 5, 6).double()).requires_grad_()
    es, eb, fold = torch.ones(4), torch.zeros(4), bn_act.Fold()
    bn_act.prologue_backward(x.detach().permute(0, 2, 3, 1), x.detach()
                             .permute(0, 2, 3, 1), es, eb, None, fold)
    with pytest.raises(RuntimeError, match="one consumer"):
        fold.put(None, es, eb, None)
    assert fold.take() is not None and fold.take() is None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bn_act, "_plain", lambda x: True)
        with pytest.raises(ValueError, match="on a card only"):
            bn_act.prologue_backward(x, x, es, eb, None, bn_act.Fold())


def test_a_consumer_without_backward_leaves_the_moments_term(emulated):
    """Moments whose fold's consumer takes no gradient (its output unused):
    the moments' backward writes its own term alone."""
    x = _cl(_rnd(2, 4, 5, 6).double()).requires_grad_()
    m1, m2, fold = bn_act.channel_moments(x)
    assert isinstance(fold, bn_act.Fold)
    bn_act.affine_act(x, torch.ones(4, dtype=torch.float64),
                      torch.zeros(4, dtype=torch.float64), None, fold)
    (got,) = _grads(m1.sum() + m2.sum(), [x])
    (want,) = _grads(sum(m.sum() for m in _eager_moments(x)), [x])
    assert _close(got, want, 1e-14) and emulated.calls["folded"] == 0


def test_kernel_a_prologue_backward_through_the_fold(emulated):
    """FusedConv3x3's prologue backward handed to the moments of its x."""
    x = _cl(_rnd(1, 6, 9, 11).double()).requires_grad_()
    w = _rnd(3, 3, 6, 5, seed=1).double().requires_grad_()
    weight = _rnd(6, seed=2).double().requires_grad_()

    def loss(route):
        if route == "fold":
            m1, m2, fold = bn_act.channel_moments(x)
        else:
            (m1, m2), fold = _eager_moments(x), None
        es = torch.rsqrt(m2 - m1.square() + 1e-5) * weight
        eb = -m1 * es
        y = fused_conv3x3(x.permute(0, 2, 3, 1), w, es, eb, act="leaky_relu",
                          pad_mode="reflection", fold=fold)
        return y.square().sum()

    got = _grads(loss("fold"), [x, w, weight])
    assert emulated.calls["folded"] == 1
    want = _grads(loss("plain"), [x, w, weight])
    for a, b in zip(got, want):
        assert _close(a, b, 1e-10)


# ----------------------------------------------------------- CPU / kernels
def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the ops launch nothing; the CUDA launchers refuse a CPU
    tensor instead of falling back."""
    bn_act.reset_launch_counts()
    net = _net("2scales_reflect", "auto")
    _run(net)
    assert bn_act.LAUNCHES == {k: 0 for k in bn_act.LAUNCHES}
    assert fused_conv.LAUNCHES == {k: 0 for k in fused_conv.LAUNCHES}
    xh = _rnd(1, 4, 4, 8)
    v = torch.ones(8)
    for call in (lambda: bn_act._moments_cuda(xh),
                 lambda: bn_act._affine_act_cuda(xh, v, v, None),
                 lambda: bn_act._affine_act_grad_cuda(xh, xh, v, v, None, True),
                 lambda: bn_act._moments_grad_cuda(xh, v, v)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def _global_names():
    src = CSRC.read_text()
    return re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)\(", src)


def test_kernel_names_read_as_glue():
    """The profiler names of bn_act.cu's kernels are glue to the benchmark's
    trace readers, and none of them is a port kernel (A-E) or a library
    conv: glue_ms_per_iter.dip keeps reading them, conv3x3_roofline.dip
    reads A and B alone."""
    names = _global_names()
    assert set(names) == {"channel_moments_kernel", "partials_sum_kernel",
                          "affine_act_kernel", "affine_act_grad_kernel",
                          "moments_grad_kernel"}
    for name in names:
        for args in ("", "<float, 4>", "<__nv_bfloat16, 8, true, false>"):
            trace_name = (f"void (anonymous namespace)::{name}{args}"
                          f"(float const*, float*, long long, int, int)")
            assert is_glue(trace_name), trace_name
            assert port_kernel(trace_name) is None, trace_name


def test_launch_constants_match_the_kernel_source():
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr (?:int|float) (\w+) = ([\d.]+)f?;",
                             src))
    assert int(consts["NTHREADS"]) == bn_act.NTHREADS
    assert float(consts["SLOPE"]) == bn_act.SLOPE


@pytest.mark.parametrize("c", [1, 3, 4, 8, 24, 128, 132, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 255, 27 * 45 * 2, 512 * 512])
def test_launch_geometry_owns_every_channel_once(c, dtype, p):
    """The grid the wrapper launches: 16 bytes a thread at most, each
    channel vector owned by exactly one (blockIdx.y, tx) (the kernels'
    Place), no more pixel rows than pixels, and the partials the wrapper
    allocates (grid_x) within BLOCKS_PER_SM per SM."""
    vec = bn_act.vec_width(c, dtype, 0)
    assert c % vec == 0 and vec * (2 if dtype == torch.bfloat16 else 4) <= 16
    bx, gx = bn_act.launch_geometry(p, c, vec, 132)
    assert bx & (bx - 1) == 0 and 1 <= bx <= 32 and bn_act.NTHREADS % bx == 0
    by, cv = bn_act.NTHREADS // bx, c // vec
    gy = -(-cv // bx)
    assert 1 <= gx <= max(1, bn_act.BLOCKS_PER_SM * 132 // gy)
    assert (gx - 1) * by < p
    owners = sorted(y * bx + tx for y in range(gy) for tx in range(bx)
                    if y * bx + tx < cv)
    assert owners == list(range(cv))


def test_vec_width_follows_the_pointers():
    assert bn_act.vec_width(128, torch.float32, 0, 16) == 4
    assert bn_act.vec_width(128, torch.float32, 0, 4) == 1
    assert bn_act.vec_width(128, torch.bfloat16, 0, 8) == 4
    assert bn_act.vec_width(4, torch.bfloat16, 0) == 4
    assert bn_act.vec_width(6, torch.float32, 0) == 1
