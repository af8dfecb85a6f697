"""Single-image DIP with each Adam stage's forward and backward replayed as
one CUDA graph (``engine/dip.py::_AdamStage``), against eager steps.

Every iteration of ``dip_superresolve`` must be the eager DIP step at the
leaves it starts from: an eager twin, built from the same generator and
drawing the same noise, takes the leaves at each optimizer step and its
loss and gradient must equal the call's; Adam over the gradients the call
produced must give its final leaves, and the twin's forward at them its
image. On the CPU every iteration is eager; on the card the third captures
the graph and every later one replays it. The card's backward is not
bitwise repeatable (the bilinear-upsample and pad backwards add with
atomics), so two eager loops from one seed part after a few Adam steps;
held step by step, the card's gradients agree to GRAD_RTOL. On the card
the iterations also count their A/B and BatchNorm-glue launches in
``LAUNCHES``, and the
graph's memory is freed with the call. The card cases are marked ``cuda``
and skip without a card; on a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_dip_graph_cuda.py
"""

import dataclasses
import gc

import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from tpusr_torch.engine import dip
from tpusr_torch.ops import bn_act
from tpusr_torch.ops import fused_conv as fc
from tpusr_torch.utils.profiling import observe

# the small net of tests/test_torch_kernels_cuda.py
SMALL = dip.DIPConfig(factor=4, input_depth=8, skip_n33d=32, skip_n33u=32,
                      num_scales=3, num_iter=12, log_freq=5)
HW = 48
GRAD_RTOL = 2e-3  # of the largest entry: eager against eager read 4e-4


@pytest.fixture
def card():
    """The card, with cuDNN's deterministic algorithms for the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cudnn.deterministic = True
    yield "cuda"
    torch.backends.cudnn.deterministic = False


def _inputs(hw, factor):
    g = torch.Generator().manual_seed(7)
    hr = torch.rand(1, hw, hw, 3, generator=g)
    lr = torch.nn.functional.avg_pool2d(hr.permute(0, 3, 1, 2), factor)
    return lr.permute(0, 2, 3, 1).contiguous(), hr


def _counts():
    return {**fc.LAUNCHES, **bn_act.LAUNCHES}


def _glue(levels, grad=True):
    """ops/bn_act.py's launches of one forward (and backward) of a net whose
    every level has a skip branch: five moments and five normalizes a
    level; backward, seven normalize backwards and five moments' backwards,
    each a kernel, and a partials sum after each reduction."""
    if not grad:
        return {"channel_moments": 5 * levels, "affine_act": 5 * levels,
                "affine_act_grad": 0, "moments_grad": 0,
                "partials_sum": 5 * levels}
    return {"channel_moments": 5 * levels, "affine_act": 5 * levels,
            "affine_act_grad": 7 * levels, "moments_grad": 5 * levels,
            "partials_sum": 12 * levels}


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _rel(a, b):
    a, b = (torch.as_tensor(t).detach().double() for t in (a, b))
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


class Twin:
    """What a single-image call (``_dip_core`` on a ``_SingleNet``) builds
    from ``seed``: the net, the loss operator, z and the device generator,
    for eager steps at any leaves."""

    def __init__(self, config, seed, lr, hw, dev):
        gen = torch.Generator().manual_seed(seed)
        self.net, self.down = dip.build(config, gen)
        self.net.to(dev, memory_format=torch.channels_last)
        self.down.to(dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(torch.randint(0, 2 ** 62, (1,),
                                               generator=gen)))
        self.shape = (1, hw, hw, config.input_depth)
        self.z = (torch.rand(self.shape, generator=self.gen, device=dev)
                  .permute(0, 3, 1, 2) * config.input_noise_scale)
        self.lr = lr.to(dev).permute(0, 3, 1, 2)
        self.std, self.dev = config.reg_noise_std, dev
        self.leaves = list(self.net.parameters())
        self.noise = None

    def step_at(self, leaves):
        """The next iteration's noise, and the eager loss and gradient at
        ``leaves``."""
        self.noise = torch.randn(self.shape, generator=self.gen,
                                 device=self.dev).permute(0, 3, 1, 2)
        with torch.no_grad():
            for t, p in zip(self.leaves, leaves):
                t.copy_(p)
        loss = dip.dip_loss(self.net, self.down,
                            self.z + self.noise * self.std, self.lr,
                            update_stats=False)
        grads = torch.autograd.grad(loss, self.leaves)
        return float(loss.detach()), _flat(grads)

    def image_at(self, leaves):
        with torch.no_grad():
            for t, p in zip(self.leaves, leaves):
                t.copy_(p)
            out = self.net(self.z + self.noise * self.std,
                           update_stats=False)
        return out.permute(0, 2, 3, 1)


def _call(lr, hr, config, seed, dev, on_step=None):
    """``dip_superresolve``'s image and curves; its last optimizer; and
    each iteration's ``graph`` field and kernel launches (between the
    span's enter and exit). ``on_step(opt)`` runs before each optimizer step."""
    opts, spans, at_enter = [], [], {}

    def pre(opt, args, kwargs):
        if not opts or opts[-1] is not opt:
            opts.append(opt)
        if on_step is not None:
            on_step(opt)

    def enter(rec):
        if rec.name == "dip.iteration":
            at_enter[rec.id] = _counts()

    def leave(rec):
        if rec.name == "dip.iteration":
            before = at_enter.pop(rec.id)
            now = _counts()
            spans.append((rec.fields["graph"],
                          {k: now[k] - before[k] for k in before}))

    hook = register_optimizer_step_pre_hook(pre)
    handle = observe(enter, leave)
    try:
        out, curves = dip.dip_superresolve(
            lr, hr, config, torch.Generator().manual_seed(seed), dev)
    finally:
        handle.remove()
        hook.remove()
    return out, curves, opts[-1], spans


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                     marks=pytest.mark.cuda)])
@pytest.mark.parametrize("fusion", ["auto", "off"])
def test_every_iteration_is_the_eager_step_at_its_leaves(dev, fusion,
                                                         request):
    if dev == "cuda":
        request.getfixturevalue("card")
    else:
        torch.set_num_threads(1)
    config = dataclasses.replace(SMALL, conv_fusion=fusion)
    lr, hr = _inputs(HW, config.factor)
    twin = Twin(config, 3, lr, HW, dev)
    first = [p.detach().clone() for p in twin.leaves]
    steps = []  # (the call's gradient, the twin's loss and gradient)

    def on_step(opt):
        leaves = opt.param_groups[0]["params"]
        steps.append((_flat([p.grad for p in leaves]).clone(),
                      *twin.step_at(leaves)))

    out, curves, opt, spans = _call(lr, hr, config, 3, dev, on_step)
    modes = [m for m, _ in spans]
    assert modes == (["eager"] * 2 + ["capture"] + ["replay"] * 9
                     if dev == "cuda" else ["eager"] * 12)
    assert len(steps) == 12
    for k, (got, _, want) in enumerate(steps):
        assert _rel(got, want) <= GRAD_RTOL, k
    # each chunk's loss is its own (a replay's is the graph's tensor)
    want_loss = [steps[4][1], steps[9][1]]
    assert curves["loss"][0] != curves["loss"][1]
    assert _rel(curves["loss"], want_loss) <= 1e-6
    # Adam over the call's gradients from the first leaves: its last leaves
    ref = [p.clone().requires_grad_() for p in first]
    ref_opt = torch.optim.Adam(ref, lr=config.learning_rate)
    sizes = [p.numel() for p in ref]
    for got, _, _ in steps:
        for p, g in zip(ref, got.split(sizes)):
            p.grad = g.view(p.shape).clone()
        ref_opt.step()
    leaves = opt.param_groups[0]["params"]
    assert _rel(_flat(leaves), _flat(ref)) <= 1e-6
    assert _rel(out, twin.image_at(leaves)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("scales, hw, per_iter", [
    (3, HW, {"fused_conv3x3_fwd": 12, "fused_conv3x3_wgrad": 6,
             **_glue(3)}),
    # the benchmark cell's layout: 5 scales, 10 fused convs a forward
    (5, 64, {"fused_conv3x3_fwd": 20, "fused_conv3x3_wgrad": 10,
             **_glue(5)})])
def test_every_iteration_counts_its_launches(card, scales, hw, per_iter):
    config = dataclasses.replace(SMALL, num_scales=scales)
    lr, hr = _inputs(hw, config.factor)
    before = _counts()
    *_, spans = _call(lr, hr, config, 4, card)
    assert [m for m, _ in spans][2:4] == ["capture", "replay"]
    assert all(n == per_iter for _, n in spans)
    # and the call's total: its two heads and the resolve one forward each
    per_forward = {"fused_conv3x3_fwd": per_iter["fused_conv3x3_wgrad"],
                   "fused_conv3x3_wgrad": 0, **_glue(scales, grad=False)}
    now = _counts()
    assert {k: now[k] - before[k] for k in before} == {
        k: 12 * per_iter[k] + 3 * per_forward[k] for k in per_iter}


@pytest.mark.cuda
def test_the_graph_is_freed_with_the_call(card):
    """Allocated memory after each call, its cyclic garbage collected, is
    back at the first call's level; the pool the graphs share keeps the
    reserved memory from growing by a graph a call."""
    lr, hr = _inputs(HW, SMALL.factor)
    levels = []
    for seed in range(4):
        out, _ = dip.dip_superresolve(lr, hr, SMALL,
                                      torch.Generator().manual_seed(seed))
        del out
        gc.collect()
        torch.cuda.synchronize()
        levels.append((torch.cuda.memory_allocated(),
                       torch.cuda.memory_reserved()))
    assert [a for a, _ in levels] == [levels[0][0]] * 4, levels
    assert levels[3][1] == levels[1][1], levels


def _modes(fn):
    """fn()'s result and the ``graph`` field of each ``dip.iteration``."""
    modes = []

    def leave(rec):
        if rec.name == "dip.iteration":
            modes.append(rec.fields["graph"])

    handle = observe(None, leave)
    try:
        return fn(), modes
    finally:
        handle.remove()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["input_down", "bucketed", "lbfgs",
                                     "profiled"])
def test_every_single_image_entry_replays_its_graph(card, variant,
                                                    monkeypatch, tmp_path):
    """The other single-image routes into ``_dip_core`` (a ``_SingleNet``),
    each on its graph: trained z and kernel (leaves the graph reads and
    Adam moves), a bucket's LR mask, L-BFGS's Adam warm-up, and a call
    under ``maybe_trace`` (the CLI's --profile_dir: the profiler records
    through the capture and sees the kernels of the replays)."""
    from tpusr_torch.utils.profiling import maybe_trace

    config = SMALL
    lr, hr = _inputs(HW, config.factor)
    gen = torch.Generator().manual_seed(5)
    graphed = ["eager"] * 2 + ["capture"] + ["replay"] * 9
    if variant == "input_down":
        config = dataclasses.replace(config, opt_over="net,input,down")
        twin = Twin(config, 5, lr, HW, card)
        (out, curves, opt, _), modes = _modes(
            lambda: _call(lr, hr, config, 5, card))
        z, kernel = opt.param_groups[0]["params"][-2:]
        assert float((z - twin.z).abs().max()) > 1e-3
        assert float((kernel - twin.down.kernel).abs().max()) > 1e-3
    elif variant == "bucketed":
        lr_b, _ = dip.pad_to_bucket(lr.numpy(), 16)
        hr_b, valid = dip.pad_to_bucket(hr.numpy(), 64)
        (out, curves), modes = _modes(lambda: dip.dip_superresolve_bucketed(
            lr_b, hr_b, valid, config, gen, card))
        assert out.shape == (1, 64, 64, 3)
    elif variant == "lbfgs":
        monkeypatch.setattr(dip, "WARMUP_ITERS", 6)
        config = dataclasses.replace(config, optimizer="lbfgs",
                                     lbfgs_line_search="fixed")
        graphed = graphed[:6]
        (out, curves), modes = _modes(lambda: dip.dip_superresolve(
            lr, hr, config, gen, card))
        assert list(curves["evals"]) == [5, 7]
    else:
        with maybe_trace(str(tmp_path)):
            (out, curves), modes = _modes(lambda: dip.dip_superresolve(
                lr, hr, config, gen, card))
        (trace,) = tmp_path.iterdir()
        text = trace.read_text()
        assert text.count("fwd_tf32_kernel") >= 12 * 12
        assert text.count("wgrad_tf32_kernel") >= 12 * 6
    assert modes == graphed
    assert bool(torch.isfinite(out).all())
    assert (curves["loss"] > 0).all()
