"""The engine's spans (``tpusr_torch.utils.profiling.span``) on the CPU.

An off span is the shared no-op and calls no observer; on, spans nest,
share their call's id and close on an exception. A DIP call, a lane batch
and a training call give their spans in the order and nesting PERF.md
lists, and an observer of ``dip.iteration`` reads what PyTorch's global
optimizer-step hooks see (the benchmark's ``Recorder``); on the CPU every
iteration runs eagerly (``graph="eager"``). Under
``maybe_trace`` the Chrome trace holds the spans. The benchmark's span
readers (``srbench/metrics``) on synthetic records.
"""

import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from srbench.drivers.dip import Recorder
from tpusr_torch.engine import dip, gan
from tpusr_torch.engine.gan_epochs import gan_train_epochs
from tpusr_torch.utils import profiling
from tpusr_torch.utils.profiling import observe, span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_DIP = dip.DIPConfig(num_iter=3, num_scales=2, skip_n33d=8, skip_n33u=8,
                         skip_n11=2, input_depth=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def kept():
    """The records every span hands its observer at exit, for the test."""
    out = []
    handle = observe(None, out.append)
    yield out
    handle.remove()


def _tree(records):
    """{name: [records]} and each record's parent's name."""
    by_id = {r.id: r for r in records}
    names = {}
    for r in records:
        names.setdefault(r.name, []).append(r)
    return names, {r.id: by_id[r.parent].name if r.parent in by_id else None
                   for r in records}


def test_an_off_span_is_the_shared_no_op(monkeypatch):
    assert not profiling._observers and not torch.autograd._profiler_enabled()
    calls = []
    monkeypatch.setattr(profiling, "_Span",
                        lambda rec: calls.append(rec) or None)
    assert span("a", index=1) is span("b") is profiling._OFF
    with span("a") as rec:
        assert rec is None
    assert calls == []


def test_spans_nest_share_the_call_and_close_on_an_exception():
    seen = []
    handle = observe(lambda r: seen.append(("enter", r.name)),
                     lambda r: seen.append(("exit", r.name)))
    try:
        with span("outer", k=1) as outer:
            with span("inner") as inner:
                pass
            with pytest.raises(ValueError):
                with span("failing") as failing:
                    raise ValueError
        with span("next") as nxt:
            pass
    finally:
        handle.remove()
    assert outer.parent is None and outer.call == outer.id
    assert outer.fields == {"k": 1} and not outer.profiled
    assert inner.parent == failing.parent == outer.id
    assert inner.call == failing.call == outer.id
    assert failing.end_ns is not None
    assert nxt.parent is None and nxt.call == nxt.id != outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert seen == [("enter", "outer"), ("enter", "inner"), ("exit", "inner"),
                    ("enter", "failing"), ("exit", "failing"),
                    ("exit", "outer"), ("enter", "next"), ("exit", "next")]
    assert span("after") is profiling._OFF  # removed: off again


class _FromSpans:
    """The Recorder's readings rebuilt from ``dip.iteration``'s optimizer:
    leaves before step 1, Adam's first moment after step 1, leaves after
    step 3."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _leaves(opt):
        return [p for g in opt.param_groups for p in g["params"]]

    def enter(self, rec):
        if rec.name == "dip.iteration" and rec.fields["index"] == 0:
            self.calls.append({"p0": [p.detach().clone() for p in
                                      self._leaves(rec.fields["optimizer"])]})

    def exit(self, rec):
        if rec.name != "dip.iteration":
            return
        opt, i = rec.fields["optimizer"], rec.fields["index"]
        if i == 0:
            beta1 = opt.param_groups[0]["betas"][0]
            self.calls[-1]["g1"] = [opt.state[p]["exp_avg"] / (1 - beta1)
                                    for p in self._leaves(opt)]
        if i == 2:
            self.calls[-1]["p3"] = [p.detach().clone()
                                    for p in self._leaves(opt)]


def _dip_inputs(n):
    g = torch.Generator().manual_seed(3)
    hr = torch.rand(n, 1, 32, 32, 3, generator=g)
    lr = torch.nn.functional.avg_pool2d(
        hr.flatten(0, 1).permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1)
    return lr.reshape(n, 1, 4, 4, 3), hr


@pytest.mark.parametrize("lanes", [1, 2])
def test_a_dip_call_gives_its_spans_and_the_recorders_readings(kept, lanes):
    lr, hr = _dip_inputs(lanes)
    gens = [torch.Generator().manual_seed(10 + i) for i in range(lanes)]
    rebuilt = _FromSpans()
    handle = observe(rebuilt.enter, rebuilt.exit)
    try:
        with Recorder() as hooks:
            if lanes == 1:
                dip.dip_superresolve(lr[0], hr[0], TINY_DIP, gens[0], "cpu")
            else:
                dip.dip_superresolve_batch(lr, hr, gens, TINY_DIP, "cpu")
    finally:
        handle.remove()
    names, parent = _tree(kept)
    assert [r.name for r in kept] == [
        "dip.build", "dip.head", "dip.iteration", "dip.iteration",
        "dip.iteration", "dip.resolve", "dip.call"]
    (call,) = names["dip.call"]
    assert call.fields == {"lanes": lanes}
    assert all(parent[r.id] == "dip.call" and r.call == call.id
               for r in kept if r is not call)
    assert [r.fields["index"] for r in names["dip.iteration"]] == [0, 1, 2]
    (want,), (got,) = hooks.calls, rebuilt.calls
    for key in ("p0", "g1", "p3"):
        assert len(got[key]) == len(want[key])
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key]))


def test_every_iteration_on_the_cpu_runs_eagerly(kept):
    lr, hr = _dip_inputs(1)
    dip.dip_superresolve(lr[0], hr[0], TINY_DIP, None, "cpu")
    iters = [r for r in kept if r.name == "dip.iteration"]
    assert [r.fields["graph"] for r in iters] == ["eager"] * 3


def test_lbfgs_iterations_are_spans(kept, monkeypatch):
    monkeypatch.setattr(dip, "WARMUP_ITERS", 2)
    lr, hr = _dip_inputs(1)
    config = dataclasses.replace(TINY_DIP, num_iter=2, optimizer="lbfgs",
                                 lbfgs_line_search="fixed")
    dip.dip_superresolve(lr[0], hr[0], config, None, "cpu")
    names, parent = _tree(kept)
    assert [r.fields["index"] for r in names["dip.iteration"]] == [0, 1]
    assert [r.fields["index"]
            for r in names["dip.lbfgs_iteration"]] == [0, 1]
    assert {parent[r.id] for r in names["dip.lbfgs_iteration"]} == {
        "dip.call"}


def test_a_training_call_gives_a_crop_and_a_step_per_step(kept):
    cfg = gan.GANTrainConfig(factor=4, batch_size=2, hr_patch=16,
                             residual_blocks_count=1, content="mse")
    state = gan.create_gan_state(cfg, 1e-4, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    lr = torch.randint(0, 256, (4, 6, 7, 3), dtype=torch.uint8, generator=g)
    hr = torch.randint(0, 256, (4, 24, 28, 3), dtype=torch.uint8,
                       generator=g)
    valid = torch.tensor([[6, 7]] * 4, dtype=torch.int32)
    gan_train_epochs(state, lr, hr, valid, torch.Generator().manual_seed(2),
                     cfg, n_epochs=2)
    names, parent = _tree(kept)
    top = [r.name for r in kept if parent[r.id] == "gan.call"]
    step = ["gan.crop", "gan.step"]
    assert top == (step + ["gan.metrics"]) * 2 + step * 2
    (call,) = names["gan.call"]
    assert call.fields == {"epochs": 2, "steps": 2}
    assert all(r.call == call.id for r in kept)
    assert all(r.fields["state"] is state for r in names["gan.step"])
    for child in ("gan.g_forward", "gan.d_update", "gan.g_update"):
        assert len(names[child]) == 4
        assert {parent[r.id] for r in names[child]} == {"gan.step"}
    assert {parent[r.id] for r in names["gan.d_optimizer"]} == {
        "gan.d_update"}
    assert {parent[r.id] for r in names["gan.generator_forward"]} == {
        "gan.metrics"}


def test_the_chrome_trace_holds_the_spans(tmp_path):
    lr, hr = _dip_inputs(1)
    with profiling.maybe_trace(str(tmp_path)):
        dip.dip_superresolve(lr[0], hr[0], TINY_DIP, None, "cpu")
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("dip.iteration") == 3
    assert {"dip.call", "dip.build", "dip.head", "dip.resolve"} <= set(names)


# ------------------------------------------------------ the span readers
def _reader(metric):
    path = os.path.join(ROOT, "srbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"test_reader_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _unit(name, uid, call, start, end, profiled=False, parent=None,
          **fields):
    from srbench.spans import Unit

    return Unit(name, uid, parent, call, start * 10 ** 6,
                            end * 10 ** 6, profiled, fields)


def _dip_call(uid, start, iters, lanes=1, profiled=False):
    """A call of ``iters`` (start, end) ms iterations, from ``start`` to
    2 ms after its last."""
    units = [_unit("dip.iteration", uid + 1 + i, uid, s, e, profiled, uid,
                   index=i) for i, (s, e) in enumerate(iters)]
    return units + [_unit("dip.call", uid, uid, start, iters[-1][1] + 2,
                          profiled, lanes=lanes)]


@pytest.fixture
def records(monkeypatch):
    """srbench.spans's store, fed by hand: its observer, registered when
    it is imported, is removed (imported here, not at the top, so that
    collecting this file leaves spans off in the process)."""
    from srbench import spans

    if spans.handle is not None:
        spans.handle.remove()
    recs = []
    monkeypatch.setattr(spans, "records", recs)
    return recs


def test_the_dip_readers_partition_the_unprofiled_calls(records):
    read = {m: _reader(m) for m in ("host_ms_per_iter.dip",
                                    "call_overhead_ms_per_iter.dip",
                                    "host_ms_per_iter.lanes")}
    assert all(r({}) is None for r in read.values())  # nothing recorded
    records += _dip_call(1, 0, [(1, 2), (2, 3)])  # set-up's warm-up call
    assert all(r({}) is None for r in read.values())  # nothing profiled
    records += _dip_call(10, 10, [(11, 12), (12, 20), (20, 21)],
                         profiled=True)
    assert all(r({}) is None for r in read.values())  # nothing after it
    records += _dip_call(20, 30, [(31, 35), (35, 37)], lanes=2)
    records += _dip_call(30, 50, [(50, 56), (56, 60)], lanes=2)
    # calls 39 - 30 and 62 - 50 ms; iterations 4, 2, 6, 4
    assert read["host_ms_per_iter.dip"]({}) == pytest.approx(4.0)
    assert read["call_overhead_ms_per_iter.dip"]({}) == pytest.approx(
        (21 - 16) / 4)
    assert read["host_ms_per_iter.lanes"]({}) == pytest.approx(2.0)


def test_the_step_and_image_readers_skip_setup_and_profiled_units(records):
    metrics = {"gan.generator_forward": "host_ms_per_image.eval",
               "gan.step": "host_ms_per_step.train",
               "gan.d_optimizer": "d_optimizer_host_ms_per_step.train"}
    for name, metric in metrics.items():
        records.clear()
        read = _reader(metric)
        records.append(_unit(name, 1, 1, 0, 50))  # set-up
        assert read({}) is None
        records += [_unit(name, 2, 2, 60, 70, profiled=True),
                    _unit(name, 3, 3, 70, 80, profiled=True)]
        assert read({}) is None
        records += [_unit(name, 4, 4, 80, 83), _unit(name, 5, 5, 83, 88),
                    _unit("gan.crop", 6, 6, 88, 99)]
        assert read({}) == pytest.approx(4.0), metric


def test_the_graph_share_reader(records):
    read = _reader("graph_share.dip")
    assert read({}) is None  # nothing recorded
    records += _dip_call(1, 0, [(1, 2), (2, 3)], profiled=True)
    records += _dip_call(10, 10, [(11, 12), (12, 13)])
    assert read({}) == 0.0  # no span has the field: every iteration eager
    records.clear()
    records += _dip_call(1, 0, [(1, 2)], profiled=True)
    modes = ["eager"] * 2 + ["capture"] + ["replay"] * 197
    records += [_unit("dip.iteration", 100 + i, 10, 10 + i, 11 + i, parent=10,
                      index=i, graph=m) for i, m in enumerate(modes)]
    records.append(_unit("dip.call", 10, 10, 10, 212, lanes=1))
    assert read({}) == pytest.approx(99.0)
