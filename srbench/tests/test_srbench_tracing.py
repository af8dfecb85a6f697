"""The reduction of a profiled window to device operations, busy and
window seconds, kernel times and idle gaps, and the per-layer readers on
it, from synthetic profiler events (microseconds)."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from srbench import run
from srbench.tracing import Tracer, TraceWindow, is_glue, port_kernel

A = "void (anonymous namespace)::fwd_tf32_kernel<64>(Params)"
B = "void (anonymous namespace)::wgrad_bf16_kernel<128>(Params)"
CUDNN = "sm90_xmma_fprop_implicit_gemm_tf32f32_tf32f32"
GLUE = "void at::native::vectorized_elementwise_kernel<4, add>"


def _ev(name, start, end, dev=DeviceType.CUDA, annotation=False):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=dev, is_user_annotation=annotation)


def _window():
    cpu = DeviceType.CPU
    return TraceWindow.from_events([
        _ev(A, 0, 100), _ev(GLUE, 100, 150), _ev(CUDNN, 200, 310),
        _ev(B, 290, 320), _ev(GLUE, 400, 410),
        _ev("ProfilerStep#3", 0, 500, cpu), _ev("aten::add", 140, 190, cpu),
        _ev("aten::mul", 330, 395, cpu), _ev("mark", 0, 500, cpu, True)],
        units=2)


def test_kernels_are_named_by_kind():
    assert port_kernel(A) == "A" and port_kernel(B) == "B"
    assert port_kernel(CUDNN) is None and not is_glue(CUDNN)
    assert is_glue(GLUE) and not is_glue(A)


def test_the_window_adds_up():
    tw = _window()
    assert tw.ops == 5 and tw.units == 2
    # busy: 0-150, 200-320, 400-410; window 0-410
    assert tw.busy_s == pytest.approx(280e-6)
    assert tw.window_s == pytest.approx(410e-6)
    assert tw.launches("A") == 1 and tw.launches("B") == 1
    assert tw.kernel_s("AB") == pytest.approx(130e-6)
    assert tw.kernel_s("A") == pytest.approx(100e-6)
    assert tw.glue_s() == pytest.approx(60e-6)
    # each idle gap goes to the innermost host operation at its middle
    assert tw.gaps == pytest.approx({"aten::add": 50e-6,
                                     "aten::mul": 80e-6})
    bd = tw.breakdown()
    assert bd["device_ops"][0] == [CUDNN, pytest.approx(110e-6)]
    assert bd["idle_gaps"][0][0] == "aten::mul"


def test_a_window_without_device_operations_is_refused():
    with pytest.raises(RuntimeError):
        TraceWindow.from_events([_ev("aten::add", 0, 5, DeviceType.CPU)], 1)


def test_the_readers_on_a_window():
    tw = _window()
    ctx = {"trace": tw, "unit_work": 1, "untraced_s": 2.0,
           "untraced_flops": 99e12, "peak_flops": 495e12,
           "conv3x3_kernels": "AB", "conv3x3_bound_s": 13e-6}
    read = {m: run.load_reader(m)(ctx) for m in (
        "idle_share.dip", "launches_per_iter.dip", "glue_ms_per_iter.dip",
        "conv3x3_roofline.dip", "mfu.dip")}
    assert read["idle_share.dip"] == pytest.approx(100 * (1 - 280 / 410))
    assert read["launches_per_iter.dip"] == 2.5
    assert read["glue_ms_per_iter.dip"] == pytest.approx(0.03)
    assert read["conv3x3_roofline.dip"] == pytest.approx(10.0)
    assert read["mfu.dip"] == pytest.approx(10.0)
    ctx["conv3x3_bound_s"] = None  # the kernels are not on this path
    assert run.load_reader("conv3x3_roofline.dip")(ctx) is None


def test_an_incomplete_window_counts_for_nothing():
    """The completeness rule: a window that lacks a launch of the port's
    kernels is passed over."""
    tracer = Tracer({"A": 1, "B": 1}, active=2)
    full = TraceWindow(2, 4, 1.0, 2.0, {A: [2, 0.1], B: [2, 0.1]}, {})
    short = TraceWindow(2, 3, 1.0, 2.0, {A: [2, 0.1], B: [1, 0.1]}, {})
    for tw in (short, full):
        tracer._ready_window(tw)
    assert tracer.window is full
    assert tracer.incomplete == [{"A": 2, "B": 1}]
