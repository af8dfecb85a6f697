"""The RRDB cell (``rrdb-x4-1080p-bf16``) at a small size on the CPU: a
sound short run of its driver is correct; the control and the unscaled
RRDB fail the cell's limits, in the reference's place and in the program;
a dense block left out, inside bf16's rounding, shows in the f32 build's
reading alone; the readers the cell reports return numbers from a stub
window. Only the frames are cut here (12 x 20): the widths, the depth, the
dtype, the faults and the limits are the cell's, since an output's gaps
grow with the depth its rounding passes through."""

import pytest
import torch

from srbench import control, run, spans
from srbench.tracing import TraceWindow

CELL = "rrdb-x4-1080p-bf16"
SEED = 2 ** 31 + 1013
CPU = torch.device("cpu")
SMALL = {"lr_size": [12, 20], "frame_pool": 2}
READERS = ("dense_block_roofline.rrdb", "pack_host_ms_per_frame.rrdb",
           "conv3x3_roofline.eval", "launches_per_image.eval",
           "glue_ms_per_image.eval", "idle_share.eval", "mfu.eval",
           "host_ms_per_image.eval")
F32_SOUND = 1e-5  # the f32 build against the reference: f32's rounding


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _files():
    _, _, c, config = run.load_cell(CELL)
    return {**c, **SMALL}, config


def _drive():
    """(readings, limits, correct) of a short run on the CPU."""
    c, config = _files()
    driver = run.make_driver(c, config, SEED, CPU)
    driver.setup()
    driver.run_window(0.1)
    driver.release()
    readings = driver.check()
    assert driver.attempted >= 1 and driver.failed == 0
    return readings, c["checks"], run.judge(readings, c["checks"])[1]


def test_a_sound_run_is_correct():
    readings, limits, correct = _drive()
    assert correct, readings
    # the f32 build agrees with the reference to f32's rounding
    assert readings["f32_rms_gap"] < F32_SOUND, readings


@pytest.mark.parametrize("name", ["control", "rrdb_unscaled",
                                  "block_left_out"])
def test_the_control_and_each_fault_fail_the_limits(name):
    """The control and the unscaled RRDB fail a compared number; the
    left-out block reads under bf16's limits and far above the f32
    build's sound reading."""
    c, config = _files()
    got = control.control(c, config, SEED, 1, CPU)[name]
    limits = c["checks"]
    if name == "block_left_out":
        assert got["f32_rms_gap"] > 100 * F32_SOUND, got
    else:
        assert any(got[k] > limits[k] for k in limits), got


def _count_calls(monkeypatch, cls, every: int, at: int, replace):
    """Patch ``cls.forward`` so that its call number ``at`` of every
    ``every`` (one module of a net's forward) returns ``replace``'s."""
    orig, calls = cls.forward, [0]

    def forward(self, x, packed=None):
        n, calls[0] = calls[0], calls[0] + 1
        if n % every == at:
            return replace(self, x, packed, orig)
        return orig(self, x, packed)

    monkeypatch.setattr(cls, "forward", forward)


@pytest.mark.parametrize("fault", ["block_left_out", "rrdb_unscaled"])
def test_a_fault_in_the_program_shows(monkeypatch, fault):
    """Both faults move the f32 build's reading; the unscaled RRDB also
    fails a compared number."""
    from tpusr_torch.models import rrdb

    c, config = _files()
    nb = config["nb"]
    at = c["faults"]["block" if fault == "block_left_out" else "scale"]
    if fault == "block_left_out":
        _count_calls(monkeypatch, rrdb.DenseBlock, 3 * nb, at,
                     lambda self, x, packed, orig: x)
    else:
        def unscaled(self, x, packed, orig):
            out = x
            for j in range(3):
                out = getattr(self, f"rdb{j + 1}")(
                    out, None if packed is None else packed[j])
            return x + out

        _count_calls(monkeypatch, rrdb.RRDB, nb, at, unscaled)
    readings, limits, correct = _drive()
    assert readings["f32_rms_gap"] > 100 * F32_SOUND, readings
    if fault == "rrdb_unscaled":
        assert not correct, readings


C_NAME = "void (anonymous namespace)::dense_block_kernel_bf16(Params)"
A_NAME = "void (anonymous namespace)::fwd_bf16_kernel<64, true>(Params)"
GLUE = "void at::native::vectorized_elementwise_kernel<4, add>"


def _unit(name, id_, parent, call, start_ms, end_ms, profiled=False):
    return spans.Unit(name, id_, parent, call, int(start_ms * 1e6),
                      int(end_ms * 1e6), profiled, {})


def test_the_readers_return_numbers_from_a_stub_window(monkeypatch):
    tw = TraceWindow(units=2, ops=300, busy_s=0.05, window_s=0.06,
                     by_name={C_NAME: [138, 0.04], A_NAME: [8, 0.006],
                              GLUE: [154, 0.002]}, gaps={})
    ctx = {"trace": tw, "unit_work": 1, "untraced_s": 2.0,
           "untraced_flops": 4 * 4.647e12, "peak_flops": 989e12,
           "conv3x3_kernels": "A", "conv3x3_bound_s": 2 * 3.665e-4,
           "dense_block_bound_s": 138 * 6.28e-5}
    monkeypatch.setattr(spans, "records", [
        _unit("gan.generator_forward", 1, None, 1, 0, 30, profiled=True),
        _unit("gan.generator_forward", 2, None, 2, 40, 52),
        _unit("rrdb.pack", 3, 2, 2, 41, 42.5),
        _unit("gan.generator_forward", 4, None, 4, 60, 70),
        _unit("rrdb.pack", 5, 4, 4, 61, 62.5)])
    got = {m: run.load_reader(m)(ctx) for m in READERS}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["dense_block_roofline.rrdb"] == pytest.approx(
        100 * 138 * 6.28e-5 / 0.04)
    assert got["conv3x3_roofline.eval"] == pytest.approx(
        100 * 2 * 3.665e-4 / 0.006)
    assert got["launches_per_image.eval"] == 150
    assert got["glue_ms_per_image.eval"] == pytest.approx(1.0)
    assert got["idle_share.eval"] == pytest.approx(100 / 6)
    assert got["mfu.eval"] == pytest.approx(100 * 2 * 4.647e12 / 989e12)
    assert got["host_ms_per_image.eval"] == pytest.approx(11.0)
    assert got["pack_host_ms_per_frame.rrdb"] == pytest.approx(1.5)
    # a program without the kernel or the spans reads nothing
    monkeypatch.setattr(spans, "records", [])
    ctx["dense_block_bound_s"] = None
    assert all(run.load_reader(m)(ctx) is None for m in (
        "dense_block_roofline.rrdb", "host_ms_per_image.eval",
        "pack_host_ms_per_frame.rrdb"))


def test_the_cell_reports_its_readers():
    """The per-layer metrics of a traced run of the cell are READERS."""
    bench, _, _, _ = run.load_cell(CELL)
    got = {m["name"] for m in run.cell_metrics(bench, CELL, trace=True)}
    assert got == set(READERS)
