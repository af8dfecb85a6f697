"""The SwinIR cell (``swinir-x4-1080p-bf16``) at a small size on the CPU:
a sound short run of its driver is correct; the control, the mask left
out and the shift left out fail the cell's limits in the reference's
place; one layer's bias left out, inside bf16's rounding, shows in the
f32 build's reading alone; the readers the cell reports return numbers
from a stub window and nothing where the program has no kernel or spans;
the yardstick's numbers at the cell's frame. Only the frames are cut
here (12 x 20, padded to 16 x 24): the widths, the depth, the dtype, the
faults and the limits are the cell's."""

import pytest
import torch

from srbench import control, run, spans, yardstick_swinir
from srbench.tracing import TraceWindow

CELL = "swinir-x4-1080p-bf16"
SEED = 2 ** 31 + 1013
CPU = torch.device("cpu")
SMALL = {"lr_size": [12, 20], "frame_pool": 2}
READERS = ("window_attn_roofline.swinir", "glue_ms_per_frame.swinir",
           "body_host_ms_per_frame.swinir", "conv3x3_roofline.eval",
           "launches_per_image.eval", "idle_share.eval", "mfu.eval",
           "host_ms_per_image.eval")
F32_SOUND = 1e-5  # the f32 build against the reference: f32's rounding


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _files():
    _, _, c, config = run.load_cell(CELL)
    return {**c, **SMALL}, config


def test_a_sound_run_is_correct():
    c, config = _files()
    driver = run.make_driver(c, config, SEED, CPU)
    driver.setup()
    driver.run_window(0.1)
    driver.release()
    readings = driver.check()
    assert driver.attempted >= 1 and driver.failed == 0
    assert run.judge(readings, c["checks"])[1], readings
    # the f32 build agrees with the reference to f32's rounding
    assert readings["f32_rms_gap"] < F32_SOUND, readings


@pytest.fixture(scope="module")
def controls():
    c, config = _files()
    return control.control(c, config, SEED, 1, CPU), c["checks"]


@pytest.mark.parametrize("name", ["control", "mask_left_out", "no_shift",
                                  "bias_left_out"])
def test_the_control_and_each_fault_against_the_limits(controls, name):
    """The control, the mask left out and no shift fail a compared
    number; one layer's bias left out reads under bf16's limits and far
    above the f32 build's sound reading."""
    got, limits = controls[0][name], controls[1]
    if name == "bias_left_out":
        assert got["f32_rms_gap"] > 10 * F32_SOUND, got
    else:
        assert any(got[k] > limits[k] for k in limits), got


W_NAME = ("void (anonymous namespace)::window_attention_kernel"
          "<__nv_bfloat16>((anonymous namespace)::Params)")
A_NAME = "void (anonymous namespace)::fwd_bf16_kernel<128, false>(Params)"
GEMM = "nvjet_tst_128x192_64x4_1x2_h_bz_coopA_NNT"
GLUE = "void at::native::vectorized_elementwise_kernel<4, add>"


def _unit(name, id_, parent, call, start_ms, end_ms, profiled=False):
    return spans.Unit(name, id_, parent, call, int(start_ms * 1e6),
                      int(end_ms * 1e6), profiled, {})


def test_the_readers_return_numbers_from_a_stub_window(monkeypatch):
    tw = TraceWindow(units=2, ops=900, busy_s=0.05, window_s=0.06,
                     by_name={W_NAME: [72, 0.0072], A_NAME: [22, 0.004],
                              GEMM: [288, 0.03], GLUE: [500, 0.006]},
                     gaps={})
    ctx = {"trace": tw, "unit_work": 1, "untraced_s": 2.0,
           "untraced_flops": 4 * 3.568e12, "peak_flops": 989e12,
           "conv3x3_kernels": "A", "conv3x3_bound_s": 2 * 9.26e-4,
           "window_attn_launch_bound_s": 5.6e-5}
    monkeypatch.setattr(spans, "records", [
        _unit("gan.generator_forward", 1, None, 1, 0, 30, profiled=True),
        _unit("gan.generator_forward", 2, None, 2, 40, 52),
        _unit("swinir.body", 3, 2, 2, 41, 49),
        _unit("gan.generator_forward", 4, None, 4, 60, 70),
        _unit("swinir.body", 5, 4, 4, 61, 67)])
    got = {m: run.load_reader(m)(ctx) for m in READERS}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["window_attn_roofline.swinir"] == pytest.approx(
        100 * 72 * 5.6e-5 / 0.0072)
    # the window kernel is neither glue nor in the eval reader's library
    assert got["glue_ms_per_frame.swinir"] == pytest.approx(3.0)
    assert got["body_host_ms_per_frame.swinir"] == pytest.approx(7.0)
    assert got["conv3x3_roofline.eval"] == pytest.approx(
        100 * 2 * 9.26e-4 / 0.004)
    assert got["launches_per_image.eval"] == 450
    assert got["host_ms_per_image.eval"] == pytest.approx(11.0)
    # a program without the kernel or the spans reads nothing
    monkeypatch.setattr(spans, "records", [])
    del tw.by_name[W_NAME]
    assert run.load_reader("window_attn_roofline.swinir")(ctx) is None
    assert run.load_reader("body_host_ms_per_frame.swinir")(ctx) is None


def test_the_yardstick_at_the_cells_frame():
    _, config = _files()
    assert yardstick_swinir.padded(config, 270, 480) == (272, 480)
    # 2,040 windows x 6 heads x 2 products of 64 x 64 x 30
    ops, nbytes = yardstick_swinir.window_attention_work(
        config, 270, 480, "bfloat16", 6)
    assert ops == 2 * 2 * 2040 * 6 * 64 * 64 * 30
    assert nbytes == 272 * 480 * 720 * 2 + 225 * 6 * 4
    # bytes bound it: ~56 us a launch
    assert yardstick_swinir.window_attention_bound_s(
        config, 270, 480, "bfloat16") == pytest.approx(nbytes / 3.35e12)
    assert yardstick_swinir.swinir_flops(config, 270, 480) == pytest.approx(
        3.568e12, rel=1e-3)
    launches = yardstick_swinir.kernel_a_launches(config, 270, 480,
                                                  "bfloat16")
    # the tail's 64 -> 64 convs: conv_up1 at 2x, conv_up2 and conv_hr at 4x
    assert [nb for _, _, nb in launches] == [
        (hh * ww * 128 + 9 * 64 * 64) * 2
        for hh, ww in ((544, 960), (1088, 1920), (1088, 1920))]
