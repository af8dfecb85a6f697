"""The plain references against the port's plain CPU path at small sizes,
and the comparison catching each fault a cell can have: each cell's
driver, set up, driven for a short window and judged as a run does it,
without the look for a card, with the timed path broken underneath."""

import pytest
import torch

from srbench import control, run
from srbench.tests.small import SMALL

SEED = 2 ** 31 + 977
CPU = torch.device("cpu")


def _files(cell):
    _, _, c, config = run.load_cell(cell)
    over = SMALL[cell]
    return {**c, **over["cell"]}, {**config, **over["config"]}


def _drive(cell, seconds=0.1):
    """(readings, limits, correct, driver) of a short run on the CPU."""
    c, config = _files(cell)
    driver = run.make_driver(c, config, SEED, CPU)
    driver.setup()
    driver.run_window(seconds)
    driver.release()
    readings = driver.check()
    compared, correct = run.judge(readings, c["checks"])
    return readings, c["checks"], correct, driver


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    readings, limits, correct, driver = _drive(cell)
    assert correct, readings
    assert driver.attempted >= 1 and driver.failed == 0
    # at small sizes on the CPU the port and the reference agree far inside
    # the limits set for the card
    for name in limits:
        assert readings[name] < 0.2 * limits[name], (name, readings[name])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    """The reference one precision below the configuration's, in the
    program's place, fails a limit."""
    c, config = _files(cell)
    got = control.control(c, config, SEED, 1, CPU)
    got = got.get("control", got)
    limits = c["checks"]
    assert any(got[k] > limits[k] for k in limits if k in got), got


def _no_step(monkeypatch):
    from tpusr_torch.engine import gan

    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    monkeypatch.setattr(gan.Bf16Adam, "step", lambda self: None)


@pytest.mark.parametrize("cell", ["dip-x8-f32", "srgan-x8-train-bf16"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    _no_step(monkeypatch)
    readings, _, correct, _ = _drive(cell)
    assert not correct
    assert readings["change_gap"] > 0.9


def test_a_window_step_that_leaves_the_state_unchanged_is_caught(
        monkeypatch):
    """The training window's own steps are held to the reference from the
    state it starts from: Adam switched off after set-up is caught."""
    from tpusr_torch.engine import gan

    c, config = _files("srgan-x8-train-bf16")
    driver = run.make_driver(c, config, SEED, CPU)
    driver.setup()
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    monkeypatch.setattr(gan.Bf16Adam, "step", lambda self: None)
    driver.run_window(0.1)
    driver.release()
    readings = driver.check()
    _, correct = run.judge(readings, c["checks"])
    assert not correct, readings
    assert readings["change_gap"] < 0.2 * c["checks"]["change_gap"]


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from tpusr_torch.engine import gan_epochs

    orig = gan_epochs.gan_train_step

    def half(state, lr_p, hr_p, config, content_loss):
        b = lr_p.shape[0] // 2
        return orig(state, lr_p[:b], hr_p[:b], config, content_loss)

    monkeypatch.setattr(gan_epochs, "gan_train_step", half)
    assert not _drive("srgan-x8-train-bf16")[2]


def test_an_image_altered_where_it_is_produced_is_caught(monkeypatch):
    from tpusr_torch.engine import gan

    orig = gan.generator_forward

    def altered(*args, **kw):
        out = orig(*args, **kw).clone()
        out[0, 0, 0, 0] += 0.01
        return out

    monkeypatch.setattr(gan, "generator_forward", altered)
    assert not _drive("srgan-x8-eval-f32")[2]


def test_steps_the_hooks_do_not_see_read_as_not_correct(monkeypatch):
    """A DIP call whose optimizer steps the recording cannot observe is
    not correct, and the run still ends with readings."""
    from srbench.drivers import dip

    monkeypatch.setattr(dip.Recorder, "__enter__", lambda self: self)
    readings, _, correct, _ = _drive("dip-x8-f32")
    assert not correct and readings["grad_gap"] == float("inf")


def test_dip_reference_init_is_the_ports():
    """The reference draws the port's initial weights and device seed from
    the same generator, leaf by leaf."""
    from tpusr_torch.engine import dip

    from srbench.reference import skipnet

    cfg = {**run.load_cell("dip-x8-f32")[3], **SMALL["dip-x8-f32"]["config"]}
    fields = {"num_scales", "skip_n33d", "skip_n33u", "input_depth",
              "skip_n11"}
    net, _ = dip.build(dip.DIPConfig(**{k: cfg[k] for k in fields}),
                       torch.Generator().manual_seed(5))
    leaves, _ = skipnet.init(cfg, torch.Generator().manual_seed(5))
    port = dict(net.named_parameters())
    assert list(leaves) == list(port)
    for k, v in leaves.items():
        assert torch.equal(v, port[k].detach()), k


@pytest.mark.cuda
def test_a_short_run_of_each_cell_is_correct_on_the_card():
    """On a card (``python -m pytest -m cuda srbench/tests``): every cell at
    its own size, a short window, `correct` true."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for cell in run.load_cell("dip-x8-f32")[0]["workloads"]:
        result = run.run(cell["name"], SEED, 1.0, False)
        assert result["correct"], (cell["name"], result["checks"])
        assert result["device"]["platform"] == "gpu"
