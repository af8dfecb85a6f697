"""SwinIR-M on whole frames: ``tpusr_torch.engine.gan.generator_forward(
train=False)`` with ``GANTrainConfig(generator='swinir')``, batch 1, in a
closed loop, each frame ending in a synchronise, as the eval CLI runs it
(inference mode). The window, its reservoir sample of the outputs, the
frame pool and the f32 build read beside the compared numbers are the
RRDB cell's (``rrdb_eval``).

The weights are drawn from the seed in SwinIR's published names and
layouts (``srbench.reference.swinir.make_weights``), written out with the
buffers a published file carries and taken into the program through its
importer, ``tpusr_torch.io.checkpoint.import_swinir``. A sample of the
window's outputs, drawn from the seed, is held to the f32 plain reference
afterwards (``max_gap``, ``rms_gap``). A program that cannot build SwinIR
fails in set-up, at ``build_generator``.
"""

from __future__ import annotations

import statistics

import torch

from srbench import checks, yardstick, yardstick_swinir
from srbench.drivers import rrdb_eval
from srbench.images import structured_image
from srbench.reference import swinir as reference


class Driver(rrdb_eval.Driver):
    def prepare_inputs(self) -> None:
        """The LR pool (NHWC f32 in [0, 1]) and the weights."""
        h, w = self.cell["lr_size"]
        self.pool = [structured_image(self._seed(0, i), h, w,
                                      self.device)[None]
                     for i in range(int(self.cell["frame_pool"]))]
        self.weights = reference.make_weights(self.cfg, self._seed(1),
                                              self.device)

    def _program(self, dtype: str | None):
        """The program's SwinIR in ``dtype`` with the seed's weights,
        through the importer, and its config."""
        from tpusr_torch.engine import gan

        config = gan.GANTrainConfig(generator="swinir",
                                    factor=self.cfg["upscale"], dtype=dtype)
        net = gan.build_generator(config, self.device)
        from tpusr_torch.io.checkpoint import import_swinir

        net.load_state_dict(import_swinir(reference.published_state_dict(
            self.weights, self.cfg)), strict=True)
        return net.eval(), config

    def end_to_end(self) -> dict:
        h, w = self.cell["lr_size"]
        px = h * w * self.cfg["upscale"] ** 2 * len(self.times)
        return {"sr_mpix_s": px / self.window_s / 1e6,
                "sr_p95_ms": statistics.quantiles(self.times, n=20)[18]
                * 1e3}

    def layer_context(self) -> dict:
        h, w = self.cell["lr_size"]
        dtype = self.cell["dtype"]
        untraced = [t for t, tr in zip(self.times, self.traced) if not tr]
        ctx = {"unit_work": 1, "untraced_s": sum(untraced),
               "untraced_flops": yardstick_swinir.swinir_flops(self.cfg, h, w)
               * len(untraced),
               "peak_flops": yardstick.PEAK_FLOPS[dtype],
               "conv3x3_kernels": "A", "conv3x3_bound_s": None,
               "window_attn_launch_bound_s":
                   yardstick_swinir.window_attention_bound_s(self.cfg, h, w,
                                                             dtype)}
        tw = self.tracer.window if self.tracer is not None else None
        if tw is not None:
            ctx["conv3x3_bound_s"] = tw.units * sum(
                yardstick.bound_s(fl, nb, dtype) for _, fl, nb in
                yardstick_swinir.kernel_a_launches(self.cfg, h, w, dtype))
        return ctx

    def _reference(self, idx: int, **kw) -> torch.Tensor:
        return reference.forward(self.weights, self.pool[idx], self.cfg,
                                 **kw)

    def control(self, calls: int) -> dict:
        """The control (fp8 operands) and the faults (the mask left out of
        every shifted layer, no layer shifted, one layer's bias left out)
        in the program's place, in both of its comparisons."""
        got = {"control": [], "mask_left_out": [], "no_shift": [],
               "bias_left_out": []}
        faults = (("mask_left_out", ("mask", "all")),
                  ("no_shift", ("shift", "all")),
                  ("bias_left_out", ("bias", self.cell["faults"]["bias"])))
        for idx in range(calls):
            ref = self._reference(idx)
            got["control"].append(checks.image_gaps(
                self._reference(idx, low="fp8"), ref))
            for name, fault in faults:
                gaps = checks.image_gaps(self._reference(idx, fault=fault),
                                         ref)
                got[name].append({**gaps, "f32_rms_gap": gaps["rms_gap"]})
        return {k: checks.worst(v) for k, v in got.items()}
