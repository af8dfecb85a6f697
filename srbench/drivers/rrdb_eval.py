"""ESRGAN's RRDBNet on whole frames: ``tpusr_torch.engine.gan.
generator_forward(train=False)`` with ``GANTrainConfig(generator='rrdb')``,
batch 1, in a closed loop, each frame ending in a synchronise, as the eval
CLI runs it (inference mode). The window, its reservoir sample of the
outputs and the end-to-end numbers are SRGAN eval's (``srgan_eval``).

The frames come from a pool of seeded structured images made in set-up on
the card, all of the cell's LR size; the window walks through the pool in
seeded permutations. The weights are drawn from the seed in ESRGAN's
published names and layout (``srbench.reference.rrdb.make_weights``) and
go into the program through its importer, ``tpusr_torch.io.checkpoint.
import_esrgan_rrdbnet``. A sample of the window's outputs, drawn from the
seed, is held to the f32 plain reference afterwards (``max_gap``,
``rms_gap``). One dense block of 69 left out moves the output by about as
much as bf16's own rounding, so these do not part that fault. The
program's f32 build of the same model, TF32 off, runs the sampled frames
once more (``f32_rms_gap``): read beside them, not compared, since that
build runs neither the timed kernel nor its packing.
"""

from __future__ import annotations

import statistics

import torch

from srbench import checks, yardstick, yardstick_rrdb
from srbench.drivers import srgan_eval
from srbench.images import structured_image
from srbench.reference import rrdb as reference
from srbench.reference.skipnet import exact_f32


class Driver(srgan_eval.Driver):
    def prepare_inputs(self) -> None:
        """The LR pool (NHWC f32 in [0, 1]) and the weights."""
        h, w = self.cell["lr_size"]
        self.pool = [structured_image(self._seed(0, i), h, w,
                                      self.device)[None]
                     for i in range(int(self.cell["frame_pool"]))]
        self.weights = reference.make_weights(self.cfg, self._seed(1),
                                              self.device)

    def _program(self, dtype: str | None):
        """The program's RRDBNet in ``dtype`` with the seed's weights,
        through the importer, and its config."""
        from tpusr_torch.engine import gan
        from tpusr_torch.io.checkpoint import import_esrgan_rrdbnet

        config = gan.GANTrainConfig(
            generator="rrdb", factor=self.cfg["scale"],
            rrdb_blocks=self.cfg["nb"], dtype=dtype)
        net = gan.build_generator(config, self.device)
        net.load_state_dict(import_esrgan_rrdbnet(
            self.weights, self.cfg["nb"], reference.octaves(self.cfg)),
            strict=True)
        return net.eval(), config

    def setup(self) -> None:
        from tpusr_torch.engine import gan

        self.gan = gan
        self.prepare_inputs()
        self.net, self.config = self._program(self.cell["dtype"])
        with torch.inference_mode():  # the window's one shape, twice
            for img in self.pool[:2]:
                gan.generator_forward(self.net, img, self.config)
        self._sync()

    def end_to_end(self) -> dict:
        h, w = self.cell["lr_size"]
        px = h * w * self.cfg["scale"] ** 2 * len(self.times)
        return {"sr_mpix_s": px / self.window_s / 1e6,
                "sr_p95_ms": statistics.quantiles(self.times, n=20)[18]
                * 1e3}

    def layer_context(self) -> dict:
        h, w = self.cell["lr_size"]
        dtype = self.cell["dtype"]
        untraced = [t for t, tr in zip(self.times, self.traced) if not tr]
        ctx = {"unit_work": 1, "untraced_s": sum(untraced),
               "untraced_flops": yardstick_rrdb.rrdbnet_flops(self.cfg, h, w)
               * len(untraced),
               "peak_flops": yardstick.PEAK_FLOPS[dtype],
               "conv3x3_kernels": "A", "conv3x3_bound_s": None,
               "dense_block_bound_s": None}
        tw = self.tracer.window if self.tracer is not None else None
        if tw is not None:
            ctx["conv3x3_bound_s"] = tw.units * sum(
                yardstick.bound_s(fl, nb, dtype) for _, fl, nb in
                yardstick_rrdb.kernel_a_launches(self.cfg, h, w, dtype))
            # summed over the window's kernel-C launches
            ctx["dense_block_bound_s"] = tw.launches("C") * \
                yardstick_rrdb.dense_block_bound_s(self.cfg, h, w, dtype)
        return ctx

    def expected_launches(self) -> dict:
        return dict(self.cell["expected_launches"])

    def _reference(self, idx: int, **kw) -> torch.Tensor:
        return reference.forward(self.weights, self.pool[idx], self.cfg,
                                 **kw)

    def check(self) -> dict:
        """The sampled window outputs against the f32 reference; the
        program's f32 build on the same frames, TF32 off, likewise."""
        refs = {idx: self._reference(idx) for idx, _ in self.kept}
        readings = [checks.image_gaps(out, refs[idx])
                    for idx, out in self.kept]
        net, config = self._program(None)
        with torch.inference_mode(), exact_f32():
            f32 = [checks.image_gaps(self.gan.generator_forward(
                net, self.pool[idx], config), ref)["rms_gap"]
                for idx, ref in refs.items()]
        del net
        return {**checks.worst(readings), "f32_rms_gap": max(f32)}

    def control(self, calls: int) -> dict:
        """The control (fp8 operands) in the bf16 program's place, and the
        faults (one dense block left out; one RRDB's outer 0.2 dropped) in
        the program's place, in both of its comparisons."""
        faults = self.cell["faults"]
        got = {"control": [], "block_left_out": [], "rrdb_unscaled": []}
        for idx in range(calls):
            ref = self._reference(idx)
            got["control"].append(checks.image_gaps(
                self._reference(idx, low="fp8"), ref))
            for name, fault in (("block_left_out", ("block", faults["block"])),
                                ("rrdb_unscaled", ("scale", faults["scale"]))):
                gaps = checks.image_gaps(self._reference(idx, fault=fault),
                                         ref)
                got[name].append({**gaps, "f32_rms_gap": gaps["rms_gap"]})
        return {k: checks.worst(v) for k, v in got.items()}
