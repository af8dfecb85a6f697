"""DIP super-resolution: ``tpusr_torch.engine.dip.dip_superresolve`` (one
image per call) or, with ``lanes`` > 1 in the cell, ``dip_superresolve_batch``
(that many images per call, each on its own net), in a closed loop.

Every call is a whole image job: a fresh net from its own CPU generator,
``num_iter`` Adam iterations, the metric heads and the resolve; the call
returns with its curves on the host, so it ends synchronised. The window
starts calls until the next one would end, by the mean so far, past
``--seconds``, and makes at least ``min_calls``. The first three
optimizer steps of every call in the window are recorded through
PyTorch's global optimizer-step hooks (no name of the program is
replaced) and held to the plain reference afterwards.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import weakref

import numpy as np
import torch

from srbench import checks, yardstick
from srbench.images import downscale, structured_image, to_uint8
from srbench.reference import skipnet

STEPS = 3  # iterations of each call held to the reference


class Recorder:
    """While entered, records each optimizer's first STEPS steps: its
    leaves before step 1 and after step STEPS, and Adam's first moments
    after step 1 (an optimizer that steps for the first time starts a new
    call); steps the tracer after every step."""

    def __init__(self, tracer=None):
        self.tracer, self.calls = tracer, []
        self._opt = lambda: None
        self._handles = []

    def __enter__(self) -> "Recorder":
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)

        self._handles = [register_optimizer_step_pre_hook(self._pre),
                         register_optimizer_step_post_hook(self._post)]
        return self

    def __exit__(self, *exc) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    @staticmethod
    def _leaves(opt) -> list:
        return [p for g in opt.param_groups for p in g["params"]]

    def _pre(self, opt, args, kwargs) -> None:
        if self._opt() is not opt:
            self._opt = weakref.ref(opt)
            self.calls.append({"steps": 0, "p0": [
                p.detach().clone() for p in self._leaves(opt)]})

    def _post(self, opt, args, kwargs) -> None:
        rec = self.calls[-1]
        rec["steps"] += 1
        leaves = self._leaves(opt)
        if rec["steps"] == 1:
            beta1 = opt.param_groups[0]["betas"][0]
            rec["g1"] = [opt.state[p]["exp_avg"] / (1 - beta1)
                         if "exp_avg" in opt.state[p]
                         else torch.zeros_like(p) for p in leaves]
        if rec["steps"] == STEPS:
            rec["p3"] = [p.detach().clone() for p in leaves]
        if self.tracer is not None:
            self.tracer.step()

    def program_steps(self, call: int, lane: int | None, names) -> dict:
        """The program's readings of one lane (None: the only one) of one
        call, under the reference's leaf names, in the program's order."""
        rec = self.calls[call] if call < len(self.calls) else {}
        if "p3" not in rec:
            raise LookupError(f"call {call}: {rec.get('steps', 0)} optimizer "
                              f"steps seen, {STEPS} needed")
        get = (lambda t: t) if lane is None else (lambda t: t[lane])
        if len(rec["p0"]) != len(names):
            raise LookupError(f"call {call}: {len(rec['p0'])} leaves, the "
                              f"reference has {len(names)}")
        return {"grad1": {n: get(g) for n, g in zip(names, rec["g1"])},
                "change": {n: get(b) - get(a) for n, a, b in
                           zip(names, rec["p0"], rec["p3"])}}


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.cfg, self.cell, self.device = config, cell, device
        self.lanes = int(cell.get("lanes", 1))
        self.seq = np.random.SeedSequence(seed)
        self.tracer = None
        self.calls: list[dict] = []

    # ---------------------------------------------------------- set-up
    def _seed(self, *key: int) -> int:
        return int(np.random.SeedSequence(self.seq.entropy,
                                          spawn_key=key).generate_state(
                                              1, np.uint64)[0] >> 2)

    def prepare_inputs(self) -> None:
        """The pool of HR and LR images (uint8, as files hold them)."""
        h, w = self.cfg["hr_size"]
        f = self.cfg["factor"]
        self.pool = []
        for i in range(int(self.cell["image_pool"]) * self.lanes):
            hr = structured_image(self._seed(0, i), h, w, self.device)
            self.pool.append((to_uint8(downscale(hr, f))[None],
                              to_uint8(hr)[None]))

    def setup(self) -> None:
        from tpusr_torch.engine import dip as engine

        self.engine = engine
        fields = {f.name for f in dataclasses.fields(engine.DIPConfig)}
        over = {k: v for k, v in {**self.cfg, **self.cell}.items()
                if k in fields}
        self.config = engine.DIPConfig(**over)
        self.prepare_inputs()
        # warm-up: every shape of a call (forward, backward, Adam, a head,
        # the resolve) in a short call of the same entry
        self._call(dataclasses.replace(self.config, num_iter=STEPS), 0,
                   warm=True)

    def _images(self, call: int):
        n = len(self.pool)
        return [self.pool[(call * self.lanes + i) % n]
                for i in range(self.lanes)]

    def _call(self, config, call: int, warm: bool = False):
        imgs = self._images(call)
        gens = [torch.Generator().manual_seed(self._seed(2 if warm else 1,
                                                         call, i))
                for i in range(self.lanes)]
        if self.lanes == 1:
            (lr, hr), = imgs
            out, curves = self.engine.dip_superresolve(
                lr, hr, config, gens[0], self.device)
        else:
            lr = torch.stack([a for a, _ in imgs])
            hr = torch.stack([b for _, b in imgs])
            out, curves = self.engine.dip_superresolve_batch(
                lr, hr, gens, config, self.device)
        return out, curves

    # ---------------------------------------------------------- window
    def run_window(self, seconds: float) -> None:
        min_calls = int(self.cell["min_calls"])
        self.recorder = Recorder(self.tracer)
        if self.tracer is not None:
            self.tracer.start()
        try:
            with self.recorder:
                start = time.perf_counter()
                while True:
                    k = len(self.calls)
                    t0 = time.perf_counter()
                    out, curves = self._call(self.config, k)
                    t1 = time.perf_counter()
                    if self.tracer is not None:  # one call at most
                        self.tracer.stop()
                        self.recorder.tracer = None
                    self.calls.append({"s": t1 - t0,
                                       "finite": bool(np.isfinite(
                                           curves["loss"]).all())})
                    del out
                    done = t1 - start
                    mean = done / len(self.calls)
                    if (len(self.calls) >= min_calls
                            and done + mean / 2 >= seconds):
                        break
        finally:
            if self.tracer is not None:
                self.tracer.stop()
        self.window_s = time.perf_counter() - start

    # ---------------------------------------------------------- results
    @property
    def attempted(self) -> int:
        return len(self.calls) * self.lanes

    @property
    def failed(self) -> int:
        return sum(not c["finite"] for c in self.calls) * self.lanes

    def describe(self) -> str:
        return "call seconds " + " ".join(f"{c['s']:.3f}"
                                          for c in self.calls)

    def end_to_end(self) -> dict:
        iters = len(self.calls) * self.config.num_iter * self.lanes
        return {self.cell["metric"]: self.window_s * 1e3 / iters}

    def layer_context(self) -> dict:
        h, w = self.cfg["hr_size"]
        dtype = self.config.dtype
        train, fwd = yardstick.dip_flops(self.cfg, h, w, self.lanes)
        heads = -(-self.config.num_iter // self.config.log_freq) + 1
        per_call = self.config.num_iter * train + heads * fwd
        untraced = self.calls[1:] if self.tracer is not None else self.calls
        ctx = {"unit_work": self.lanes,
               "untraced_s": sum(c["s"] for c in untraced),
               "untraced_flops": per_call * len(untraced),
               "peak_flops": yardstick.PEAK_FLOPS[dtype],
               "conv3x3_kernels": "AB", "conv3x3_bound_s": None}
        fused = (self.lanes == 1 and self.config.conv_fusion == "auto")
        tw = self.tracer.window if self.tracer is not None else None
        if fused and tw is not None:
            ctx["conv3x3_bound_s"] = tw.units * sum(
                yardstick.bound_s(fl, nb, dtype) for _, fl, nb in
                yardstick.dip_fused_launches(self.cfg, h, w, dtype))
        return ctx

    def expected_launches(self) -> dict:
        fused = self.lanes == 1 and self.config.conv_fusion == "auto"
        return {"A": 20, "B": 10} if fused else {}

    def release(self) -> None:
        self.recorder.tracer = None

    def check(self) -> dict:
        """Worst readings over every lane of every call in the window; a
        call whose first steps the hooks did not see reads infinite."""
        readings = []
        for k in range(len(self.calls)):
            for i, (lr, _) in enumerate(self._images(k)):
                gen = torch.Generator().manual_seed(self._seed(1, k, i))
                lr_f = lr.float().div(255.0).permute(0, 3, 1, 2)
                ref = skipnet.first_steps(self.cfg, gen, lr_f, self.device,
                                          STEPS)
                try:
                    prog = self.recorder.program_steps(
                        k, i if self.lanes > 1 else None, list(ref["grad1"]))
                except LookupError as e:
                    print(f"srbench: not observed: {e}", file=sys.stderr)
                    return {"grad_gap": float("inf"),
                            "change_gap": float("inf")}
                readings.append(checks.training_gaps(prog, ref))
        return checks.worst(readings)

    def control(self, calls: int) -> dict:
        """The control: the reference in bf16 in the program's place, on
        the inputs of the window's first ``calls`` calls."""
        readings = []
        for k in range(calls):
            for i, (lr, _) in enumerate(self._images(k)):
                lr_f = lr.float().div(255.0).permute(0, 3, 1, 2)
                ref, low = (skipnet.first_steps(
                    self.cfg, torch.Generator().manual_seed(
                        self._seed(1, k, i)), lr_f, self.device, STEPS, dt)
                    for dt in (torch.float32, torch.bfloat16))
                readings.append(checks.training_gaps(low, ref))
        return checks.worst(readings)
