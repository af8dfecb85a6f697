"""SRGAN evaluation of full images: ``tpusr_torch.engine.gan.
generator_forward(train=False)``, batch 1, in a closed loop, each image
ending in a synchronise, as the eval CLI runs it (inference mode).

The images come from a pool made in set-up on the card, half landscape
and half portrait; the window walks through it in seeded permutations of
the whole pool, so every seed sends the same sizes in another order. The
generator's weights and BatchNorm statistics are made from the seed and
loaded into the program. A sample of the window's outputs, drawn from the
seed, is kept and held to the plain reference afterwards.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from srbench import checks, yardstick
from srbench.images import structured_image
from srbench.reference import srgan as reference


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.cfg, self.cell, self.device = config, cell, device
        self.seq = np.random.SeedSequence(seed)
        self.rng = np.random.default_rng(self.seq.spawn(1)[0])
        self.tracer = None

    def _seed(self, *key: int) -> int:
        return int(np.random.SeedSequence(self.seq.entropy,
                                          spawn_key=key).generate_state(
                                              1, np.uint64)[0] >> 2)

    def prepare_inputs(self) -> None:
        """The LR pool (NHWC f32 in [0, 1]) and the weights."""
        sizes = self.cell["lr_sizes"]
        n = int(self.cell["image_pool"])
        self.pool = [structured_image(self._seed(0, i),
                                      *sizes[i % len(sizes)],
                                      self.device)[None]
                     for i in range(n)]
        self.weights = reference.make_weights(self.cfg, self._seed(1),
                                              self.device)

    def setup(self) -> None:
        from tpusr_torch.engine import gan

        self.gan = gan
        self.config = gan.GANTrainConfig(
            factor=self.cfg["factor"],
            residual_blocks_count=self.cfg["residual_blocks_count"],
            dtype=self.cell["dtype"])
        self.prepare_inputs()
        self.net = gan.build_generator(self.config, self.device)
        self.net.load_state_dict(self.weights, strict=True)
        self.net.eval()
        with torch.inference_mode():  # every shape of the window, twice
            for img in self.pool[:len(self.cell["lr_sizes"])] * 2:
                gan.generator_forward(self.net, img, self.config)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_window(self, seconds: float) -> None:
        n = len(self.pool)
        keep = int(self.cell["check_samples"])
        self.times, self.traced, self.kept = [], [], []
        self.order_seen = []
        order: list[int] = []
        if self.tracer is not None:
            self.tracer.start()
        start = time.perf_counter()
        with torch.inference_mode():
            while (time.perf_counter() - start < seconds
                   or self.tracer is not None and self.tracer.running):
                if not order:
                    order = list(self.rng.permutation(n))
                idx = int(order.pop())
                traced = self.tracer is not None and self.tracer.running
                t0 = time.perf_counter()
                out = self.gan.generator_forward(self.net, self.pool[idx],
                                                 self.config)
                self._sync()
                self.times.append(time.perf_counter() - t0)
                self.order_seen.append(idx)
                self.traced.append(traced)
                k = len(self.times)  # reservoir sample of the outputs
                if len(self.kept) < keep:
                    self.kept.append((idx, out))
                elif (j := int(self.rng.integers(k))) < keep:
                    self.kept[j] = (idx, out)
                if traced:
                    self.tracer.step()
        self.window_s = time.perf_counter() - start
        if self.tracer is not None:
            self.tracer.stop()

    @property
    def attempted(self) -> int:
        return len(self.times)

    failed = 0

    def describe(self) -> str:
        """Quartiles of the image times (ms) by input size."""
        by = {}
        for i, t in zip(self.order_seen, self.times):
            by.setdefault(tuple(self.pool[i].shape[1:3]), []).append(t * 1e3)
        return "; ".join(
            f"{h}x{w}: {len(v)} images, ms quartiles " + " ".join(
                f"{q:.3f}" for q in statistics.quantiles(v, n=4))
            for (h, w), v in sorted(by.items()) if len(v) > 1)

    def end_to_end(self) -> dict:
        _, h, w, _ = self.pool[0].shape  # every size has one pixel count
        px = h * w * self.cfg["factor"] ** 2 * len(self.times)
        return {"sr_mpix_s": px / self.window_s / 1e6,
                "sr_p95_ms": statistics.quantiles(self.times, n=20)[18]
                * 1e3}

    def layer_context(self) -> dict:
        h, w = self.cell["lr_sizes"][0]
        dtype = self.cell["dtype"]
        flops = sum(c.fwd_flops() for c in
                    yardstick.srgan_generator_convs(self.cfg, h, w))
        untraced = [t for t, tr in zip(self.times, self.traced) if not tr]
        ctx = {"unit_work": 1, "untraced_s": sum(untraced),
               "untraced_flops": flops * len(untraced),
               "peak_flops": yardstick.PEAK_FLOPS[dtype],
               "conv3x3_kernels": "A", "conv3x3_bound_s": None}
        tw = self.tracer.window if self.tracer is not None else None
        if tw is not None:
            ctx["conv3x3_bound_s"] = tw.units * sum(
                yardstick.bound_s(fl, nb, dtype) for _, fl, nb in
                yardstick.srgan_eval_launches(self.cfg, h, w, dtype))
        return ctx

    def expected_launches(self) -> dict:
        return {"A": 36}

    def release(self) -> None:
        del self.net

    def check(self) -> dict:
        readings = []
        for idx, out in self.kept:
            ref = reference.forward(self.weights, self.pool[idx], self.cfg)
            readings.append(checks.image_gaps(out, ref))
        return checks.worst(readings)

    def control(self, calls: int) -> dict:
        readings = []
        for idx in range(calls):
            ref, low = (reference.forward(self.weights, self.pool[idx],
                                          self.cfg, dt)
                        for dt in (torch.float32, torch.bfloat16))
            readings.append(checks.image_gaps(low, ref))
        return checks.worst(readings)
