"""SRGAN training: ``tpusr_torch.engine.gan_epochs.gan_train_epochs``
(through ``gan_train_step``) on image stacks held on the card, patches
cropped there, the VGG19 content loss of ``engine.losses.
make_content_loss``.

Set-up makes the weights of G, D and VGG19 and the image stacks from the
seed and builds one training state. It drives that state through its
first three steps in two calls of the trainer on the stack's first
batches (one step, then two), reading the state's leaves and Adam
moments between them; then through a call of one epoch and one of two
over the whole stack, which warm every shape and time an epoch and a
call's metric forwards. The state is then copied to the host (a
snapshot) and trains for the window: one call whose ``n_epochs`` those
times size to fill ``--seconds``; its epoch 0 runs the metric forwards,
as every call does. Afterwards the plain reference follows the first
three steps from the seed, and the window's first three steps from the
snapshot; the window's are read from the losses the trainer returns.
Nothing of the program is replaced: the traced run steps the profiler
from a forward pre-hook on G (once per training step).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from srbench import checks, yardstick
from srbench.images import downscale, structured_image, to_uint8
from srbench.reference import srgan as gref
from srbench.reference import srgan_train as ref

STEPS = 3


class Driver:
    CONTROL_AFTER_WINDOW = True  # the control starts from the window's state

    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.cfg = {**config, **cell["train"]}
        self.cell, self.device = cell, device
        self.seq = np.random.SeedSequence(seed)
        self.tracer = None

    def _seed(self, *key: int) -> int:
        return int(np.random.SeedSequence(self.seq.entropy,
                                          spawn_key=key).generate_state(
                                              1, np.uint64)[0] >> 2)

    def prepare_inputs(self) -> None:
        """Weights of G, D, VGG19 and the uint8 image stacks."""
        cfg, dev = self.cfg, self.device
        self.g_w = gref.make_weights(cfg, self._seed(1), dev)
        self.d_w = ref.make_d_weights(cfg["hr_patch"], self._seed(2), dev)
        self.vgg = ref.make_vgg_weights(self._seed(3), dev)
        h, w = self.cell["hr_size"]
        f = cfg["factor"]
        lr, hr = [], []
        for i in range(int(self.cell["images"])):
            img = structured_image(self._seed(0, i), h, w, dev)
            hr.append(to_uint8(img))
            lr.append(to_uint8(downscale(img, f)))
        self.lr_u8, self.hr_u8 = torch.stack(lr), torch.stack(hr)
        self.valid = torch.tensor([[h // f, w // f]] * len(lr),
                                  dtype=torch.int32, device=dev)
        self.data_seed = self._seed(4)

    def setup(self) -> None:
        from tpusr_torch.engine import gan, gan_epochs, losses

        self.gan, self.epochs = gan, gan_epochs
        cfg = self.cfg
        self.config = gan.GANTrainConfig(
            factor=cfg["factor"], batch_size=cfg["batch_size"],
            hr_patch=cfg["hr_patch"],
            residual_blocks_count=cfg["residual_blocks_count"],
            dtype=cfg["dtype"], adv_weight=cfg["adv_weight"],
            d_moments=cfg["d_moments"], d_params=cfg["d_params"])
        self.prepare_inputs()
        G = gan.build_generator(self.config, self.device)
        G.load_state_dict(self.g_w, strict=True)
        D = gan.Discriminator(cfg["hr_patch"], gan.torch_dtype(self.config),
                              self.device)
        D.load_state_dict(self.d_w, strict=True)
        self.state = gan.create_gan_state(self.config, cfg["pre_train_lr"],
                                          G=G, D=D, device=self.device)
        self.content = losses.make_content_loss(self.vgg)
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.data_seed)
        b = cfg["batch_size"]
        self.steps_per_epoch = len(self.lr_u8) // b
        # the first three steps, through the trainer's own call and feed
        self.first = {"p0": self._host(self._params())}
        logs = self._train(1, slice(0, b))
        self.first["loss"] = [float(logs["losses_D"][0, 0]),
                              float(logs["losses_G"][0, 0])]
        self.first["g1"] = {k: m / (1 - ref.B1) for k, m in
                            self._host(self._moments()[0]).items()}
        self._train(1, slice(b, STEPS * b))
        self.first["p3"] = self._host(self._params())
        # every shape of the window, and the time of an epoch and of a
        # call's metric forwards
        t1, t2 = self._timed(1), self._timed(2)
        self.epoch_s = max(t2 - t1, t2 / 4)
        self.metrics_s = max(t1 - self.epoch_s, 0.0)
        self.snapshot = self._snapshot()

    def _params(self) -> dict:
        st = self.state
        return {**{f"G.{k}": p for k, p in st.G.named_parameters()},
                **{f"D.{k}": p for k, p in st.D.named_parameters()}}

    def _moments(self) -> tuple[dict, dict, int]:
        """Adam's (m, v, count) of both nets, under the leaves' names."""
        names = list(self._params())
        cg, mg, vg = self.gan.adam_moments(self.state.opt_G)
        cd, md, vd = self.gan.adam_moments(self.state.opt_D)
        if cg != cd:
            raise RuntimeError(f"G's Adam at step {cg}, D's at {cd}")
        return dict(zip(names, mg + md)), dict(zip(names, vg + vd)), cg

    @staticmethod
    def _host(tensors: dict) -> dict:
        """f32 copies on the host."""
        return {k: t.detach().to("cpu", torch.float32, copy=True)
                for k, t in tensors.items()}

    def _snapshot(self) -> dict:
        """The state's leaves, Adam moments and count, and the crop
        generator's state, on the host."""
        m, v, count = self._moments()
        return {"params": self._host(self._params()), "m": self._host(m),
                "v": self._host(v), "count": count,
                "gen_state": self.gen.get_state()}

    def _train(self, n_epochs: int, images: slice = slice(None)):
        self.state, logs = self.epochs.gan_train_epochs(
            self.state, self.lr_u8[images], self.hr_u8[images],
            self.valid[images], self.gen, self.config, self.content,
            n_epochs=n_epochs)
        return logs

    def _timed(self, n_epochs: int) -> float:
        self._sync()
        t0 = time.perf_counter()
        self._train(n_epochs)
        self._sync()
        return time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_window(self, seconds: float) -> None:
        self.n_epochs = max(1, round((seconds - self.metrics_s)
                                     / self.epoch_s))
        first = self.state.step
        marks = {}
        hook = None
        if self.tracer is not None:
            def step(module, args):
                if torch.is_grad_enabled() and self.tracer.running:
                    self.tracer.step()
                    if not self.tracer.running:
                        marks["stop"] = (time.perf_counter(),
                                         self.state.step)

            hook = self.state.G.register_forward_pre_hook(step)
            self.tracer.start()
        try:
            start = time.perf_counter()
            logs = self._train(self.n_epochs)
            self.finite = bool(torch.isfinite(logs["losses_D"]).all()
                               & torch.isfinite(logs["losses_G"]).all())
            self.window_s = time.perf_counter() - start
        finally:
            if hook is not None:
                hook.remove()
                self.tracer.stop()
        self.window_losses = [[float(d), float(g)] for d, g in zip(
            logs["losses_D"].reshape(-1)[:STEPS],
            logs["losses_G"].reshape(-1)[:STEPS])]
        self.n_steps = self.state.step - first
        stop_t, stop_step = marks.get("stop", (start, first))
        self.untraced = (start + self.window_s - stop_t,
                         self.state.step - stop_step)

    @property
    def attempted(self) -> int:
        return self.n_steps

    @property
    def failed(self) -> int:
        return 0 if self.finite else self.n_steps

    def describe(self) -> str:
        return (f"{self.n_epochs} epochs of {self.steps_per_epoch} steps "
                f"in {self.window_s:.3f} s; sized from an epoch of "
                f"{self.epoch_s:.3f} s and metric forwards of "
                f"{self.metrics_s:.3f} s")

    def end_to_end(self) -> dict:
        return {"train_patches_s": self.n_steps * self.config.batch_size
                / self.window_s}

    def step_flops(self) -> int:
        """Model operations of one training step: G forward and backward;
        D forward and backward on real and fake (its update); D forward
        and input gradients on the fake (G's update); VGG19 forward on
        prediction and target and its input gradients on the prediction.
        """
        cfg, b = self.cfg, self.config.batch_size
        p = cfg["hr_patch"] // cfg["factor"]
        g = yardstick.srgan_generator_convs(cfg, p, p, b)
        g_fb = sum(c.train_flops() for c in g)
        d_fwd, d_first = yardstick.srgan_discriminator_fwd(cfg["hr_patch"])
        vgg = yardstick.vgg19_fwd(224)
        return (g_fb + 2 * b * (3 * d_fwd - d_first) + b * 2 * d_fwd
                + b * 3 * vgg)

    def layer_context(self) -> dict:
        untraced_s, untraced_steps = self.untraced
        return {"unit_work": 1, "untraced_s": untraced_s,
                "untraced_flops": untraced_steps * self.step_flops(),
                "peak_flops": yardstick.PEAK_FLOPS[self.cfg["dtype"]],
                "conv3x3_kernels": "AB", "conv3x3_bound_s": None}

    def expected_launches(self) -> dict:
        return {"A": 0, "B": 0}

    def release(self) -> None:
        del self.state

    def _reference(self, **kw) -> dict:
        return ref.first_steps(self.cfg, self.g_w, self.d_w, self.vgg,
                               self.lr_u8, self.hr_u8, self.valid,
                               self.data_seed, STEPS, **kw)

    @staticmethod
    def _window_gaps(got: list, want: list) -> dict:
        """``window_loss_gap``: the relative gap of G's loss at the window's
        first step, which runs through D's update of that step. Read, not
        compared: ``window_loss_gap3``, the largest gap of either loss over
        the first three steps, relative to the loss or to log 2 (a
        discriminator that cannot tell), whichever is larger: D's loss is
        near nought once D is sure, and the later steps part by Adam's
        rounding as the first steps' losses do."""
        floor = math.log(2.0)
        return {"window_loss_gap": abs(got[0][1] - want[0][1])
                / abs(want[0][1]),
                "window_loss_gap3": max(
                    abs(a - b) / max(abs(b), floor)
                    for s, t in zip(got, want) for a, b in zip(s, t))}

    def check(self) -> dict:
        """The first three steps against the reference from the seed, and
        the window's first three steps' losses against the reference from
        the snapshot."""
        f = self.first
        prog = {"loss": f["loss"], "grad1": f["g1"],
                "change": {k: f["p3"][k] - f["p0"][k] for k in f["p0"]}}
        exact = self._reference()
        window = self._reference(start=self.snapshot)
        return {**checks.training_gaps(prog, exact),
                **self._window_gaps(self.window_losses, window["losses"])}

    def control(self, calls: int) -> dict:
        """The control (fp8 operands) and the faults (half the batch; the
        window's updates skipped), each in the program's place."""
        del calls
        b = self.cfg["batch_size"]
        exact, win = self._reference(), self._reference(start=self.snapshot)
        out = {}
        for name, kw in (("control", {"low": "fp8"}),
                         ("half_batch", {"keep": b // 2})):
            out[name] = {**checks.training_gaps(self._reference(**kw), exact),
                         **self._window_gaps(
                             self._reference(start=self.snapshot,
                                             **kw)["losses"],
                             win["losses"])}
        out["unchanged"] = self._window_gaps(
            self._reference(start=self.snapshot, frozen=True)["losses"],
            win["losses"])
        return out
