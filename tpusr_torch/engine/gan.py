"""SRGAN engine: the configuration, the alternating D/G training step and
the generator's eval forward.

Counterpart of ``tpusr/engine/gan.py`` (reference train_GAN.py:22-136,
eval_GAN.py:21-69). ``GANTrainConfig`` carries every field and default of
the JAX package's config. One ``gan_train_step`` has tpusr's dataflow:

  * one train-mode G forward, which updates G's BN statistics once and
    whose graph is kept for the G update;
  * the D update on concat(real, fake) with per-group BN statistics
    (``d_concat``; else two sequential calls), then D's Adam;
  * the G loss through the just-updated D in train mode, its BN update
    discarded and no gradient of it landing on D; ``legacy_detach``
    detaches the adversarial input (the reference's train_GAN.py:58);
    ``adv_weight`` scales the adversarial term; then G's Adam.

Optimizers are fresh per phase (``create_gan_state``). G's Adam and D's
with ``d_moments='f32'`` are ``torch.optim.Adam``, whose update is
optax.adam's; ``d_moments='bf16'`` stores D's moments in bf16 with all of
the update's math in f32 (``bf16_adam_update``), and ``d_params='bf16'``
stores D's leaves of at least 2^20 elements in bf16, updated as p + u in
f32 and rounded back. ``g_fuse='train'`` sends the training G's 3x3 convs
through kernels A (forward, dgrad) and B (wgrad); 'eval' and 'off' leave
them on cuDNN.
"""

from __future__ import annotations

import dataclasses
import os as _os
from typing import Callable

import torch

from tpusr_torch.engine import losses as L
from tpusr_torch.models.srgan import Discriminator, Generator
from tpusr_torch.utils.profiling import span

# Defaults seeded from the environment once, at import, as tpusr does
# (gan.py:39-50); in-process callers use dataclasses.replace on the config.
_D_CONCAT_DEFAULT = _os.environ.get("TPUSR_D_CONCAT", "1") != "0"
_G_FUSE_DEFAULT = {"0": "off", "train": "train"}.get(
    _os.environ.get("TPUSR_G_FUSE", "1"), "eval")
_D_MOMENTS_DEFAULT = _os.environ.get("TPUSR_D_MOMENTS", "bf16")
_D_PARAMS_DEFAULT = _os.environ.get(
    "TPUSR_D_PARAMS", "bf16" if _D_MOMENTS_DEFAULT == "bf16" else "f32")


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    """train_GAN.py defaults (:216-219, :169, :270), as tpusr's config."""

    factor: int = 8
    batch_size: int = 8
    hr_patch: int = 192
    pre_train_epochs: int = 8000
    fine_tune_epochs: int = 4000
    pre_train_lr: float = 1e-4
    fine_tune_lr: float = 1e-5
    residual_blocks_count: int = 16
    legacy_detach: bool = False  # reproduce train_GAN.py:58 exactly
    legacy_scale: bool = False  # the reference's double-/255 scaling
    content: str = "auto"  # 'auto' | 'vgg' | 'mse'
    dtype: str | None = None  # 'bfloat16' activations (params stay f32)
    adv_weight: float = 1.0
    d_concat: bool = _D_CONCAT_DEFAULT
    # kernel-A routing of the generator's 3x3 convs: 'eval' (default) fuses
    # the eval forward only, 'train' the training forward too, 'off' none
    g_fuse: str = _G_FUSE_DEFAULT
    conv_fusion: str = "auto"  # 'auto' | 'off'
    d_moments: str = _D_MOMENTS_DEFAULT  # 'bf16' | 'f32'
    d_params: str = _D_PARAMS_DEFAULT  # 'f32' | 'bf16'


def torch_dtype(config: GANTrainConfig) -> torch.dtype | None:
    """The Generator's activation dtype for ``config.dtype``."""
    if config.dtype in (None, "float32"):
        return None
    if config.dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"dtype {config.dtype!r} not in float32/bfloat16")


def _check_fusion(config: GANTrainConfig) -> None:
    if config.conv_fusion not in ("auto", "off"):
        raise ValueError(f"conv_fusion {config.conv_fusion!r} not in "
                         f"auto/off")


def build_generator(config: GANTrainConfig, device="cuda",
                    generator: torch.Generator | None = None) -> Generator:
    """The Generator ``config`` describes, on ``device``."""
    return Generator(factor=config.factor,
                     residual_blocks_count=config.residual_blocks_count,
                     dtype=torch_dtype(config), device=device,
                     generator=generator)


def generator_forward(generator: Generator, lr_images: torch.Tensor,
                      config: GANTrainConfig,
                      train: bool = False) -> torch.Tensor:
    """Full-image generator inference (eval_GAN.py:44) over NHWC images.

    ``train=False`` normalises with the running BN statistics (the
    reference calls gan_G.eval(), eval_GAN.py:94) and sends the 3x3 convs
    through kernel A unless ``config.g_fuse == 'off'``; ``train=True`` uses
    batch statistics, discards their update, and fuses only under
    ``g_fuse == 'train'`` (tpusr's gan.py:367-397). ``conv_fusion='off'``
    keeps every conv on ``F.conv2d`` whatever g_fuse says. Precision in
    f32: kernel A multiplies in full f32; the convs left to cuDNN (the two
    9x9 ones, and the 3x3 ones when unfused) follow PyTorch's setting,
    TF32 by default, as XLA's default precision rounds the reference's f32
    convs on the TPU (to bf16 there). Returns NHWC f32 in [-1, 1].
    """
    _check_fusion(config)
    fuse = (config.g_fuse == "train") if train else (config.g_fuse != "off")
    with span("gan.generator_forward"):
        x = lr_images.permute(0, 3, 1, 2)  # NHWC memory = channels_last NCHW
        y = generator(x, train, fuse=fuse and config.conv_fusion == "auto",
                      update_stats=False)
        return y.permute(0, 2, 3, 1)


# ----------------------------------------------------------------- training
# d_params='bf16' stores only leaves at least this big in bf16: dense1's
# weight and the two widest conv kernels; BN affines and biases stay f32
D_PARAMS_BF16_MIN_SIZE = 1 << 20
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam / torch.optim.Adam defaults


def _cast_large_d_params(D: Discriminator, d_params: str) -> None:
    if d_params not in ("f32", "bf16"):
        raise ValueError(f"d_params {d_params!r} not in f32/bf16")
    if d_params == "bf16":
        for p in D.parameters():
            if p.numel() >= D_PARAMS_BF16_MIN_SIZE:
                p.data = p.data.to(torch.bfloat16)


@torch.no_grad()
def bf16_adam_update(params, ms, vs, count: int, lr: float) -> None:
    """One Adam step with bf16 moment storage, in place: m and v are read
    and written in bf16, the EMAs, bias corrections and root in f32, and a
    bf16 parameter is updated as p + u in f32 and rounded back (tpusr's
    ``_adam('bf16')`` and optax.apply_updates). ``count`` is the step's
    1-based count; each parameter's ``grad`` is read."""
    c = torch.tensor(float(count))
    bc1 = float(1.0 - torch.tensor(B1) ** c)
    bc2 = float(1.0 - torch.tensor(B2) ** c)
    for p, m, v in zip(params, ms, vs):
        g = p.grad.float()
        m32 = B1 * m.float() + (1.0 - B1) * g
        v32 = B2 * v.float() + (1.0 - B2) * g.square()
        upd = (-lr) * (m32 / bc1) / (torch.sqrt(v32 / bc2) + EPS)
        m.copy_(m32)
        v.copy_(v32)
        p.copy_(p.float() + upd)


class Bf16Adam:
    """Adam over ``params`` with its moments stored in bf16: the state (a
    count and the m and v tensors) and ``bf16_adam_update``."""

    def __init__(self, params, lr: float):
        self.params, self.lr, self.count = list(params), lr, 0
        self.m = [torch.zeros_like(p, dtype=torch.bfloat16)
                  for p in self.params]
        self.v = [torch.zeros_like(p, dtype=torch.bfloat16)
                  for p in self.params]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> None:
        self.count += 1
        bf16_adam_update(self.params, self.m, self.v, self.count, self.lr)


def _adam(params, lr: float, moments: str = "f32"):
    """'f32': torch.optim.Adam; 'bf16': ``Bf16Adam``."""
    if moments == "f32":
        return torch.optim.Adam(params, lr=lr, betas=(B1, B2), eps=EPS)
    if moments == "bf16":
        return Bf16Adam(params, lr)
    raise ValueError(f"moments {moments!r} not in f32/bf16")


def adam_moments(opt) -> tuple[int, list, list]:
    """(count, m, v) of either optimizer, in its parameters' order; zeros
    before its first step."""
    if isinstance(opt, Bf16Adam):
        return opt.count, opt.m, opt.v
    params = opt.param_groups[0]["params"]
    st = [opt.state.get(p, {}) for p in params]
    count = int(st[0]["step"]) if st and "step" in st[0] else 0
    return (count,
            [s.get("exp_avg", torch.zeros_like(p))
             for s, p in zip(st, params)],
            [s.get("exp_avg_sq", torch.zeros_like(p))
             for s, p in zip(st, params)])


@torch.no_grad()
def set_adam_moments(opt, count: int, ms, vs) -> None:
    """Put (count, m, v) into either optimizer, cast to its storage."""
    if isinstance(opt, Bf16Adam):
        opt.count = int(count)
        for dst, src in zip(opt.m + opt.v, list(ms) + list(vs)):
            dst.copy_(torch.as_tensor(src))
        return
    params = opt.param_groups[0]["params"]
    for p, m, v in zip(params, ms, vs):
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(m).to(p.device, p.dtype).clone(),
            "exp_avg_sq": torch.as_tensor(v).to(p.device, p.dtype).clone()}


@dataclasses.dataclass
class GANTrainState:
    """Both nets (their parameters and running statistics), both
    optimizers and the step count. The step updates it in place."""

    G: Generator
    D: Discriminator
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam | Bf16Adam
    step: int = 0


def create_gan_state(config: GANTrainConfig, learning_rate: float,
                     generator: torch.Generator | None = None,
                     G: Generator | None = None,
                     D: Discriminator | None = None,
                     device="cuda") -> GANTrainState:
    """Build the nets (or adopt G and D, as a new phase does) with fresh
    Adam optimizers and step 0 (train_GAN.py:35-36). New nets draw their
    init from ``generator``, G first."""
    if config.d_params == "bf16" and config.d_moments != "bf16":
        raise ValueError("d_params='bf16' requires d_moments='bf16' (f32 "
                         "update math)")
    if G is None:
        G = build_generator(config, device, generator)
    if D is None:
        D = Discriminator(config.hr_patch, torch_dtype(config), device,
                          generator)
    _cast_large_d_params(D, config.d_params)
    return GANTrainState(
        G=G, D=D, opt_G=_adam(G.parameters(), learning_rate),
        opt_D=_adam(D.parameters(), learning_rate, config.d_moments))


def _g_forward(state: GANTrainState, lr_patches, config: GANTrainConfig):
    """The step's one train-mode G forward (NHWC in, NCHW out); it updates
    G's BN statistics and its graph is kept for the G update."""
    fuse = config.g_fuse == "train" and config.conv_fusion == "auto"
    with span("gan.g_forward"):
        return state.G(lr_patches.permute(0, 3, 1, 2), True, fuse=fuse)


def _d_update(state: GANTrainState, fake, hr_patches,
              config: GANTrainConfig, reduce_grads: Callable | None = None):
    """D's loss on (real, fake.detach()), its backward and its Adam step
    (train_GAN.py:43-53). ``reduce_grads(params)``, when given, rewrites
    the gradients between the backward and the step (the data-parallel
    mean over ranks)."""
    with span("gan.d_update"):
        D = state.D
        hr = hr_patches.permute(0, 3, 1, 2)
        fake_d = fake.detach().to(hr.dtype)
        state.opt_D.zero_grad(set_to_none=True)
        if config.d_concat:
            b = hr.shape[0]
            logits = D(torch.cat([hr, fake_d]), True, 2)
            loss_D = L.discriminator_loss(logits[:b], logits[b:])
        else:
            loss_D = L.discriminator_loss(D(hr, True), D(fake_d, True))
        loss_D.backward()
        if reduce_grads is not None:
            reduce_grads(list(D.parameters()))
        with span("gan.d_optimizer"):
            state.opt_D.step()
        return loss_D.detach()


def _g_update(state: GANTrainState, fake, hr_patches,
              config: GANTrainConfig, content_loss: Callable,
              reduce_grads: Callable | None = None):
    """G's loss through the just-updated D (train mode, its BN update
    discarded), the gradient of G's leaves only, and G's Adam step
    (train_GAN.py:55-64); ``reduce_grads`` as in ``_d_update``."""
    with span("gan.g_update"):
        adv_input = fake.detach() if config.legacy_detach else fake
        fake_logits = state.D(adv_input, True, update_stats=False)
        loss_G = L.perceptual_loss(content_loss, fake.permute(0, 2, 3, 1),
                                   hr_patches, fake_logits,
                                   adv_weight=config.adv_weight)
        params_G = list(state.G.parameters())
        # none of loss_G's gradient lands on D
        for p, g in zip(params_G, torch.autograd.grad(loss_G, params_G)):
            p.grad = g
        if reduce_grads is not None:
            reduce_grads(params_G)
        state.opt_G.step()
        return loss_G.detach()


def gan_train_step(state: GANTrainState, lr_patches: torch.Tensor,
                   hr_patches: torch.Tensor, config: GANTrainConfig,
                   content_loss: Callable = L.mse):
    """One adversarial step (do_epoch parity, train_GAN.py:38-71).

    lr_patches: (B, p, p, 3) in [0, 1]; hr_patches: (B, P, P, 3) in
    [-1, 1], NHWC. Updates ``state`` in place and returns it with
    {'loss_D', 'loss_G'} as 0-d tensors on the device (no host sync).
    """
    _check_fusion(config)
    fake = _g_forward(state, lr_patches, config)
    loss_D = _d_update(state, fake, hr_patches, config)
    loss_G = _g_update(state, fake, hr_patches, config, content_loss)
    state.step += 1
    return state, {"loss_D": loss_D, "loss_G": loss_G}
