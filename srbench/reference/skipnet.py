"""The DIP super-resolution step in plain PyTorch, from the published
description (Ulyanov et al., arXiv:1711.10925; the reference repo's
models/DIP/skip.py, utils/downsampler.py and DIP.py), imported from no
part of the program.

``init`` draws the net's initial weights from the caller's CPU generator
in the order the reference's modules are built, with torch's Conv2d
default U(+-1/sqrt(fan_in)) for each kernel and bias, BatchNorm scale 1
and shift 0; then the seed of the device generator that draws z and each
iteration's reg noise. ``first_steps`` runs the first Adam iterations and
returns each step's loss, the first gradient of every leaf and each
leaf's change over the steps. TF32 is switched off around it and
restored; ``dtype=torch.bfloat16`` computes the convs in bf16 (the
control).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LEAKY_SLOPE = 0.2
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def leaf_specs(cfg: dict) -> list[tuple[str, tuple, int | None]]:
    """(name, shape, fan_in or None for BatchNorm) of every leaf, in the
    order the reference builds them."""
    d, u, s = cfg["skip_n33d"], cfg["skip_n33u"], cfg["skip_n11"]
    scales = cfg["num_scales"]
    specs, cin = [], cfg["input_depth"]

    def conv(name, ci, co, k):
        specs.append((f"{name}.weight", (co, ci, k, k), k * k * ci))
        specs.append((f"{name}.bias", (co,), k * k * ci))

    def bn(name, c):
        specs.append((f"{name}.weight", (c,), None))
        specs.append((f"{name}.bias", (c,), None))

    for i in range(scales):
        deeper = d if i == scales - 1 else u
        conv(f"skip{i}_conv", cin, s, 1)
        bn(f"skip{i}_bn", s)
        conv(f"down{i}_conv1", cin, d, 3)
        bn(f"down{i}_bn1", d)
        conv(f"down{i}_conv2", d, d, 3)
        bn(f"down{i}_bn2", d)
        bn(f"merge{i}_bn", s + deeper)
        conv(f"up{i}_conv", s + deeper, u, 3)
        bn(f"up{i}_bn", u)
        conv(f"up{i}_conv1x1", u, u, 1)
        bn(f"up{i}_bn1x1", u)
        cin = d
    conv("head_conv", u, 3, 1)
    return specs


def init(cfg: dict, generator: torch.Generator):
    """(leaves by name on the CPU, seed of the device generator)."""
    leaves = {}
    for name, shape, fan_in in leaf_specs(cfg):
        if fan_in is None:
            leaves[name] = (torch.ones(shape) if name.endswith("weight")
                            else torch.zeros(shape))
        else:
            bound = 1.0 / math.sqrt(fan_in)
            leaves[name] = torch.empty(shape).uniform_(-bound, bound,
                                                       generator=generator)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return leaves, seed


def lanczos2_taps(factor: int) -> np.ndarray:
    """The 1-D taps of the phase-1/2 lanczos2 kernel, normalised: width
    4 * factor + 1, 4 * factor taps at |i + 1/2 - centre| / factor."""
    width = 4 * factor + 1
    idx = np.arange(1, width, dtype=np.float64)
    t = np.abs(idx + 0.5 - (width + 1) / 2.0) / factor
    support = 2.0
    with np.errstate(invalid="ignore", divide="ignore"):
        val = (support * np.sin(np.pi * t) * np.sin(np.pi * t / support)
               / (np.pi ** 2 * t * t))
    val = np.where(t == 0, 1.0, val)
    return val / val.sum()


def downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """The loss's antialiased x``factor`` downsample of NCHW x: replicate
    padding that keeps the size, then one strided depthwise 2-D conv."""
    taps = torch.as_tensor(lanczos2_taps(factor), dtype=x.dtype,
                           device=x.device)
    k = taps.numel()
    pad = (k - 1) // 2 if k % 2 else (k - factor) // 2
    x = F.pad(x, (pad,) * 4, mode="replicate")
    c = x.shape[1]
    w = torch.outer(taps, taps).expand(c, 1, k, k)
    return F.conv2d(x, w, stride=factor, groups=c)


def _conv(p, name, x, stride=1):
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    if k > 1:
        x = F.pad(x, ((k - 1) // 2,) * 4, mode="reflect")
    return F.conv2d(x, w.to(x.dtype), p[f"{name}.bias"].to(x.dtype),
                    stride=stride)


def _bn(p, name, x):
    """Train-mode BatchNorm: batch mean and biased variance."""
    xf = x.float()
    mean = xf.mean((0, 2, 3), keepdim=True)
    var = (xf - mean).square().mean((0, 2, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + BN_EPS)
    y = y * p[f"{name}.weight"].view(1, -1, 1, 1) + p[f"{name}.bias"].view(
        1, -1, 1, 1)
    return y.to(x.dtype)


def _act(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def forward(p: dict, z: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The skip net on NCHW z -> NCHW image in (0, 1)."""
    scales = cfg["num_scales"]

    def level(i, h):
        s = _act(_bn(p, f"skip{i}_bn", _conv(p, f"skip{i}_conv", h)))
        d = _act(_bn(p, f"down{i}_bn1", _conv(p, f"down{i}_conv1", h, 2)))
        d = _act(_bn(p, f"down{i}_bn2", _conv(p, f"down{i}_conv2", d)))
        if i < scales - 1:
            d = level(i + 1, d)
        d = F.interpolate(d, scale_factor=2, mode="bilinear",
                          align_corners=False)
        th, tw = min(s.shape[2], d.shape[2]), min(s.shape[3], d.shape[3])
        parts = []
        for t in (s, d):  # centre crop to the smaller
            dh, dw = (t.shape[2] - th) // 2, (t.shape[3] - tw) // 2
            parts.append(t[:, :, dh:dh + th, dw:dw + tw])
        m = _bn(p, f"merge{i}_bn", torch.cat(parts, 1))
        m = _act(_bn(p, f"up{i}_bn", _conv(p, f"up{i}_conv", m)))
        return _act(_bn(p, f"up{i}_bn1x1", _conv(p, f"up{i}_conv1x1", m)))

    return torch.sigmoid(_conv(p, "head_conv", level(0, z)).float())


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN and cuBLAS inside the block, restored after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def first_steps(cfg: dict, generator: torch.Generator, lr_image, device,
                steps: int = 3, dtype: torch.dtype = torch.float32) -> dict:
    """The first ``steps`` DIP iterations (reg noise, forward, lanczos2
    downsample, MSE against lr_image (1, 3, h, w), backward, Adam) of the
    net that ``generator`` initialises. Returns {'loss': [the first step's
    loss],
    'grad1': {leaf: first gradient}, 'change': {leaf: change after the
    steps}}, tensors on ``device``."""
    leaves, seed = init(cfg, generator)
    p = {k: v.to(device).requires_grad_() for k, v in leaves.items()}
    p0 = {k: v.detach().clone() for k, v in p.items()}
    h, w = lr_image.shape[2] * cfg["factor"], lr_image.shape[3] * cfg["factor"]
    dev_gen = torch.Generator(device=device).manual_seed(seed)
    shape = (1, h, w, cfg["input_depth"])
    z = torch.rand(shape, generator=dev_gen, device=device).permute(
        0, 3, 1, 2) * cfg["input_noise_scale"]
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = ADAM_BETAS
    lr = cfg["learning_rate"]
    losses, grad1 = [], None
    autocast = (torch.autocast(device_type=torch.device(device).type,
                               dtype=dtype) if dtype != torch.float32
                else contextlib.nullcontext())
    with exact_f32():
        for t in range(1, steps + 1):
            noise = torch.randn(shape, generator=dev_gen,
                                device=device).permute(0, 3, 1, 2)
            with autocast:
                out = forward(p, z + noise * cfg["reg_noise_std"], cfg)
                loss = (downsample(out.float(), cfg["factor"])
                        - lr_image).square().mean()
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                for k, leaf in p.items():
                    g = grads[k]
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = m[k] / (1 - b1 ** t)
                    v_hat = v2[k] / (1 - b2 ** t)
                    leaf -= lr * m_hat / (v_hat.sqrt() + ADAM_EPS)
    change = {k: (p[k].detach() - p0[k]) for k in p}
    return {"loss": losses[:1], "grad1": grad1, "change": change}
