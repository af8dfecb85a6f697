"""The SRGAN training step in plain PyTorch, from the published description
(Ledig et al., arXiv:1609.04802; the reference repo's train_GAN.py:38-71,
utils/GAN.py and models/GAN/), imported from no part of the program.

One step on a batch of aligned patch pairs (LR in [0, 1], HR in [-1, 1]):
a train-mode generator forward (batch statistics); the discriminator's
loss BCE(D(real), 1) + BCE(D(fake), 0), D run once on the concatenation
with each half normalised by its own batch statistics, its gradient and
D's Adam; then the generator's loss, VGG19 conv5_4 content MSE plus
adv_weight * BCE(D(fake), 1) through the updated D (batch statistics of
the fake batch), its gradient on G's leaves and G's Adam. The crops are
drawn as the program's trainer is documented to draw them: per step one
(B, 2) uniform float64 draw from the trainer's device generator, offset =
floor(u * max(valid - patch, 1)).

The optimizer state is the configuration's: G's Adam in f32; D's with
its moments stored in bf16 and its leaves of 2^20 elements or more stored
in bf16, every update computed in f32 and rounded back. Everything else
runs in f32 with TF32 off; ``low='fp8'`` rounds every conv's and dense
layer's operands to float8 e4m3 with a per-tensor scale (the control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from srbench.reference import srgan as gref
from srbench.reference.skipnet import exact_f32

BN_EPS, SLOPE = 1e-5, 0.2
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
BF16_MIN_SIZE = 1 << 20
# (channels, stride) of the discriminator's blocks after its stem
D_SCHEDULE = ((64, 2), (128, 1), (128, 2), (256, 1), (256, 2), (512, 1),
              (512, 2))
VGG19_BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def d_feature_side(n: int) -> int:
    for _ in range(sum(s == 2 for _, s in D_SCHEDULE)):
        n = (n + 1) // 2
    return n


def d_specs(hr_patch: int) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of the discriminator's weights and
    statistics under its module names."""
    specs = []

    def conv(name, ci, co, k=3):
        specs.append((f"{name}.weight", (co, ci, k, k), "conv", k * k * ci))
        specs.append((f"{name}.bias", (co,), "conv", k * k * ci))

    conv("conv", 3, 64)
    cin = 64
    for i, (ch, _) in enumerate(D_SCHEDULE):
        conv(f"block{i}_conv", cin, ch)
        for part in ("weight", "bias", "running_mean", "running_var"):
            specs.append((f"block{i}_bn.{part}", (ch,), part, 0))
        cin = ch
    flat = d_feature_side(hr_patch) ** 2 * cin
    specs += [("dense1.weight", (1024, flat), "conv", flat),
              ("dense1.bias", (1024,), "conv", flat),
              ("dense2.weight", (1, 1024), "conv", 1024),
              ("dense2.bias", (1,), "conv", 1024)]
    return specs


def _draw(specs, seed: int, device) -> dict:
    sizes = [math.prod(s) for _, s, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, kind, fan_in), u in zip(specs, flat.split(sizes)):
        lo, hi = ((-1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in))
                  if kind == "conv" else gref.RANGES[kind])
        out[name] = (lo + (hi - lo) * u).reshape(shape)
    return out


def make_d_weights(hr_patch: int, seed: int, device) -> dict:
    return _draw(d_specs(hr_patch), seed, device)


def make_vgg_weights(seed: int, device) -> dict:
    """VGG19's 16 feature convs, He-normal kernels and N(0, 0.01) biases,
    from one normal draw on the card; {conv{b}_{i}: {weight, bias}}."""
    shapes, cin = [], 3
    for b, (cout, n) in enumerate(VGG19_BLOCKS, 1):
        for i in range(1, n + 1):
            shapes.append((f"conv{b}_{i}", (cout, cin, 3, 3), (cout,)))
            cin = cout
    sizes = [math.prod(w) + math.prod(bs) for _, w, bs in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, w, bs), part in zip(shapes, flat.split(sizes)):
        kw, kb = part[:math.prod(w)], part[math.prod(w):]
        out[name] = {"weight": kw.reshape(w) * math.sqrt(2.0 / (9 * w[1])),
                     "bias": kb.reshape(bs) * 0.01}
    return out


# ------------------------------------------------------------- the nets
def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()  # rounded forward, straight-through grad


class Ops:
    """conv and dense in f32, or with fp8-rounded operands (``low``)."""

    def __init__(self, low: str | None = None):
        self.low = low

    def q(self, t):
        return _fp8(t) if self.low == "fp8" else t

    def conv(self, x, w, b, stride=1):
        return F.conv2d(self.q(x), self.q(w), b, stride=stride,
                        padding=w.shape[-1] // 2)

    def dense(self, x, w, b):
        return F.linear(self.q(x), self.q(w), b)


def _bn_train(x, w, b, groups: int = 1):
    xg = x.reshape(groups, x.shape[0] // groups, *x.shape[1:])
    mean = xg.mean((1, 3, 4), keepdim=True)
    var = (xg - mean).square().mean((1, 3, 4), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + BN_EPS)).reshape(x.shape)
    return y * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def generator_train(p, lr_nhwc, cfg, ops: Ops):
    """Train-mode generator: NHWC [0, 1] -> NCHW in [-1, 1]."""
    x = lr_nhwc.permute(0, 3, 1, 2)
    x0 = _prelu(ops.conv(x, p["conv1.weight"], p["conv1.bias"]),
                p["prelu1.alpha"])
    z = x0
    for i in range(cfg["residual_blocks_count"]):
        r = f"res{i}"
        h = _bn_train(ops.conv(z, p[f"{r}.conv1.weight"],
                               p[f"{r}.conv1.bias"]),
                      p[f"{r}.bn1.weight"], p[f"{r}.bn1.bias"])
        h = _prelu(h, p[f"{r}.prelu1.alpha"])
        z = z + _bn_train(ops.conv(h, p[f"{r}.conv2.weight"],
                                   p[f"{r}.conv2.bias"]),
                          p[f"{r}.bn2.weight"], p[f"{r}.bn2.bias"])
    z = x0 + _bn_train(ops.conv(z, p["conv2.weight"], p["conv2.bias"]),
                       p["bn1.weight"], p["bn1.bias"])
    for i in range(cfg["n_shuffles"]):
        z = _prelu(F.pixel_shuffle(ops.conv(z, p[f"ps{i}.conv1.weight"],
                                            p[f"ps{i}.conv1.bias"]), 2),
                   p[f"ps{i}.prelu1.alpha"])
    return torch.tanh(ops.conv(z, p["conv3.weight"], p["conv3.bias"]))


def discriminator(p, x_nchw, ops: Ops, groups: int = 1):
    """Train-mode discriminator: NCHW in [-1, 1] -> (N, 1) logits; with
    ``groups`` > 1 each of the stacked groups has its own statistics."""
    x = F.leaky_relu(ops.conv(x_nchw, p["conv.weight"], p["conv.bias"]),
                     SLOPE)
    for i, (_, stride) in enumerate(D_SCHEDULE):
        x = ops.conv(x, p[f"block{i}_conv.weight"], p[f"block{i}_conv.bias"],
                     stride)
        x = F.leaky_relu(_bn_train(x, p[f"block{i}_bn.weight"],
                                   p[f"block{i}_bn.bias"], groups), SLOPE)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C) order
    x = F.leaky_relu(ops.dense(x, p["dense1.weight"], p["dense1.bias"]),
                     SLOPE)
    return ops.dense(x, p["dense2.weight"], p["dense2.bias"])


def _bce(logits, target: float):
    t = torch.full_like(logits, target)
    return -(t * F.logsigmoid(logits) + (1 - t) * F.logsigmoid(-logits)
             ).mean()


def vgg_preprocess(x_nchw):
    """torchvision's VGG eval transform of a square image: resize to 256
    (antialiased bilinear), centre crop 224, ImageNet normalisation with
    no rescale of the input's range."""
    y = F.interpolate(x_nchw, size=(256, 256), mode="bilinear",
                      antialias=True, align_corners=False)
    y = y[:, :, 16:240, 16:240]
    mean = torch.tensor(IMAGENET_MEAN, device=y.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=y.device).view(1, 3, 1, 1)
    return (y - mean) / std


def vgg_features(vgg, x_nchw, ops: Ops):
    """VGG19 through conv5_4's ReLU: a ReLU after every conv, a 2x2 max
    pool after each block but the last."""
    x = x_nchw
    for b, (_, n) in enumerate(VGG19_BLOCKS, 1):
        for i in range(1, n + 1):
            w = vgg[f"conv{b}_{i}"]
            x = torch.relu(ops.conv(x, w["weight"], w["bias"]))
        if b < len(VGG19_BLOCKS):
            x = F.max_pool2d(x, 2)
    return x


# ------------------------------------------------------------- the step
def crops(lr_u8, hr_u8, valid_lr, gen, step: int, batch: int,
          lr_patch: int, factor: int):
    """The patch pairs of a step of the first epoch (images in order)."""
    sl = slice(step * batch, (step + 1) * batch)
    lr_u8, hr_u8, valid = lr_u8[sl], hr_u8[sl], valid_lr[sl]
    high = torch.clamp(valid - lr_patch, min=1).to(torch.float64)
    u = torch.rand(valid.shape, generator=gen, device=valid.device,
                   dtype=torch.float64)
    off = (u * high).long()
    lr_p = torch.stack([lr_u8[i, t:t + lr_patch, l:l + lr_patch]
                        for i, (t, l) in enumerate(off.tolist())])
    hp = lr_patch * factor
    hr_p = torch.stack([hr_u8[i, t * factor:t * factor + hp,
                              l * factor:l * factor + hp]
                        for i, (t, l) in enumerate(off.tolist())])
    return lr_p.float() / 255.0, hr_p.float() / 255.0 * 2.0 - 1.0


def _round_bf16(t):
    return t.to(torch.bfloat16).float()


def first_steps(cfg, g_w, d_w, vgg, lr_u8, hr_u8, valid_lr, data_seed: int,
                steps: int = 3, low: str | None = None,
                keep: int | None = None, start: dict | None = None,
                frozen: bool = False) -> dict:
    """The first ``steps`` training steps from the given weights and data.
    Returns {'loss': [loss_D, loss_G] of step 1, 'losses': those of every
    step, 'grad1': {leaf: first gradient}, 'change': {leaf: change over
    the steps}}, leaves named 'G.<name>' and 'D.<name>'. ``start``, a
    snapshot of a state that has trained ({'G.<name>': leaf, ...,
    'D.<name>': leaf, ...} under 'params', 'm' and 'v', the optimizers'
    step 'count' and the crop generator's 'gen_state'), starts there: the
    weights are then unused, the step's images are still the stack's
    first batches, as a new call of the trainer takes them. ``keep``
    trains on the first ``keep`` patches of each batch only and
    ``frozen`` skips every update (faults)."""
    dev = lr_u8.device
    ops = Ops(low)
    if start is None:
        params = {**{f"G.{k}": v for k, v in g_w.items()
                     if "running" not in k},
                  **{f"D.{k}": v for k, v in d_w.items()
                     if "running" not in k}}
        m = {k: torch.zeros_like(v, device=dev) for k, v in params.items()}
        v2, t0 = dict(m), 0
    else:
        params, m, v2 = start["params"], start["m"], start["v"]
        t0 = int(start["count"])

    def leaves(net):
        return {k[2:]: params[k].detach().to(dev).clone().float()
                for k in params if k.startswith(net + ".")}

    def moments(src, net):
        return {k[2:]: src[k].to(dev).float().clone() for k in src
                if k.startswith(net + ".")}

    g = {k: v.requires_grad_() for k, v in leaves("G").items()}
    d = leaves("D")
    big = {k for k, v in d.items() if v.numel() >= BF16_MIN_SIZE}
    for k in big:
        d[k] = _round_bf16(d[k])
    d = {k: v.requires_grad_() for k, v in d.items()}
    g0 = {k: v.detach().clone() for k, v in g.items()}
    d0 = {k: v.detach().clone() for k, v in d.items()}
    mg, vg = moments(m, "G"), moments(v2, "G")
    md, vd = moments(m, "D"), moments(v2, "D")
    gen = torch.Generator(device=dev)
    if start is None:
        gen.manual_seed(data_seed)
    else:
        gen.set_state(start["gen_state"])
    lr_rate, batch = cfg["pre_train_lr"], cfg["batch_size"]
    if frozen:
        lr_rate = 0.0
    lr_patch = cfg["hr_patch"] // cfg["factor"]
    losses, grad1 = [], None
    with exact_f32():
        for i in range(1, steps + 1):
            t = t0 + i  # Adam's count
            lr_p, hr_p = crops(lr_u8, hr_u8, valid_lr, gen, i - 1, batch,
                               lr_patch, cfg["factor"])
            if keep is not None:
                lr_p, hr_p = lr_p[:keep], hr_p[:keep]
            hr = hr_p.permute(0, 3, 1, 2)
            fake = generator_train(g, lr_p, cfg, ops)
            logits = discriminator(d, torch.cat([hr, fake.detach()]), ops, 2)
            n = hr.shape[0]
            loss_d = _bce(logits[:n], 1.0) + _bce(logits[n:], 0.0)
            gd = torch.autograd.grad(loss_d, list(d.values()))
            with torch.no_grad():
                for (k, p), gr in zip(d.items(), gd):
                    m32 = B1 * md[k] + (1 - B1) * gr
                    v32 = B2 * vd[k] + (1 - B2) * gr.square()
                    p += (-lr_rate) * (m32 / (1 - B1 ** t)) / (
                        torch.sqrt(v32 / (1 - B2 ** t)) + ADAM_EPS)
                    md[k], vd[k] = _round_bf16(m32), _round_bf16(v32)
                    if k in big:
                        p.copy_(_round_bf16(p))
            content = (vgg_features(vgg, vgg_preprocess(fake), ops)
                       - vgg_features(vgg, vgg_preprocess(hr), ops)
                       ).square().mean()
            loss_g = content + cfg["adv_weight"] * _bce(
                discriminator(d, fake, ops), 1.0)
            gg = torch.autograd.grad(loss_g, list(g.values()))
            with torch.no_grad():
                for (k, p), gr in zip(g.items(), gg):
                    mg[k].mul_(B1).add_(gr, alpha=1 - B1)
                    vg[k].mul_(B2).addcmul_(gr, gr, value=1 - B2)
                    p -= lr_rate * (mg[k] / (1 - B1 ** t)) / (
                        (vg[k] / (1 - B2 ** t)).sqrt() + ADAM_EPS)
            losses.append([float(loss_d.detach()), float(loss_g.detach())])
            if i == 1:
                grad1 = {**{f"G.{k}": v.detach() for k, v in zip(g, gg)},
                         **{f"D.{k}": v.detach() for k, v in zip(d, gd)}}
    change = {**{f"G.{k}": g[k].detach() - g0[k] for k in g},
              **{f"D.{k}": d[k].detach() - d0[k] for k in d}}
    return {"loss": losses[0], "losses": losses, "grad1": grad1,
            "change": change}
