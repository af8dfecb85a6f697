"""SwinIR's forward in plain PyTorch, from the published code (Liang et
al., arXiv:2108.10257; github.com/JingyunLiang/SwinIR
``models/network_swinir.py``, the model ``main_test_swinir.py --task
real_sr --scale 4`` builds: SwinIR-M, ``upsampler='nearest+conv'``,
``resi_connection='1conv'``), imported from no part of the program:

  x = reflect_pad(x) to a multiple of the window; x = (x - mean) * range
  f = conv_first(x); t = LN(tokens(f))                      (patch_embed)
  per RSTB: u = t; per Swin layer j (shift = 0 for even j, w/2 for odd j):
      u = u + proj(WMSA(LN1(u)));  u = u + fc2(GELU(fc1(LN2(u))))
    t = tokens(conv(image(u))) + t                           (1conv)
  f = conv_after_body(image(LN(t))) + f
  f = lrelu(conv_before_upsample(f), 0.01)
  per x2 octave: f = lrelu(conv_up{n}(nearest_x2(f)), 0.2)
  y = conv_last(lrelu(conv_hr(f), 0.2)) / range + mean, cropped to s H x s W

  WMSA: roll by (-shift, -shift), 8 x 8 windows, qkv = Linear(C, 3C) split
  (3, heads, C / heads); softmax(q hd^-1/2 k^T + B + M) v; proj; window
  reverse; roll back. B = table[relative_position_index] ((2w - 1)^2 rows
  per head), M = the published ``calculate_mask``: -100 (not -inf)
  between tokens of different regions of the 3 x 3 slicing of the shifted
  image, shifted layers only.

Departures from the published code: none. (Its test script pads the LR
image by flipping before the model; the model's own ``check_image_size``
reflect-pads, which is what this and the program do.)

``make_weights`` draws every parameter in the published names and layouts
from a seed on the device: every conv and Linear weight and bias
U(+-1/sqrt(fan_in)) (as the RRDB cell draws its weights), every relative-
position table N(0, 1) (the published init is N(0, 0.02); at 1 a bias left
out moves the output visibly), every LayerNorm gain 1 and bias 0.
``published_state_dict`` adds the buffers a published file carries
(``relative_position_index`` in every layer, ``attn_mask`` in the shifted
ones, at the ``img_size`` the model was built for).

``forward`` runs in f32 with TF32 off. ``low='fp8'`` rounds both operands
of every conv, Linear and attention product to float8 e4m3 with a per-
tensor scale (the control of a bf16 cell). ``fault`` puts a fault in the
program's place: ``('mask', 'all')`` leaves M out of every shifted layer,
``('shift', 'all')`` shifts no layer, ``('bias', i)`` leaves B out of Swin
layer i (counted over all RSTBs, from 0).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from srbench.reference.skipnet import exact_f32
from srbench.reference.srgan_train import _fp8

EPS = 1e-5  # nn.LayerNorm's
MASK = -100.0


def octaves(cfg: dict) -> int:
    return int(cfg["upscale"]).bit_length() - 1


def block_names(cfg: dict) -> list[str]:
    """The prefix of every Swin layer, in order."""
    return [f"layers.{i}.residual_group.blocks.{j}"
            for i, d in enumerate(cfg["depths"]) for j in range(d)]


def weight_specs(cfg: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every parameter in the published
    names and layouts (convs OIHW, Linears (out, in)); kind 'uniform',
    'table', 'one' or 'zero'."""
    c, ws, nf = cfg["embed_dim"], cfg["window_size"], cfg["num_feat"]
    hidden = int(c * cfg["mlp_ratio"])
    specs = []

    def conv(name, ci, co):
        specs.append((f"{name}.weight", (co, ci, 3, 3), "uniform", 9 * ci))
        specs.append((f"{name}.bias", (co,), "uniform", 9 * ci))

    def linear(name, ci, co):
        specs.append((f"{name}.weight", (co, ci), "uniform", ci))
        specs.append((f"{name}.bias", (co,), "uniform", ci))

    def norm(name):
        specs.append((f"{name}.weight", (c,), "one", 0))
        specs.append((f"{name}.bias", (c,), "zero", 0))

    conv("conv_first", cfg["in_chans"], c)
    norm("patch_embed.norm")
    names = iter(block_names(cfg))
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for _ in range(depth):
            pre = next(names)
            norm(f"{pre}.norm1")
            specs.append((f"{pre}.attn.relative_position_bias_table",
                          ((2 * ws - 1) ** 2, heads), "table", 0))
            linear(f"{pre}.attn.qkv", c, 3 * c)
            linear(f"{pre}.attn.proj", c, c)
            norm(f"{pre}.norm2")
            linear(f"{pre}.mlp.fc1", c, hidden)
            linear(f"{pre}.mlp.fc2", hidden, c)
        conv(f"layers.{i}.conv", c, c)
    norm("norm")
    conv("conv_after_body", c, c)
    conv("conv_before_upsample.0", c, nf)
    for n in range(1, octaves(cfg) + 1):
        conv(f"conv_up{n}", nf, nf)
    conv("conv_hr", nf, nf)
    conv("conv_last", nf, cfg["in_chans"])
    return specs


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in weight_specs(cfg))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter from ``seed``: one uniform draw on the device cut
    into the conv and Linear leaves, U(+-1/sqrt(fan_in)); one normal draw
    cut into the bias tables, N(0, 1); LayerNorms 1 and 0."""
    specs = weight_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = {}
    for kind, fn in (("uniform", torch.rand), ("table", torch.randn)):
        sizes = [math.prod(s) for _, s, k, _ in specs if k == kind]
        draws[kind] = iter(fn(sum(sizes), generator=gen,
                              device=device).split(sizes))
    out = {}
    for name, shape, kind, fan_in in specs:
        if kind == "uniform":
            u = next(draws[kind])
            out[name] = ((2 * u - 1) / math.sqrt(fan_in)).reshape(shape)
        elif kind == "table":
            out[name] = next(draws[kind]).reshape(shape)
        else:
            out[name] = torch.full(shape, float(kind == "one"), device=device)
    return out


# ------------------------------------------------------ the published buffers
def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def calculate_mask(x_size, ws: int, shift: int, device=None) -> torch.Tensor:
    h, w = x_size
    img_mask = torch.zeros((1, h, w, 1), device=device)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, MASK).masked_fill(
        attn_mask == 0, 0.0)


def published_state_dict(p: dict, cfg: dict) -> dict:
    """``p`` with the buffers a published file carries, in its order."""
    ws, side = cfg["window_size"], cfg["img_size"]
    index = relative_position_index(ws)
    mask = calculate_mask((side, side), ws, ws // 2)
    out = {}
    for name, t in p.items():
        out[name] = t
        if name.endswith("attn.relative_position_bias_table"):
            out[name.replace("bias_table", "index")] = index.to(t.device)
        if name.endswith("mlp.fc2.bias") and int(name.split(".")[4]) % 2:
            out[name.replace("mlp.fc2.bias", "attn_mask")] = mask.to(t.device)
    return out


# ----------------------------------------------------------------- forward
class _Ops:
    def __init__(self, low: str | None):
        if low not in (None, "fp8"):
            raise ValueError(f"low {low!r} not in None/'fp8'")
        self.low = low

    def q(self, t):
        return _fp8(t) if self.low == "fp8" else t

    def conv(self, p, name, x):
        return F.conv2d(self.q(x), self.q(p[f"{name}.weight"]),
                        p[f"{name}.bias"], padding=1)

    def linear(self, p, name, x):
        return F.linear(self.q(x), self.q(p[f"{name}.weight"]),
                        p[f"{name}.bias"])

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)


def _norm(p, name, x):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], EPS)


def _attention(p, pre, x, heads, ws, mask, bias, ops):
    """The published ``WindowAttention.forward`` on (B_, N, C) windows."""
    b_, n, c = x.shape
    qkv = ops.linear(p, f"{pre}.attn.qkv", x).reshape(
        b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = ops.matmul(q, k.transpose(-2, -1))
    if bias:
        table = p[f"{pre}.attn.relative_position_bias_table"]
        index = relative_position_index(ws).to(table.device)
        rpb = table[index.view(-1)].view(ws * ws, ws * ws, -1)
        attn = attn + rpb.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(
            1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = attn.softmax(-1)
    x = ops.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
    return ops.linear(p, f"{pre}.attn.proj", x)


def _swin_layer(p, pre, x, x_size, heads, ws, shift, use_mask, bias, ops):
    """The published ``SwinTransformerBlock.forward``."""
    h, w = x_size
    b, _, c = x.shape
    shortcut = x
    x = _norm(p, f"{pre}.norm1", x).view(b, h, w, c)
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = window_partition(x, ws).view(-1, ws * ws, c)
    mask = calculate_mask(x_size, ws, shift, x.device) \
        if shift > 0 and use_mask else None
    out = _attention(p, pre, windows, heads, ws, mask, bias, ops)
    x = window_reverse(out.view(-1, ws, ws, c), ws, h, w)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.view(b, h * w, c)
    y = F.gelu(ops.linear(p, f"{pre}.mlp.fc1", _norm(p, f"{pre}.norm2", x)))
    return x + ops.linear(p, f"{pre}.mlp.fc2", y)


def forward(p: dict, lr_nhwc: torch.Tensor, cfg: dict,
            low: str | None = None,
            fault: tuple[str, object] | None = None) -> torch.Tensor:
    """NHWC LR in [0, 1] -> NHWC f32, unbounded; TF32 off."""
    kind, at = fault if fault is not None else (None, None)
    if kind not in (None, "mask", "shift", "bias"):
        raise ValueError(f"fault {fault!r} unknown")
    ops = _Ops(low)
    ws, rng, s = cfg["window_size"], float(cfg["img_range"]), cfg["upscale"]
    with torch.no_grad(), exact_f32():
        x = lr_nhwc.permute(0, 3, 1, 2).float()
        h0, w0 = x.shape[2:]
        x = F.pad(x, (0, (ws - w0 % ws) % ws, 0, (ws - h0 % ws) % ws),
                  "reflect")
        mean = torch.tensor(cfg["rgb_mean"], device=x.device).view(1, 3, 1, 1)
        x = (x - mean) * rng
        x = ops.conv(p, "conv_first", x)
        b, c, h, w = x.shape
        t = _norm(p, "patch_embed.norm", x.flatten(2).transpose(1, 2))
        names = iter(block_names(cfg))
        layer = 0
        for i, (depth, heads) in enumerate(zip(cfg["depths"],
                                               cfg["num_heads"])):
            u = t
            for j in range(depth):
                shift = 0 if j % 2 == 0 or kind == "shift" else ws // 2
                u = _swin_layer(p, next(names), u, (h, w), heads, ws, shift,
                                kind != "mask", (kind, at) != ("bias", layer),
                                ops)
                layer += 1
            img = u.transpose(1, 2).view(b, c, h, w)
            t = ops.conv(p, f"layers.{i}.conv", img).flatten(2).transpose(
                1, 2) + t
        t = _norm(p, "norm", t).transpose(1, 2).view(b, c, h, w)
        x = ops.conv(p, "conv_after_body", t) + x
        x = F.leaky_relu(ops.conv(p, "conv_before_upsample.0", x), 0.01)
        for n in range(1, octaves(cfg) + 1):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = F.leaky_relu(ops.conv(p, f"conv_up{n}", x), 0.2)
        x = ops.conv(p, "conv_last",
                     F.leaky_relu(ops.conv(p, "conv_hr", x), 0.2))
        x = x / rng + mean
    return x[:, :, :h0 * s, :w0 * s].permute(0, 2, 3, 1)
