"""SwinIR for real-world super-resolution (Liang et al., arXiv:2108.10257;
github.com/JingyunLiang/SwinIR ``models/network_swinir.py``), as
``main_test_swinir.py --task real_sr --scale 4`` builds SwinIR-M:
``upscale=4, in_chans=3, img_size=64, window_size=8, img_range=1.,
depths=[6]*6, embed_dim=180, num_heads=[6]*6, mlp_ratio=2,
upsampler='nearest+conv', resi_connection='1conv'``, 11,715,559 parameters.

The module and parameter names are the published ones (``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.{norm1,
attn.relative_position_bias_table, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}``, ``layers.{i}.conv``, ``norm``, ``conv_after_body``,
``conv_before_upsample.0``, ``conv_up{n}``, ``conv_hr``, ``conv_last``), so
a published state dict maps one to one (``io/checkpoint.py::
import_swinir`` drops its ``attn_mask`` and ``relative_position_index``
buffers, which the kernel recomputes):

  reflect-pad to a multiple of 8; x - mean; conv_first 3 -> C; tokens,
  LayerNorm; 6 RSTBs, each 6 Swin layers then unembed -> conv 3x3 -> embed
  + the RSTB's input; LayerNorm; unembed; conv_after_body + conv_first's
  output; conv_before_upsample C -> 64 + LeakyReLU 0.01; the nearest+conv
  tail shared with RRDBNet (``layers.nearest_conv_tail``); + mean; crop.
  A Swin layer: x += proj(WMSA(LN1(x))); x += fc2(GELU(fc1(LN2(x)))), its
  attention shifted by half a window in every odd layer of an RSTB.

Activations are NCHW in channels_last memory, so the (B, H*W, C) tokens
are a view of the conv input and output, no copy. ``dtype`` None (f32) or
torch.bfloat16: bf16 activations and GEMM/conv operands with f32
accumulation, LayerNorm and softmax statistics in f32, f32 parameters
(cast once a forward for the blocks: one cat and one cast) and output.

``fusion='auto'`` routes each layer's qkv, proj (+ the residual), fc1 (+
GELU) and fc2 (+ the residual) in bf16 on a card to the hand-written token
GEMM (``ops/token_gemm.py``, 144 launches a frame; the weights packed once
a forward beside the operands' cast, ``token_packs``), f32 ones to
``F.linear``, each layer's windowed attention to one launch of the
hand-written kernel (``ops/window_attention.py``, 36 a frame), the tail's
64 -> 64 convs to kernel A as RRDBNet's, and the convs at 180 channels
(one per RSTB, conv_after_body and conv_before_upsample), conv_first and
conv_last to cuDNN: kernel A takes 180 channels but is tuned for 64 and
128. At 180 -> 180 on the 272 x 480
frame in bf16 on an H100, kernel A takes 0.58 ms a call and cuDNN's conv
with its bias 0.45 alone, ~0.21 inside the frame; at 180 -> 64 the two
are even (``chip_smoke.py``'s ``time_swinir_kernel_a`` and
``run_swinir_main_path`` time them). ``'off'`` keeps every conv on
``F.conv2d`` and runs the attention's and the products' plain chains. On a
CPU tensor the kernels run their plain versions.

Spans (``utils/profiling.span``, the shared no-op while spans are off):
``swinir.body`` (fields ``groups``, the RSTBs; ``layers``, the Swin
layers; ``windows``, the 8 x 8 windows of a layer over the batch;
``shift``) around the RSTBs, and ``swinir.upsample`` (``octaves``) around
the tail's x2 stages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpusr_torch.device import resolve_device
from tpusr_torch.models.layers import (Conv, Dense, fusion_mode,
                                      nearest_conv_tail)
from tpusr_torch.ops import token_gemm
from tpusr_torch.ops.token_gemm import token_linear
from tpusr_torch.ops.window_attention import WINDOW, window_attention
from tpusr_torch.utils.profiling import span

RGB_MEAN = (0.4488, 0.4371, 0.4040)  # DIV2K's, as published
EPS = 1e-5  # nn.LayerNorm's
SLOPE_BEFORE_UPSAMPLE = 0.01  # nn.LeakyReLU's default, as published
LAYER_LEAVES = 12  # the leaves a Swin layer takes in the activations' dtype
# qkv's, proj's, fc1's and fc2's weights among a layer's leaves, and each
# product's epilogue in the token GEMM
PRODUCTS = ((2, "bias"), (4, "residual"), (8, "gelu"), (10, "residual"))


class LayerNorm(nn.Module):
    """nn.LayerNorm's parameters (``weight`` 1, ``bias`` 0); the forward
    takes them in the activations' dtype (``SwinIR.operands``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class PatchEmbed(nn.Module):
    """The top-level patch embedding's LayerNorm (``patch_embed.norm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)


class WindowAttention(nn.Module):
    """``relative_position_bias_table`` ((2w - 1)^2, heads), N(0, 0.02) as
    published, and the ``qkv`` (C -> 3C) and ``proj`` (C -> C) Linears."""

    def __init__(self, dim: int, heads: int, generator=None):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(((2 * WINDOW - 1) ** 2, heads)).normal_(
                0.0, 0.02, generator=generator))
        self.qkv = Dense(dim, 3 * dim, generator=generator)
        self.proj = Dense(dim, dim, generator=generator)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, generator=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, generator=generator)
        self.fc2 = Dense(hidden, dim, generator=generator)


class SwinLayer(nn.Module):
    """One Swin transformer block (the published ``SwinTransformerBlock``);
    ``shift`` 0 or half a window."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, shift: int,
                 plain: bool, generator=None):
        super().__init__()
        self.shift, self.plain = shift, plain
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, generator)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator)

    def operand_leaves(self) -> list[nn.Parameter]:
        """The leaves the forward takes in the activations' dtype, in the
        order ``forward`` unpacks them."""
        return [self.norm1.weight, self.norm1.bias, self.attn.qkv.weight,
                self.attn.qkv.bias, self.attn.proj.weight,
                self.attn.proj.bias, self.norm2.weight, self.norm2.bias,
                self.mlp.fc1.weight, self.mlp.fc1.bias,
                self.mlp.fc2.weight, self.mlp.fc2.bias]

    def forward(self, x, hw, ops, packs):
        """x: (B, H*W, C) tokens in image order; ops: ``operand_leaves``
        in x's dtype; packs: qkv's, proj's, fc1's and fc2's weights as
        ``token_gemm.pack`` lays them out, for the kernel, or None for the
        plain chain."""
        (n1w, n1b, qkv_w, qkv_b, proj_w, proj_b, n2w, n2b, fc1_w, fc1_b,
         fc2_w, fc2_b) = ops
        qkv_p, proj_p, fc1_p, fc2_p = (None,) * 4 if packs is None else packs
        c = x.shape[-1]
        qkv = token_linear(F.layer_norm(x, (c,), n1w, n1b, EPS), qkv_w, qkv_b,
                           packed=qkv_p)
        a = window_attention(qkv, self.attn.relative_position_bias_table,
                             hw, self.attn.heads, self.shift, self.plain)
        x = token_linear(a, proj_w, proj_b, residual=x, packed=proj_p)
        y = token_linear(F.layer_norm(x, (c,), n2w, n2b, EPS), fc1_w, fc1_b,
                         gelu=True, packed=fc1_p)
        return token_linear(y, fc2_w, fc2_b, residual=x, packed=fc2_p)


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, heads, mlp_ratio, plain, generator=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinLayer(dim, heads, mlp_ratio, 0 if j % 2 == 0 else WINDOW // 2,
                      plain, generator) for j in range(depth))


class RSTB(nn.Module):
    """Residual Swin transformer block: its Swin layers, then unembed ->
    conv 3x3 (``conv``, resi_connection '1conv') -> embed, + its input."""

    def __init__(self, dim, depth, heads, mlp_ratio, dtype, fusion,
                 generator=None):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, heads, mlp_ratio,
                                         fusion == "off", generator)
        self.conv = Conv(dim, dim, 3, dtype=dtype, generator=generator,
                         fusion=fusion)

    def forward(self, x, hw, ops, packs):
        y = x
        for blk, o, p in zip(self.residual_group.blocks, ops, packs):
            y = blk(y, hw, o, p)
        y = self.conv(_image(y, hw))
        return _tokens(y) + x


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last -> (B, H*W, C), a view."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).contiguous().view(b, h * w, c)


def _image(t: torch.Tensor, hw) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W) in channels_last memory, a view."""
    b, _, c = t.shape
    return t.view(b, *hw, c).permute(0, 3, 1, 2)


class SwinIR(nn.Module):
    """SwinIR with the nearest+conv upsampler (real-world SR). Input NCHW
    RGB in [0, 1]; output f32, unbounded, at ``upscale`` times the input's
    size. ``upscale`` 2 or 4 (conv_up1, and conv_up2 at 4, as published).
    dtype: None (the input's) or torch.bfloat16. fusion: 'auto' | 'off'.
    device: 'cuda' (default; raises without a card) or 'cpu'. Init: convs
    and Linears U(+-1/sqrt(fan_in)) from ``generator`` (the port's rule),
    bias tables N(0, 0.02), LayerNorms 1 and 0.
    """

    # what the engine and the CLI read of the model
    output_range = (0.0, 1.0)
    eval_only = True
    tiles = False  # tiles would have to be window-aligned

    @staticmethod
    def lr_tag(factor: int) -> str:
        return f"x{factor}"

    @classmethod
    def from_config(cls, config, dtype=None, device="cuda", generator=None,
                    **arch):
        """The net a ``GANTrainConfig`` describes (``factor``,
        ``conv_fusion``; SwinIR-M's widths); ``arch`` overrides the other
        constructor arguments (a checkpoint's widths)."""
        return cls(upscale=config.factor, fusion=config.conv_fusion,
                   dtype=dtype, device=device, generator=generator, **arch)

    @classmethod
    def load(cls, path: str, config, dtype=None, device="cuda"):
        """A published SwinIR .pth (bare, ``params`` or ``params_ema``) ->
        (the net of the file's widths on ``device``, config); an upscale
        that does not fit config.factor raises."""
        from tpusr_torch.io.checkpoint import (import_swinir,
                                               infer_swinir_arch,
                                               load_torch_state_dict)

        sd = load_torch_state_dict(path)
        arch = infer_swinir_arch(sd)
        if arch.pop("upscale") != config.factor:
            raise ValueError(f"{path} holds a SwinIR of another scale than "
                             f"--factor/--downsample's x{config.factor}")
        net = cls.from_config(config, dtype, device, **arch)
        net.load_state_dict(import_swinir(sd))
        return net, config

    def __init__(self, upscale: int = 4, in_chans: int = 3,
                 embed_dim: int = 180, depths=(6,) * 6, num_heads=(6,) * 6,
                 mlp_ratio: float = 2.0, num_feat: int = 64,
                 img_range: float = 1.0, dtype: torch.dtype | None = None,
                 fusion: str = "auto", device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if upscale not in (2, 4):
            raise ValueError(f"upscale {upscale} not in 2/4: the published "
                             f"nearest+conv upsampler has x2 stages "
                             f"conv_up1 and conv_up2")
        if len(depths) != len(num_heads):
            raise ValueError("depths and num_heads differ in length")
        fusion = fusion_mode(fusion)
        dev = resolve_device(device)
        self.plain = fusion == "off"
        self.dtype, self.upscale, self.img_range = dtype, upscale, img_range
        self.depths, self.shift = tuple(depths), WINDOW // 2

        def conv(cin, cout, fuse):
            return Conv(cin, cout, 3, dtype=dtype, generator=generator,
                        auto_fuse=fuse, fusion=fusion)

        self.conv_first = conv(in_chans, embed_dim, False)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, h, mlp_ratio, dtype, fusion, generator)
            for d, h in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = conv(embed_dim, embed_dim, False)
        self.conv_before_upsample = nn.Sequential(
            conv(embed_dim, num_feat, False))
        self.n_up = upscale.bit_length() - 1
        for i in range(1, self.n_up + 1):
            setattr(self, f"conv_up{i}", conv(num_feat, num_feat, True))
        self.conv_hr = conv(num_feat, num_feat, True)
        self.conv_last = conv(num_feat, in_chans, False)
        self.register_buffer("mean", torch.tensor(RGB_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.to(dev)

    def operand_leaves(self) -> list[nn.Parameter]:
        """The LayerNorm and Linear leaves the forward takes in the
        activations' dtype: the two top-level norms', then every layer's."""
        return [self.patch_embed.norm.weight, self.patch_embed.norm.bias,
                self.norm.weight, self.norm.bias] + [
            p for rstb in self.layers for blk in rstb.residual_group.blocks
            for p in blk.operand_leaves()]

    def operands(self, dtype: torch.dtype) -> list[torch.Tensor]:
        """``operand_leaves`` in ``dtype``: the leaves themselves in their
        own dtype, else one cat and one cast."""
        leaves = self.operand_leaves()
        if dtype == leaves[0].dtype:
            return leaves
        flat = torch.cat([p.reshape(-1) for p in leaves]).to(dtype)
        return [t.view(p.shape) for t, p in
                zip(flat.split([p.numel() for p in leaves]), leaves)]

    def token_packs(self, per_layer) -> list[tuple[torch.Tensor, ...]]:
        """Each layer's (qkv, proj, fc1, fc2) weights as the token GEMM
        reads them: one stack and one ``token_gemm.pack`` a product, every
        layer at once."""
        kinds = [token_gemm.pack(torch.stack([o[i] for o in per_layer]),
                                 epi).unbind(0) for i, epi in PRODUCTS]
        return list(zip(*kinds))

    def forward(self, x):
        h, w = x.shape[2:]
        pad_h, pad_w = (-h) % WINDOW, (-w) % WINDOW
        x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
        x = (x - self.mean.to(x.dtype)) * self.img_range
        if self.dtype is not None:
            x = x.to(self.dtype)
        fea = self.conv_first(x.contiguous(memory_format=torch.channels_last))
        ops = self.operands(fea.dtype)
        per_layer = [ops[i:i + LAYER_LEAVES]
                     for i in range(4, len(ops), LAYER_LEAVES)]
        packs = (self.token_packs(per_layer)
                 if token_gemm.on_kernel(fea) and not self.plain
                 else [None] * len(per_layer))
        hw = tuple(fea.shape[2:])
        with span("swinir.body", groups=len(self.layers),
                  layers=sum(self.depths),
                  windows=fea.shape[0] * hw[0] * hw[1] // WINDOW ** 2,
                  shift=self.shift):
            c = fea.shape[1]
            t = F.layer_norm(_tokens(fea), (c,), ops[0], ops[1], EPS)
            for rstb in self.layers:
                n = len(rstb.residual_group.blocks)
                t = rstb(t, hw, per_layer[:n], packs[:n])
                per_layer, packs = per_layer[n:], packs[n:]
            t = F.layer_norm(t, (c,), ops[2], ops[3], EPS)
        fea = self.conv_after_body(_image(t, hw)) + fea
        del t, ops, per_layer, packs  # what the tail's peak need not hold
        fea = F.leaky_relu(self.conv_before_upsample(fea),
                           SLOPE_BEFORE_UPSAMPLE)
        y = nearest_conv_tail(
            fea, [getattr(self, f"conv_up{i}")
                  for i in range(1, self.n_up + 1)],
            self.conv_hr, self.conv_last, "swinir.upsample")
        y = y / self.img_range + self.mean
        return y[:, :, :h * self.upscale, :w * self.upscale]
