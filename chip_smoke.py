"""Smoke run of tpusr_torch on one NVIDIA GPU: kernels, main paths, times.

    python3 chip_smoke.py

Kernels A, B and C run on the tensor cores: wgmma in bf16 and 3xTF32
mma.sync in f32 (three TF32 products per f32 product, so the f32 gates
below hold unchanged); D and E as before.

Phases (any failure raises, so the exit code is non-zero):
  1. build the CUDA kernels from tpusr_torch/csrc (one nvcc per source, in
     parallel, sm_90a): A and B (fused_conv3x3.cu), C (dense_block.cu),
     D and E (degrade.cu), the skip net's BatchNorm glue (bn_act.cu),
     SwinIR's windowed attention (window_attention.cu) and token linears
     (token_gemm.cu);
  2. hold each kernel against its plain PyTorch version at its main path's
     shapes: f32 kernels against the plain version in f64 (max relative
     error 1e-4), bf16 ones against it in bf16 (2e-2); C also on its own
     part, y - x (``part_err``). A and B at the DIP
     shapes; C (tpusr/ops/pallas_dense.py:103) at the RRDB trunk's
     (1, 270, 480, 64) and at ragged shapes on each side of its tiles'
     edges (16 x 16 in bf16, 8 x 8 in f32); A in the RRDB configuration
     (zero pad, no prologue, 64 -> 64) at 270 x 480, 540 x 960 and
     1080 x 1920; A in the SRGAN configuration (zero pad, no prologue,
     64 -> 64 and 64 -> 256) at every shape the x8 eval of a 128^2 and of
     an 84 x 127 LR image gives it, and at 85 x 127; A (forward and dgrad,
     Cin 256 in the dgrads of the 64 -> 256 convs) and B at every shape the
     SRGAN training G gives them under g_fuse='train' (batch 8, 24^2, 48^2,
     96^2); D and E (tpusr/ops/pallas_degrade.py:
     38, 52) at a DIV2K HR frame (1356 x 2040 x 3) and at 85 x 128, 7 x 9
     and 1 x 1, seeds 0, 1 and 2^31 - 1: salt and pepper exactly equal (it
     is a function of the Philox uniforms alone, so this holds the integer
     path exactly), Gaussian equal except at a fraction <= 1e-4 of elements
     off by exactly 1 (log/cos of two libraries an ulp apart next to an
     integer); then tests/test_pallas.py's statistics on the HR frame;
     the BatchNorm glue's five kernels (ops/bn_act.py) at the DIP shapes
     (512^2, 256^2 and 16^2 at 128 channels, the 512^2 skip branch at 4)
     against their plain versions in f64, the (C,) f32 sums at 1e-4 in
     both dtypes; the window kernel (ops/window_attention.py) at SwinIR-M's
     qkv on the benchmark's frame, (1, 272 * 480, 540) with 6 heads of 30,
     f32 and bf16, unshifted and shifted by 4, against the plain chain in
     f64 (max relative error and its own part, the worst 8 x 8 window's
     rms error over the output's rms, both under 1e-4 / 2e-2), one launch
     a call; head 1's bias zeroed must read above the limit; the token
     GEMM (ops/token_gemm.py) at SwinIR-M's four products (qkv 180 -> 540,
     proj 180 -> 180 + residual, fc1 180 -> 360 + GELU, fc2 360 -> 180 +
     residual) on the frame's 130,560 tokens and on 1,919, bf16, against
     the plain chain in f64 (max relative error under 1e-2, rms relative
     error under 5e-3), one launch a call; K's tail dropped must read
     above both;
  3. DIP: check the whole fused net against the unfused one (in f64) on a
     128^2 input, then drive the main path, ``tpusr_torch.cli.dip.main``,
     at full width (input 32, 128 channels, 5 scales, x8) on a synthetic
     DIV2K-layout pair (512^2 HR canvas): 100 f32 iterations and a short
     bf16 run, with the kernels' launch counts read around each run; then
     the time of one iteration and a torch.profiler breakdown of it, whose
     window must record all 20 kernel-A and 10 kernel-B launches and the
     BatchNorm glue's 170 of each fused iteration;
  4. RRDB: the full-width RRDBNet (nf 64, nb 23, gc 32, x4), fused in f32
     against unfused in f64 on a 27 x 45 input (ragged tiles at every
     scale); then bench.py's rrdb
     workload, ``RRDBNet(scale=4, dtype=...).forward`` under
     inference_mode on a 270 x 480 LR frame (1080 x 1920 out), in f32 and
     bf16: 69 kernel-C and 4 kernel-A launches per frame (the weight units
     of all 69 blocks packed anew in each frame), the frame time (fused and
     unfused) and a torch.profiler breakdown of one frame; then SwinIR-M
     x4 (embed 180, 6 x 6 Swin layers, window 8), fused in f32 against
     unfused in f64 on a 20 x 28 input (reflect pad, shifted masks; TF32
     off, 1e-4), and the benchmark's swinir entry, ``generator_forward``
     with ``GANTrainConfig(generator='swinir', factor=4)`` on a 270 x 480
     frame in f32 and bf16: 36 window-kernel and 3 kernel-A launches a
     frame, and in bf16 144 token-GEMM launches (none in f32), the frame
     time fused and unfused and a profiled frame;
  5. SRGAN x8 eval: the full-width Generator (16 blocks, 1,697,175
     parameters, seeded weights and running statistics), fused in f32
     against unfused in f64 on a 24 x 40 input, with cuDNN's TF32 off (to
     1e-4) and on, as the CLI runs its 9x9 convs (to 2e-3); then the main
     path, ``tpusr_torch.cli.eval_gan.run`` with --device cuda in f32
     and bf16, on a synthetic DIV2K valid tree (a 2048^2 HR with its 256^2 x8 LR, which
     the loader's /2 makes bench.py's 128^2 -> 1024^2, and a ragged
     2040 x 1356 HR with its 255 x 169 LR) and a reference-named .pth that
     the port's export wrote: 36 kernel-A launches per image and none of
     B-E; then ``generator_forward`` at 128^2 -> 1024^2 (CUDA events, 2
     warm-up and 10 timed; fused and cuDNN; f32 also with TF32 off) and a
     profiled window of three images that must record all 36 kernel-A
     launches of each (as the RRDB frame's window all its kernel-C and A
     launches), or is taken again, five times at most;
  6. the degradation path: ``fused_add_gaussian_noise`` and
     ``fused_add_salt_pepper_noise`` on the DIV2K HR frame, with their
     launch counts (these functions are the kernels' only entry);
  7. time each kernel, its plain version and the PyTorch calls computing
     the same function (kernel and library: device time per call, the
     calls queued behind a sleep kernel, the kernel's time per call from
     Python beside it; plain versions: CUDA events),
     beside the least time the card could take: A and
     B in f32 and bf16 at down0_conv2 and up0_conv against one cuDNN call
     each (F.conv2d, conv2d_weight; f32 without TF32), with f32's FMA
     and 3xTF32 bounds both named (the bound is the lower); A and B at the
     SRGAN training shapes (batch 8) against cuDNN too; the BatchNorm
     glue's kernels at up0's 512^2 x 128 in f32 and bf16, each beside its
     bytes at 3.35 TB/s, its plain version and, as a yardstick the port
     never calls, F.batch_norm + F.leaky_relu (forward or autograd's
     backward); the window kernel at SwinIR-M's qkv in f32 and bf16,
     unshifted and shifted, beside its bytes at 3.35 TB/s, the plain chain
     and F.scaled_dot_product_attention on windows already cut; kernel A
     at SwinIR's 180 -> 180 and 180 -> 64 convs against cuDNN with its
     bias (why those convs stay on cuDNN); the token GEMM at the frame's
     four products beside their bytes at 3.35 TB/s, the plain chain and
     F.linear (cuBLAS) with ATen's GELU or residual add;
  8. SRGAN training at full width (16 blocks, x8, D at 192^2, batch 8):
     the training G's forward and backward, fused (g_fuse 'train') in f32
     against the unfused net in f64 on the 24^2 patch (output 1e-4,
     parameter gradients 1e-3, TF32 off); then the main path,
     ``tpusr_torch.cli.train_gan.run`` with --device cuda, in f32 and bf16,
     on a synthetic DIV2K train tree of 16 images (96^2 LR after the
     loader's /2, as bench.py), 2 pre-train and 1 fine-tune epochs, in
     this process (default routing: no kernel launch) and in a subprocess
     with TPUSR_G_FUSE=train (72 A and 36 B per step, 36 A per metrics
     forward): files, finite losses, the pre-trained G.pth serving the
     eval loader; then bench.py's gan_train workload (bf16 activations,
     bf16 D state, MSE content, random uint8 stacks) in patches/s over 50
     steps after 6, g_fuse eval and train, bf16 and f32, and a profiled
     step of each (busy, idle share, operations; G forward, D update,
     G update, Adam, glue and VGG19 content by windows of their own).
  9. DIP variants and tiled eval, full width, f32, kernels on: through
     ``tpusr_torch.cli.dip.run`` with --device cuda on the 512^2 canvas,
     L-BFGS 'fixed' and 'zoom' (100 Adam warm-up + 10 iterations, loss
     falling; the zoom row prints its objective evaluations per
     iteration), meshgrid input (input_depth 2), opt_over net,input,down
     (z and the kernel moved), --bucket 64 on a 496 x 472
     HR (the PNG keeps that size), --bucket 64 --batch_images 2 (two
     images logged) and --profile_dir (a trace file written), 20
     iterations each (5 for the profile): at least 20 kernel-A and 10
     kernel-B launches per gradient evaluation, PSNR finite (and rising
     on the other Adam rows); then each variant's
     steady-state ms per iteration beside the Adam iteration's (each
     timed twice, in ABBA order); then
     ``tiled_generator_forward`` with 4 tiles of a 512 x 128 LR (windows
     of 224 rows) against the whole-image forward (TF32 off, 1e-4
     max-abs), 36 kernel-A launches per call, both timed.
 10. the multi-device paths (``tpusr_torch/parallel``), with one card:
     (a) the native loader's status ('built' or 'unavailable: <reason>');
     where it builds, byte-identical to the PIL path on the phase-5 valid
     tree and the phase-8 train tree; (b) NCCL at world size 1 in this
     process: ``make_dp_train_step`` at bench.py's gan_train shapes,
     g_fuse='train', bf16 and f32, equal to ``gan_train_step`` from the
     same state (cuDNN deterministic, TF32 off: f32 within 1e-5, bf16
     within 2^-8 relative, first moments within 1e-6; bit-equal so far),
     72 A and 36 B launches per
     step, both timed (host clock, ABBA) with the step's collectives
     counted and one timed (also a plain all-reduce in a fresh process,
     with torch's NCCL flight recorder on and off); one shard of ``sharded_generator_forward``
     equals ``generator_forward``; (c) two processes sharing the card in
     a gloo group (NCCL refuses two ranks on one GPU; every collective is
     staged through host memory): the 2-shard forward of a 512 x 128 LR
     at 16 blocks (slabs of 256 >= 2 halo = 96, edge-exact) within 1e-4
     of the whole forward (TF32 off), 36 A per rank, both timed; one DP
     step at W=2 (global batch 8, f32) against one process (losses 5e-4,
     state 1e-3, D's first moments DP_D_GRAD_REL) and an exact step (f64,
     lr 0, adv_weight 0: both nets' first moments EXACT_GRAD_REL), 72 A
     and 36 B per rank; ``dip_superresolve_sharded`` with 2 lanes of the
     full-width 512^2 net for 10 iterations against
     ``dip_superresolve_batch`` in one process (head 0 within 1e-4 dB,
     lanes in order, head 1's PSNR and loss within SHARDED_DIP_DB /
     SHARDED_DIP_LOSS, which the batch at learning rate 0 must exceed;
     later heads printed beside a rerun of the same batch, which parts as
     far), and the lane batch's gradient against each lane alone; (d) the
     DIP iteration per image: the lane batch at N = 2 and 4 against the
     loop of ``dip_superresolve_scan_bucketed`` (conv_fusion auto and
     off); (e) the L-BFGS lanes: ``dip_superresolve_batch`` with
     optimizer 'lbfgs', 'fixed' and 'zoom', 2 lanes of the full-width net
     on 512^2 canvases, f32, TF32 off, 100 warm-up steps + 10 iterations:
     no launch of A-E (tpusr's vmap path is unfused), every lane's loss
     finite and falling; from the engine's warm-up state, one iteration
     batched against each lane alone (the lane objective of that lane
     only): the same trial counts per lane, the update within 1e-3 (rel.
     L2), the single run's own net printed beside it; ms per
     iteration per image against the loop (conv_fusion auto, ABBA), with
     the batched calls per iteration beside each lane's evaluations.
     Phase 2 holds A and B at the new paths' shapes: a slab's window
     (352 x 128) and a DP rank's batch of 4.
 11. tpusr's orbax checkpoint directories (``tpusr_torch/io``: the port's
     own zstd decoder, OCDBT reader, zarr v2 and orbax trees): (a) the
     full-width gan_train state (bench.py's: batch 8, 192^2 HR, 16 blocks,
     bf16 activations and D state, g_fuse='train', seed 0) after 2 steps,
     written by ``save_train_state`` and read by ``load_train_state`` into
     a fresh state: every leaf, moment and the step bit-equal; the bytes
     on disk and the write and read seconds (MB/s) beside torch.save /
     torch.load of the same tree; (b) one step from the restored state
     against one from the in-memory state (cuDNN deterministic, TF32
     off): losses bit-equal, or apart by no more than two steps from two
     restores of the directory; 72 A and 36 B launches each; (c)
     ``cli/eval_gan.run`` with --model_path that directory on the phase-5
     synthetic tree: 36 A launches per image, its PNGs and metrics
     bit-equal to the .pth route of the same G; (d) the committed
     tpusr-written checkpoint (tests/data/orbax_tpusr_small: OCDBT nodes
     and zarr chunks compressed with zstd) decoded on the host by the
     port's zstd, OCDBT and zarr code: every leaf equal to its seed's
     values.
The line before the last holds the kernels' JSON record (each kernel with
its design and its launches per main path), the last line
{"ok": true, "device": {...}}. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks: f32 FMA, bf16 and TF32 tensor cores (data sheet); 32-bit
# integer instructions, 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper white
# paper), the lowest rate the Philox work of kernels D and E issues at
RATE = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int32: 16.7e12,
        "tf32": 495e12}
MEM_BW = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# TF32 keeps 11 significant bits of each cuDNN conv input (unit roundoff
# 2^-11 = 4.9e-4); the eval CLI's f32 output, with its two 9x9 convs in
# TF32, is held to the f64 net at four times that
TF32_TOL = 2e-3
C = 128  # DIP skip-net width
# profiler names of kernel A (fwd_bf16_kernel<N, R>, fwd_tf32_kernel) and
# kernel B (wgrad_bf16_kernel, wgrad_tf32_kernel), which live in an
# anonymous namespace (cuDNN has wgrad_* kernels of its own)
KERNEL_A, KERNEL_B = "namespace)::fwd_", "namespace)::wgrad_"
# kernel C's profiler names: dense_block_kernel_bf16, dense_block_kernel_f32
KERNEL_C = "namespace)::dense_block_kernel_"
# profiler names of the BatchNorm glue's kernels (bn_act.cu), by LAUNCHES key
BN_ACT = {k: f"namespace)::{k}_kernel" for k in (
    "channel_moments", "affine_act", "affine_act_grad", "moments_grad",
    "partials_sum")}
# their launches in one DIP training iteration (5 levels): 5 moments and 5
# normalizes a level forward; 7 normalize backwards (5 folded into the
# moments' backward) and 5 moments' backwards; a partials sum after each of
# the 12 reductions
DIP_ITER_BN_ACT = {"channel_moments": 25, "affine_act": 25,
                   "affine_act_grad": 35, "moments_grad": 25,
                   "partials_sum": 60}
# kernel launches of one DIP training iteration: 10 fused convs forward,
# their 10 dgrads (kernel A) and 10 wgrads (kernel B), and the glue's
DIP_ITER_LAUNCHES = {KERNEL_A: 20, KERNEL_B: 10,
                     **{BN_ACT[k]: n for k, n in DIP_ITER_BN_ACT.items()}}
LR_RRDB = (270, 480)  # bench.py's rrdb workload: a 1080 x 1920 frame at x4
# kernel C at sides on each side of its tiles' edges: 7, 8, 9 and 19 (the
# f32 tile of 8) and 15, 16, 17 and 35 (the bf16 tile of 16), N = 2
DENSE_EDGE_SHAPES = ((2, 7, 9), (2, 8, 19), (2, 15, 16), (2, 17, 35),
                     (1, 35, 15), (1, 1, 1), (1, 40, 3))
LR_GAN = (128, 128)  # bench.py's gan_eval workload: 128^2 -> 1024^2 at x8
LR_RAGGED = (84, 127)  # a 2040 x 1356 DIV2K image's 255 x 169 x8 LR, halved
DIV2K_HR = (1356, 2040)  # a DIV2K HR frame, H x W
# per-thread integer instructions of one Philox4x32-10 call, at most: 10
# rounds of 4 multiplies and 2 LOP3 XORs; the key schedule is warp-uniform
# or folds (degrade.cu's header)
PHILOX_OPS = 60


def path_variants():
    """(name, size, prologue act, has base) of every fused conv on the DIP
    path at a 512^2 canvas: down{i}_conv2 (BN1 affine + LeakyReLU prologue)
    and the trunk part of up{i}_conv (merge-BN affine, skip part as base)."""
    for i in range(5):
        yield f"down{i}_conv2", 256 >> i, "leaky_relu", False
    for i in range(5):
        yield f"up{i}_conv", 512 >> i, None, True


def operands(size, act, has_base, dtype, gen):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    return dict(
        x=rnd(1, size, size, C).to(dtype),
        w=(rnd(3, 3, C, C) * 0.03).to(dtype),
        es=rnd(C).abs() + 0.5, eb=rnd(C) * 0.1,
        base=rnd(1, size, size, C).to(dtype) if has_base else None,
        g=rnd(1, size, size, C).to(dtype), act=act)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def abs_err(a, b):
    return float((a.double() - b.double()).abs().max())


def part_err(y, yr, x):
    """Kernel C's own part against its plain version: the largest rms of
    y - yr over 16 x 16-pixel windows, over the rms of yr - x (0.2 c5) on
    the whole output. x passes through y unchanged and sets y's largest
    value, so rel_err alone lets a weight unit left out or read from a
    stale slot pass; this measure does not."""
    d = (y.double() - yr.double()).square().mean(-1)[:, None]
    worst = F.avg_pool2d(d, 16, 16, ceil_mode=True).sqrt().max()
    return float(worst / (yr.double() - x.double()).square().mean().sqrt())


def check_kernels(fc):
    """Phase 2; returns the largest f32 absolute error of each kernel."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"fused_conv3x3_fwd": 0.0, "fused_conv3x3_wgrad": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, size, act, has_base in path_variants():
            o = operands(size, act, has_base, dtype, gen)
            x, w, es, eb, base, g = (o[k] for k in ("x", "w", "es", "eb",
                                                    "base", "g"))
            # the plain side takes the same values; f32 ones in f64, since
            # cuDNN's own f32 wgrad is far less exact than kernel B at
            # 512^2 (the "plain f32 wgrad" column) and would eat most of
            # the tolerance
            p = {k: (v.double() if torch.is_tensor(v) and dtype ==
                     torch.float32 else v) for k, v in o.items()}
            y, st = fc.fused_conv3x3_fwd(x, w, es, eb, base, act=act,
                                         reflect=True, stats=True)
            yr, sr = fc.fused_conv3x3_fwd_reference(
                p["x"], p["w"], p["es"], p["eb"], p["base"], act=act,
                reflect=True, stats=True)
            w_rot = w.flip(0, 1).transpose(2, 3).contiguous()
            d, _ = fc.fused_conv3x3_fwd(g, w_rot, reflect=False)
            dr, _ = fc.fused_conv3x3_fwd_reference(
                p["g"], p["w"].flip(0, 1).transpose(2, 3), reflect=False)
            dw = fc.fused_conv3x3_wgrad(x, g, es, eb, act=act, reflect=True)
            dwr = fc.fused_conv3x3_wgrad_reference(
                p["x"], p["g"], p["es"], p["eb"], act=act, reflect=True)
            torch.cuda.synchronize()
            errs = {"fwd": rel_err(y, yr), "stats": rel_err(st, sr),
                    "dgrad": rel_err(d, dr), "wgrad": rel_err(dw, dwr)}
            if dtype == torch.float32:
                errs["plain f32 wgrad"] = rel_err(
                    fc.fused_conv3x3_wgrad_reference(x, g, es, eb, act=act,
                                                     reflect=True), dwr)
            print(f"check {name} {size}^2 {str(dtype)[6:]}: " + " ".join(
                f"{k} {v:.3e}" for k, v in errs.items()))
            errs.pop("plain f32 wgrad", None)
            bad = {k: v for k, v in errs.items() if not v <= TOL[dtype]}
            if bad:
                raise AssertionError(f"{name} {dtype}: kernel disagrees with "
                                     f"its plain version: {bad}")
            if dtype == torch.float32:
                worst["fused_conv3x3_fwd"] = max(
                    worst["fused_conv3x3_fwd"], abs_err(y, yr),
                    abs_err(d, dr))
                worst["fused_conv3x3_wgrad"] = max(
                    worst["fused_conv3x3_wgrad"], abs_err(dw, dwr))
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults again
    return worst


def check_fused_net():
    """Phase 3a: the full-width net, fused ('auto', f32) against the
    unfused dataflow ('off', plain PyTorch) run in f64 from the same weights
    on a small input: outputs and parameter gradients. The f32 unfused net's
    own distance from the f64 one is printed beside it for scale."""
    from tpusr_torch.models.skip import build_dip_net

    torch.backends.cudnn.allow_tf32 = False
    nets = {}
    for fusion in ("auto", "off"):
        net = build_dip_net(conv_fusion=fusion,
                            generator=torch.Generator().manual_seed(0))
        nets[fusion] = net.to("cuda", memory_format=torch.channels_last)
    nets["off_f64"] = build_dip_net(
        conv_fusion="off", generator=torch.Generator().manual_seed(0)).to(
        "cuda", torch.float64, memory_format=torch.channels_last)
    # not below 128^2: at 64^2 the deepest BatchNorm sees 2x2 pixels, and
    # f32 rounding alone then moves down4_conv1's gradient by about the
    # tolerance, fused or not
    size = 128
    z = torch.rand(1, size, size, 32, generator=torch.Generator().manual_seed(1))
    z = z.cuda().permute(0, 3, 1, 2)
    outs, grads = {}, {}
    for name, net in nets.items():
        y = net(z.to(next(net.parameters()).dtype))
        y.square().mean().backward()
        outs[name] = y.detach()
        # all gradients as one vector, against its largest entry: a bias
        # that a BatchNorm cancels has zero gradient in exact arithmetic,
        # and rounding noise there has no scale of its own
        grads[name] = torch.cat([p.grad.flatten() for p in net.parameters()])
    err = {k: (rel_err(outs[k], outs["off_f64"]),
               rel_err(grads[k], grads["off_f64"])) for k in ("auto", "off")}
    print(f"net at {size}^2, full width, against the f64 unfused net: fused "
          f"f32 out {err['auto'][0]:.3e} grads {err['auto'][1]:.3e}; "
          f"unfused f32 out {err['off'][0]:.3e} grads {err['off'][1]:.3e}")
    if not (err["auto"][0] < 1e-4 and err["auto"][1] < 1e-3):
        raise AssertionError("fused net disagrees with the unfused net")
    torch.backends.cudnn.allow_tf32 = True


# ------------------------------------------------------ BatchNorm glue
# (label, NHWC shape) of the glue at the DIP path's sizes (a 512^2 canvas)
BN_ACT_SHAPES = (("up0", (1, 512, 512, C)), ("down0", (1, 256, 256, C)),
                 ("deepest", (1, 16, 16, C)), ("skip0", (1, 512, 512, 4)))


def bn_act_operands(shape, dtype, gen):
    """x, g (NHWC, dtype), es, eb, dm1, dm2 ((C,) f32)."""
    c = shape[-1]

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    return ((rnd(*shape) * 1.5 + 0.3).to(dtype), rnd(*shape).to(dtype),
            rnd(c).abs() + 0.5, rnd(c) * 0.5, rnd(c), rnd(c))


def bn_act_plain(x, g, es, eb, dm1, dm2, act="leaky_relu"):
    """Each glue kernel's result from the plain versions, in f64."""
    from tpusr_torch.ops import bn_act

    x, g, es, eb, dm1, dm2 = (t.double() for t in (x, g, es, eb, dm1, dm2))
    n = x.numel() // x.shape[-1]
    xn = x.permute(0, 3, 1, 2)
    m1, m2 = bn_act.channel_moments_reference(xn)
    dx, des, deb = bn_act.prologue_backward_reference(g, x, es, eb, act)
    return {"channel_moments": (m1, m2),
            "affine_act": (bn_act.affine_act_reference(xn, es, eb, act)
                           .permute(0, 2, 3, 1),),
            "affine_act_grad": (dx, des, deb),
            "moments_grad": ((dm1 + 2 * x * dm2) / n + dx,)}


def bn_act_kernels(x, g, es, eb, dm1, dm2, act="leaky_relu"):
    from tpusr_torch.ops import bn_act

    return {"channel_moments": bn_act._moments_cuda(x),
            "affine_act": (bn_act._affine_act_cuda(x, es, eb, act),),
            "affine_act_grad": bn_act._affine_act_grad_cuda(g, x, es, eb,
                                                            act, True),
            "moments_grad": (bn_act._moments_grad_cuda(
                x, dm1, dm2, (g, es, eb, act)),)}


def check_bn_act_kernels():
    """Phase 2, the BatchNorm glue: each kernel at BN_ACT_SHAPES against the
    plain versions in f64 (the bf16 kernels on the same bf16 values):
    max |kernel - plain| / max |plain| under 1e-4 for the (C,) f32 sums in
    both dtypes and for f32 activations, 2e-2 for bf16 ones. Returns each
    kernel's largest f32 absolute error (partials_sum's: the sums')."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {k: 0.0 for k in BN_ACT}
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape in BN_ACT_SHAPES:
            ops = bn_act_operands(shape, dtype, gen)
            got, want = bn_act_kernels(*ops), bn_act_plain(*ops)
            torch.cuda.synchronize()
            errs = {}
            for k in got:
                for i, (a, b) in enumerate(zip(got[k], want[k])):
                    tol = 1e-4 if a.dim() == 1 else TOL[dtype]
                    errs[f"{k}[{i}]"] = (rel_err(a, b), tol)
                    if dtype == torch.float32:
                        worst[k] = max(worst[k], abs_err(a, b))
                        if a.dim() == 1:
                            worst["partials_sum"] = max(
                                worst["partials_sum"], abs_err(a, b))
            print(f"check bn_act {label} {shape} {str(dtype)[6:]}: " + " ".join(
                f"{k} {v:.3e}" for k, (v, _) in errs.items()))
            bad = {k: v for k, v in errs.items() if not v[0] < v[1]}
            if bad:
                raise AssertionError(f"bn_act at {label} {dtype}: kernels "
                                     f"disagree with the plain versions: "
                                     f"{bad}")
    return worst


def time_bn_act_kernels():
    """Phase 7, the BatchNorm glue at up0's (1, 512, 512, 128), f32 and
    bf16: each kernel's device time beside its bytes (read once, written
    once) at 3.35 TB/s, its plain version's time and a yardstick the port
    never calls, F.batch_norm + F.leaky_relu: training-mode forward for the
    moments (which also normalizes), eval-mode forward for the normalize,
    autograd's backward of the eval-mode pair for the normalize backward
    and of the training-mode pair for the moments' (folded) backward.
    partials_sum is timed inside the launches that end with it."""
    from tpusr_torch.ops import bn_act

    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = BN_ACT_SHAPES[0][1]
    p, c = shape[0] * shape[1] * shape[2], shape[3]
    rows = {k: {} for k in BN_ACT if k != "partials_sum"}
    for dtype in (torch.float32, torch.bfloat16):
        x, g, es, eb, dm1, dm2 = bn_act_operands(shape, dtype, gen)
        isz, act = x.element_size(), "leaky_relu"
        act_bytes = p * c * isz
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w, b = es.to(dtype), eb.to(dtype)
        rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        xl = xn.detach().clone().requires_grad_()
        wl, bl = w.clone().requires_grad_(), b.clone().requires_grad_()
        y_eval = F.leaky_relu(F.batch_norm(xl, rm, rv, wl, bl, False), 0.2)
        y_train = F.leaky_relu(F.batch_norm(xl, None, None, wl, bl, True),
                               0.2)
        pending = (g, es, eb, act)

        def plain_moments_grad():
            xf = x.float()
            d = torch.where(xf * es + eb >= 0, g.float(), g.float() * 0.2)
            return ((dm1 + 2 * xf * dm2) / p + d * es).to(dtype)

        ops = {
            "channel_moments": (
                lambda: bn_act._moments_cuda(x),
                lambda: bn_act.channel_moments_reference(xn),
                lambda: F.batch_norm(xn, None, None, w, b, True),
                act_bytes + 2 * c * 4, 3 * p * c),
            "affine_act": (
                lambda: bn_act._affine_act_cuda(x, es, eb, act),
                lambda: bn_act.affine_act_reference(xn, es, eb, act),
                lambda: F.leaky_relu(F.batch_norm(xn, rm, rv, w, b, False),
                                     0.2),
                2 * act_bytes + 2 * c * 4, 3 * p * c),
            "affine_act_grad": (
                lambda: bn_act._affine_act_grad_cuda(g, x, es, eb, act, True),
                lambda: bn_act.prologue_backward_reference(g, x, es, eb, act),
                lambda: torch.autograd.grad(y_eval, (xl, wl, bl), gn,
                                            retain_graph=True),
                3 * act_bytes + 4 * c * 4, 6 * p * c),
            "moments_grad": (
                lambda: bn_act._moments_grad_cuda(x, dm1, dm2, pending),
                plain_moments_grad,
                lambda: torch.autograd.grad(y_train, (xl, wl, bl), gn,
                                            retain_graph=True),
                3 * act_bytes + 4 * c * 4, 7 * p * c),
        }
        for k, (kern, plain, lib, nbytes, flops) in ops.items():
            row = measure(f"{k} at up0 {shape} {str(dtype)[6:]}", kern,
                          plain, lib, flops, nbytes, torch.float32)
            row["shape"] = f"up0: {shape}, {str(dtype)[6:]}"
            rows[k][str(dtype)[6:]] = row
        del xl, wl, bl, y_eval, y_train
    return rows


def write_pair(root):
    """A synthetic DIV2K-layout pair: HR 1024^2 and LR_x8 128^2, which
    get_image_pair's /2 turns into a 512^2 HR / 64^2 LR canvas."""
    from PIL import Image

    hr_dir = os.path.join(root, "DIV2K_train_HR")
    lr_dir = os.path.join(root, "DIV2K_train_LR_x8")
    os.makedirs(hr_dir)
    os.makedirs(lr_dir)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:1024, 0:1024].astype(np.float32)
    img = np.stack([np.sin(xx / 37.0) * np.cos(yy / 23.0),
                    np.sin((xx + yy) / 51.0), np.cos(xx / 17.0 - yy / 29.0)],
                   -1) * 90 + 128
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    hr = Image.fromarray(img)
    hr.save(os.path.join(hr_dir, "0001.png"))
    hr.resize((128, 128), Image.BICUBIC).save(
        os.path.join(lr_dir, "0001x8.png"))
    return lr_dir, hr_dir


def reset_counts():
    from tpusr_torch.ops import bn_act
    from tpusr_torch.ops import dense_block as db
    from tpusr_torch.ops import fused_conv as fc
    from tpusr_torch.ops import fused_degrade as fd
    from tpusr_torch.ops import token_gemm as tg
    from tpusr_torch.ops import window_attention as wa

    fc.reset_launch_counts()
    db.reset_launch_counts()
    fd.reset_launch_counts()
    bn_act.reset_launch_counts()
    wa.reset_launch_counts()
    tg.reset_launch_counts()


def read_counts():
    from tpusr_torch.ops import bn_act
    from tpusr_torch.ops import dense_block as db
    from tpusr_torch.ops import fused_conv as fc
    from tpusr_torch.ops import fused_degrade as fd
    from tpusr_torch.ops import token_gemm as tg
    from tpusr_torch.ops import window_attention as wa

    return {**fc.LAUNCHES, **db.LAUNCHES, **fd.LAUNCHES, **bn_act.LAUNCHES,
            **wa.LAUNCHES, **tg.LAUNCHES}


def run_main_path(cli, root, dtype, num_iter, log_freq):
    """Phase 3b: one CLI main() run with the launch counts around it."""
    lr_dir, hr_dir = os.path.join(root, "DIV2K_train_LR_x8"), os.path.join(
        root, "DIV2K_train_HR")
    out_dir = os.path.join(root, f"out_{dtype}")
    config = cli.DIPConfig(factor=8, num_iter=num_iter, log_freq=log_freq,
                           dtype=dtype)
    reset_counts()
    t0 = time.perf_counter()
    metrics = cli.main(lr_dir, hr_dir, out_dir, 8, 1, config, True, None,
                       False, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    curve = [float(v) for v in metrics["Average PSNR per epoch"]]
    final = float(metrics["Average final PSNR"])
    print(f"main path {dtype}: {num_iter} iters in {wall:.3f} s "
          f"({wall / num_iter:.5f} s/iter incl. set-up, metrics and PNGs); "
          f"PSNR curve {curve} final {final:.4f}; launches {counts}")
    from PIL import Image
    png = Image.open(os.path.join(out_dir, "images", "0001_resolved.png"))
    if png.size != (512, 512):
        raise AssertionError(f"resolved image is {png.size}, not 512^2")
    if not (np.all(np.isfinite(curve)) and np.isfinite(final)
            and curve[-1] > curve[0]):
        raise AssertionError(f"PSNR not finite and rising: {curve} {final}")
    if not (counts["fused_conv3x3_fwd"] >= 20 * num_iter
            and counts["fused_conv3x3_wgrad"] >= 10 * num_iter
            and all(counts[k] >= n * num_iter
                    for k, n in DIP_ITER_BN_ACT.items())):
        raise AssertionError(f"main path missed the kernels: {counts}")
    return counts


def dip_step(dtype, fusion):
    """One DIP iteration at 512^2 x8, full width, as a closure."""
    from tpusr_torch.engine import dip

    config = dip.DIPConfig(dtype=dtype, conv_fusion=fusion)
    net, down = dip.build(config, torch.Generator().manual_seed(0))
    net.to("cuda", memory_format=torch.channels_last)
    down.to("cuda")
    opt = dip.make_optimizer(net, config)
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.rand(1, 512, 512, 32, generator=gen,
                   device="cuda").permute(0, 3, 1, 2) * 0.1
    lr = torch.rand(1, 3, 64, 64, generator=gen, device="cuda")

    def step():
        noise = torch.randn(1, 512, 512, 32, generator=gen,
                            device="cuda").permute(0, 3, 1, 2)
        dip.dip_iteration(net, down, opt, z, noise, lr, 0.05)

    return step


def profile_window(fn, iters, expect=None, tries=5):
    """torch.profiler over ``iters`` calls of fn, after one warm-up step
    under the profiler: the device operations, most device time first, and
    the device's busy ms per call. The profiler can lose records (a
    one-image SRGAN window once held 32 of its 36 kernel-A launches), so
    ``expect``, a {kernel name part: launches per call} map, makes the
    window complete: it is taken again until it records exactly those
    launches, at most ``tries`` times, and raises if it never does."""
    for attempt in range(1, tries + 1):
        kernels, busy = _profile_once(fn, iters)
        seen = {k: sum(e.count for e in kernels if k in e.key)
                for k in expect or {}}
        want = {k: n * iters for k, n in (expect or {}).items()}
        if seen == want:
            if attempt > 1:
                print(f"  (profiled window complete at attempt {attempt})")
            return kernels, busy
        print(f"  profiled window {attempt} incomplete: recorded {seen}, "
              f"launched {want}")
    raise AssertionError(f"no complete profiled window in {tries} tries")


def _profile_once(fn, iters):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    averages = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: averages.append(
                     p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    (events,) = averages
    # user annotations (the optimizer's record_function range) also sit on
    # the device timeline; counting them would count their kernels twice
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / iters / 1e3
    return kernels, busy


def print_top(kernels, iters, top, unit):
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / iters / 1e3:8.3f} ms/{unit} "
              f"{e.count // iters:5d} calls/{unit}  {e.key[:90]}")


def profile_iteration(dtype, fusion, iters=3, top=12):
    """Phase 3c: time per iteration (CUDA events, profiler off), then a
    torch.profiler window: device kernel time per iteration, the device's
    idle share, and the kernels that take the most device time. With the
    kernels (fusion 'auto') the window must record all of their launches
    (DIP_ITER_LAUNCHES per iteration)."""
    step = dip_step(dtype, fusion)
    ms = time_ms(step, 30, warmup=5)
    fused = fusion == "auto"
    kernels, busy = profile_window(step, iters,
                                   expect=DIP_ITER_LAUNCHES if fused else None)
    ops = sum(e.count for e in kernels) // iters
    split = ""
    if fused:
        a, b = (sum(e.self_device_time_total for e in kernels if k in e.key)
                / iters / 1e3 for k in (KERNEL_A, KERNEL_B))
        split = (f"; kernel A {a:.3f} ms, kernel B {b:.3f} ms (all their "
                 f"launches recorded)")
    print(f"DIP iteration at 512^2 x8, full width, {dtype}, conv_fusion="
          f"{fusion}: {ms:.3f} ms per iteration (CUDA events); kernels "
          f"busy {busy:.3f} ms of it, idle share {1 - busy / ms:.3f}, "
          f"{ops} device operations per iteration{split}")
    print_top(kernels, iters, top, "iter")


def rrdb_operands(shape, dtype, gen):
    """x (N, H, W, 64) and the 5 canonical dense-block kernels and biases,
    U(+-1/sqrt(fan_in)) as RRDBNet initialises them."""
    from tpusr_torch.ops.dense_block import GC, NF

    def uni(*s, fan_in):
        return ((torch.rand(*s, generator=gen, device="cuda") * 2 - 1)
                / fan_in ** 0.5)

    x = torch.randn(*shape, NF, generator=gen, device="cuda").to(dtype)
    ks, bs = [], []
    for i in range(5):
        cin, cout = NF + GC * i, GC if i < 4 else NF
        ks.append(uni(3, 3, cin, cout, fan_in=9 * cin))
        bs.append(uni(cout, fan_in=9 * cin))
    return x, ks, bs


def check_rrdb_kernels():
    """Phase 2, RRDB: kernel C at the trunk's shape, at ragged ones and at
    N = 2; kernel A in the RRDB configuration (zero pad, no prologue,
    64 -> 64) at each shape the frame gives it: 270 x 480, 540 x 960 and
    1080 x 1920. Returns the largest f32 abs error of each."""
    from tpusr_torch.ops import dense_block as db
    from tpusr_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"dense_block": 0.0, "fused_conv3x3_fwd": 0.0}
    h, w = LR_RRDB
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32

            def plain(t):  # the plain side's operand: f32 ones in f64
                return t.double() if f32 else t

            for shape in ((1, h, w), (1, 7, 9), (1, 13, 70), (2, 16, 20),
                          *DENSE_EDGE_SHAPES):
                x, ks, bs = rrdb_operands(shape, dtype, gen)
                y = db.dense_block(x, ks, bs)
                yr = db.dense_block_reference(plain(x), [plain(k) for k in ks],
                                              [plain(b) for b in bs])
                torch.cuda.synchronize()
                err, part = rel_err(y, yr), part_err(y, yr, x)
                print(f"check dense_block {shape} {str(dtype)[6:]}: "
                      f"{err:.3e}, its own part {part:.3e}")
                if not (err <= TOL[dtype] and part <= TOL[dtype]):
                    raise AssertionError(f"kernel C disagrees with its plain "
                                         f"version at {shape} {dtype}: {err}, "
                                         f"its own part {part}")
                if f32:
                    worst["dense_block"] = max(worst["dense_block"],
                                               abs_err(y, yr))
            # trunk_conv, upconv1, upconv2 and conv_hr: 270 and 540 rows
            # leave a ragged last row of kernel A's 16 x 16 tiles
            for scale in (1, 2, 4):
                x = torch.randn(1, scale * h, scale * w, 64, generator=gen,
                                device="cuda").to(dtype)
                wt = ((torch.rand(3, 3, 64, 64, generator=gen, device="cuda")
                       * 2 - 1) / 24).to(dtype)  # U(+-1/sqrt(9 * 64))
                y, _ = fc.fused_conv3x3_fwd(x, wt, reflect=False)
                yr, _ = fc.fused_conv3x3_fwd_reference(plain(x), plain(wt),
                                                       reflect=False)
                torch.cuda.synchronize()
                err = rel_err(y, yr)
                print(f"check fused_conv3x3_fwd RRDB configuration "
                      f"{tuple(x.shape)} 64->64 zero pad {str(dtype)[6:]}: "
                      f"{err:.3e}")
                if not err <= TOL[dtype]:
                    raise AssertionError(f"kernel A disagrees with its plain "
                                         f"version at {tuple(x.shape)} "
                                         f"{dtype}: {err}")
                if f32:
                    worst["fused_conv3x3_fwd"] = max(
                        worst["fused_conv3x3_fwd"], abs_err(y, yr))
                del x, y, yr
    torch.backends.cudnn.allow_tf32 = True
    return worst


def rrdb_net(dtype, fusion):
    from tpusr_torch.models.rrdb import RRDBNet

    return RRDBNet(scale=4, dtype=dtype, fusion=fusion, device="cuda",
                   generator=torch.Generator().manual_seed(0))


def check_rrdb_net():
    """Phase 4a: the full-width RRDBNet, fused ('auto', f32) against the
    unfused dataflow ('off') run in f64 from the same weights, on a small
    LR input. The unfused f32 net's own distance is printed for scale."""
    torch.backends.cudnn.allow_tf32 = False
    nets = {"auto": rrdb_net(None, "auto"), "off": rrdb_net(None, "off"),
            "off_f64": rrdb_net(None, "off").double()}
    # 27 x 45, 54 x 90, 108 x 180: no side a multiple of kernel A's 16 x 16
    # tile or of kernel C's (16 x 16 in bf16, 8 x 8 in f32)
    lr = torch.rand(1, 3, 27, 45, generator=torch.Generator().manual_seed(1))
    outs = {}
    with torch.inference_mode():
        for name, net in nets.items():
            outs[name] = net(lr.to("cuda", next(net.parameters()).dtype))
    if outs["auto"].shape != (1, 3, 108, 180):
        raise AssertionError(f"RRDBNet output {tuple(outs['auto'].shape)}")
    err = {k: rel_err(outs[k], outs["off_f64"]) for k in ("auto", "off")}
    print(f"RRDBNet at 27x45 -> 108x180, full width (nf 64, nb 23, gc 32), "
          f"against the f64 unfused net: fused f32 {err['auto']:.3e}; "
          f"unfused f32 {err['off']:.3e}")
    if not err["auto"] <= 1e-4:
        raise AssertionError("fused RRDBNet disagrees with the unfused net")
    torch.backends.cudnn.allow_tf32 = True


def run_rrdb_main_path(dtype, top=12):
    """Phase 4b: bench.py's rrdb workload on the port. One frame with the
    launch counts around it, its checks, the frame time fused and unfused
    (CUDA events, 1 warm-up and 3 frames), and one profiled frame."""
    name = "float32" if dtype is None else str(dtype)[6:]
    lr = torch.from_numpy(np.random.default_rng(0).random(
        (1, *LR_RRDB, 3))).float().permute(0, 3, 1, 2).cuda()
    mpix = 16 * LR_RRDB[0] * LR_RRDB[1] / 1e6
    net = rrdb_net(dtype, "auto")
    with torch.inference_mode():
        reset_counts()
        y = net(lr)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"RRDB main path {name}: output {tuple(y.shape)} {y.dtype}, "
              f"launches {counts}")
        if not (y.shape == (1, 3, 1080, 1920) and y.dtype == torch.float32
                and bool(torch.isfinite(y).all())):
            raise AssertionError("RRDB output is not a finite f32 "
                                 "(1, 3, 1080, 1920) frame")
        if not (counts["dense_block"] == 69
                and counts["fused_conv3x3_fwd"] == 4
                and counts["fused_conv3x3_wgrad"] == 0):
            raise AssertionError(f"RRDB main path missed the kernels: "
                                 f"{counts}")
        del y
        ms = time_ms(lambda: net(lr), 3, warmup=1)
        kernels, busy = profile_window(
            lambda: net(lr), 1,
            expect={KERNEL_C: 69, KERNEL_A: 4})
        off = rrdb_net(dtype, "off")
        ms_off = time_ms(lambda: off(lr), 3, warmup=1)
        del off
    groups = {"kernel C": KERNEL_C, "kernel A": KERNEL_A}
    split = {g: sum(e.self_device_time_total for e in kernels
                    if key in e.key) / 1e3 for g, key in groups.items()}
    split["other device ops"] = busy - sum(split.values())
    print(f"RRDB x4 frame 270x480 -> 1080x1920, full width, {name}: fusion "
          f"auto {ms:.3f} ms ({mpix / ms * 1e3:.3f} MPix/s), off (cuDNN) "
          f"{ms_off:.3f} ms ({mpix / ms_off * 1e3:.3f} MPix/s); profiled "
          f"frame: busy {busy:.3f} ms, idle share {1 - busy / ms:.4f}, "
          f"{sum(e.count for e in kernels)} device operations; " + ", ".join(
              f"{g} {v:.3f} ms" for g, v in split.items()))
    print_top(kernels, 1, top, "frame")
    return counts


def time_ms(fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def bound(flops, nbytes, dtype):
    """(ms, 'operations' or 'bytes', named op bounds in ms): the larger of
    the operations over their peak and the bytes over the memory rate. f32
    work has two peaks, the FMA units and 3xTF32 on the tensor cores (three
    TF32 products per f32 product, 1e-6 accurate); the least time takes the
    faster, and both are named."""
    named = {}
    t_ops = flops / RATE[dtype]
    if dtype == torch.float32:
        named = {"bound_fma_ms": t_ops * 1e3,
                 "bound_3xtf32_ms": 3 * flops / RATE["tf32"] * 1e3}
        t_ops = min(t_ops, 3 * flops / RATE["tf32"])
    t_bytes = nbytes / MEM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), named


def measure(label, kern, plain, lib, flops, nbytes, dtype):
    """Kernel, plain version and library times beside the bound; ``lib``
    may be None. The kernel and the library call: device time per call,
    20 calls queued behind a sleep kernel (device_ms, after 3 warm-up
    ones), so that a call shorter than its Python launch path is timed by
    the card and not by the host; beside it the kernel's time per call
    from Python. The plain version, dozens of launches a call that would
    fill the launch queue behind the sleep: CUDA events over 20 calls."""
    ms, plain_ms = device_ms(kern, 20), time_ms(plain)
    lib_ms = None if lib is None else device_ms(lib, 20)
    call_ms = time_ms(kern)
    bms, by, named = bound(flops, nbytes, dtype)
    lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    named_txt = "".join(f", {k[6:-3]} {v:.4f} ms" for k, v in named.items())
    print(f"time {label}: kernel {ms:.4f} ms ({call_ms:.4f} ms per call from "
          f"Python), plain {plain_ms:.4f} ms, library {lib_txt}, bound "
          f"{bms:.4f} ms ({by}{named_txt}), {flops / ms / 1e9:.1f} TFLOP/s")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, **named)


# ------------------------------------------------------------------ SwinIR
# SwinIR-M's window attention on the benchmark's frame: qkv (1, 272 * 480,
# 540), 270 rows reflect-padded to whole 8 x 8 windows, 6 heads of 30
WA_SHAPE = (1, 272, 480, 6, 30)  # B, Hp, Wp, heads, head dimension
# the window kernel's profiler names: window_attention_kernel<bf16 / float>
KERNEL_WA = "namespace)::window_attention_kernel"
# the token GEMM's profiler names: token_gemm_kernel<k-steps, chunks, epilogue>
KERNEL_TG = "namespace)::token_gemm_kernel"
# launches of one SwinIR-M x4 frame: the window kernel once a Swin layer
# (6 RSTBs x 6), kernel A for the tail's three 64 -> 64 convs (the convs at
# 180 channels, conv_first and conv_last run on cuDNN), and in bf16 the
# token GEMM four times a layer (qkv, proj, fc1, fc2; f32 keeps F.linear)
SWINIR_FRAME = {"window_attention": 36, "fused_conv3x3_fwd": 3}
SWINIR_FRAME_BF16 = {**SWINIR_FRAME, "token_gemm": 144}
# the token GEMM at the cell's frame: (K, N, epilogue) of qkv, proj, fc1, fc2
TG_TOKENS = 272 * 480
TG_PRODUCTS = [("qkv", 180, 540, "bias"), ("proj", 180, 180, "residual"),
               ("fc1", 180, 360, "gelu"), ("fc2", 360, 180, "residual")]
TG_TOL = {"rel": 1e-2, "rms": 5e-3}


def wa_operands(dtype, gen):
    """qkv (B, Hp * Wp, 3 heads hd) in dtype and the f32 (225, heads) bias
    table, N(0, 1) as the benchmark draws its tables, so that a bias left
    out moves the output."""
    b, h, w, heads, hd = WA_SHAPE
    qkv = torch.randn((b, h * w, 3 * heads * hd), generator=gen,
                      device="cuda").to(dtype)
    table = torch.randn((15 * 15, heads), generator=gen, device="cuda")
    return qkv, table


def wa_own_part(got, want, hw):
    """The window kernel's own part: the largest rms of got - want over the
    image's 8 x 8 windows, over the rms of want (a fault in a few windows,
    as the mask's, is a small share of the whole image)."""
    d = got.double() - want.double()
    b, _, c = d.shape
    per_px = d.square().mean(-1).view(b, 1, *hw)
    worst = F.avg_pool2d(per_px, 8).sqrt().max()
    return float(worst / want.double().square().mean().sqrt())


def check_window_attention():
    """Phase 2, the window kernel (ops/window_attention.py): at WA_SHAPE
    in f32 and bf16, unshifted and shifted by 4, against the plain chain
    in f64 on the same values (bf16 values are exact in f64): max |kernel
    - plain| / max |plain| and the own part (``wa_own_part``) under TOL
    (f32: 3xTF32 products; bf16: P enters the second product and the
    output is stored rounded to bf16), one launch a call, read from 0.
    Then a planted fault, head 1's bias zeroed in the kernel's table and
    held to the sound chain, must read above TOL in the own part: the
    benchmark's cell does not see one layer's bias left out, so this
    check and the card tests guard the bias addressing. Returns the
    largest f32 absolute error."""
    from tpusr_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(11)
    hw, heads = WA_SHAPE[1:3], WA_SHAPE[3]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shift in (0, 4):
            qkv, table = wa_operands(dtype, gen)
            want = wa.window_attention_reference(qkv.double(),
                                                 table.double(), hw, heads,
                                                 shift)
            wa.reset_launch_counts()
            got = wa.window_attention(qkv, table, hw, heads, shift)
            launches = wa.LAUNCHES["window_attention"]
            rel, own = rel_err(got, want), wa_own_part(got, want, hw)
            if dtype == torch.float32:
                worst = max(worst, abs_err(got, want))
            zeroed = table.clone()
            zeroed[:, 1] = 0.0
            fault = wa_own_part(wa.window_attention(qkv, zeroed, hw, heads,
                                                    shift), want, hw)
            print(f"check window_attention {WA_SHAPE} {str(dtype)[6:]} shift "
                  f"{shift}: rel {rel:.3e}, own part {own:.3e}, "
                  f"{launches} launch; head 1's bias zeroed: own part "
                  f"{fault:.3e}")
            if not (rel < TOL[dtype] and own < TOL[dtype]):
                raise AssertionError(f"window_attention {dtype} shift "
                                     f"{shift} disagrees with the plain "
                                     f"chain: rel {rel}, own {own}")
            if launches != 1:
                raise AssertionError(f"window_attention launched {launches} "
                                     f"times in one call")
            if not fault > TOL[dtype]:
                raise AssertionError(f"window_attention {dtype} shift "
                                     f"{shift}: head 1's bias zeroed reads "
                                     f"{fault}, under {TOL[dtype]}")
    return worst


def swinir_net(dtype, fusion):
    """SwinIR-M x4 from seed 0 on the card, through the engine's
    constructor."""
    from tpusr_torch.engine.gan import GANTrainConfig, build_generator

    config = GANTrainConfig(generator="swinir", factor=4,
                            dtype=None if dtype is None else str(dtype)[6:],
                            conv_fusion=fusion)
    return build_generator(config, "cuda",
                           torch.Generator().manual_seed(0)), config


def check_swinir_net():
    """Phase 4c: the full-width SwinIR-M, fused ('auto', f32: the window
    kernel's 3xTF32 path, kernel A in the tail) against the unfused
    dataflow ('off': the plain attention chain, every conv on F.conv2d) in
    f64 from the same weights, TF32 off, on a small LR input whose 20 rows
    and 28 columns are no whole windows (reflect pad, a ragged last window
    row, shifted masks). The unfused f32 net's distance is printed for
    scale."""
    torch.backends.cudnn.allow_tf32 = False
    fused, _ = swinir_net(None, "auto")
    off, _ = swinir_net(None, "off")
    off.load_state_dict(fused.state_dict())
    off64, _ = swinir_net(None, "off")
    off64.load_state_dict(fused.state_dict())
    off64 = off64.double()
    lr = torch.rand(1, 3, 20, 28,
                    generator=torch.Generator().manual_seed(1)).cuda()
    with torch.inference_mode():
        outs = {"auto": fused(lr), "off": off(lr),
                "off_f64": off64(lr.double())}
    if outs["auto"].shape != (1, 3, 80, 112):
        raise AssertionError(f"SwinIR output {tuple(outs['auto'].shape)}")
    err = {k: rel_err(outs[k], outs["off_f64"]) for k in ("auto", "off")}
    print(f"SwinIR-M at 20x28 -> 80x112, against the f64 unfused net: "
          f"fused f32 {err['auto']:.3e}; unfused f32 {err['off']:.3e}")
    torch.backends.cudnn.allow_tf32 = True
    if not err["auto"] <= 1e-4:
        raise AssertionError("fused SwinIR disagrees with the unfused net")


def run_swinir_main_path(dtype, top=12):
    """Phase 4d: the benchmark's swinir-x4-1080p-bf16 entry on the port,
    ``generator_forward(train=False)`` with ``GANTrainConfig(generator=
    'swinir', factor=4)`` on a 270 x 480 LR frame (1080 x 1920 out): one
    frame with the launch counts read from 0 around it (SWINIR_FRAME; in
    bf16 SWINIR_FRAME_BF16, the token GEMM's 144 with them), its checks,
    the frame time fused and unfused (CUDA events, 1 warm-up and 3
    frames), and one profiled frame, whose window must record all of its
    window-kernel, kernel-A and token-GEMM launches."""
    from tpusr_torch.engine.gan import generator_forward

    name = "float32" if dtype is None else str(dtype)[6:]
    lr = torch.from_numpy(np.random.default_rng(0).random(
        (1, *LR_RRDB, 3))).float().cuda()
    mpix = 16 * LR_RRDB[0] * LR_RRDB[1] / 1e6
    net, config = swinir_net(dtype, "auto")
    net.eval()
    want = SWINIR_FRAME if dtype is None else SWINIR_FRAME_BF16
    with torch.inference_mode():
        reset_counts()
        y = generator_forward(net, lr, config)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"SwinIR main path {name}: output {tuple(y.shape)} {y.dtype}, "
              f"launches {counts}")
        if not (y.shape == (1, 1080, 1920, 3) and y.dtype == torch.float32
                and bool(torch.isfinite(y).all())):
            raise AssertionError("SwinIR output is not a finite f32 "
                                 "(1, 1080, 1920, 3) frame")
        if any(counts[k] != n for k, n in want.items()) or any(
                v for k, v in counts.items() if k not in want):
            raise AssertionError(f"SwinIR main path missed the kernels: "
                                 f"{counts}")
        del y

        def frame(m):
            return generator_forward(m, lr, config)

        ms = time_ms(lambda: frame(net), 3, warmup=1)
        kernels, busy = profile_window(
            lambda: frame(net), 1,
            expect={KERNEL_WA: 36, KERNEL_A: 3,
                    **({} if dtype is None else {KERNEL_TG: 144})})
        off, _ = swinir_net(dtype, "off")
        off.load_state_dict(net.state_dict())
        ms_off = time_ms(lambda: frame(off.eval()), 3, warmup=1)
        del off
    groups = {"window kernel": KERNEL_WA, "kernel A": KERNEL_A,
              "token GEMM": KERNEL_TG}
    split = {g: sum(e.self_device_time_total for e in kernels
                    if key in e.key) / 1e3 for g, key in groups.items()}
    split["other device ops"] = busy - sum(split.values())
    print(f"SwinIR-M x4 frame 270x480 -> 1080x1920, {name}: fusion auto "
          f"{ms:.3f} ms ({mpix / ms * 1e3:.3f} MPix/s), off (plain "
          f"attention, cuDNN) {ms_off:.3f} ms ({mpix / ms_off * 1e3:.3f} "
          f"MPix/s); profiled frame: busy {busy:.3f} ms, idle share "
          f"{1 - busy / ms:.4f}, {sum(e.count for e in kernels)} device "
          f"operations; " + ", ".join(f"{g} {v:.3f} ms"
                                      for g, v in split.items()))
    print_top(kernels, 1, top, "frame")
    return counts


def time_window_attention():
    """Phase 7, the window kernel at WA_SHAPE, f32 and bf16, unshifted and
    shifted: its device time beside its bound (qkv read once, the output
    written once, the table once, at 3.35 TB/s; the useful operations of
    q k^T and P v at head dimension 30), the plain chain's time (CUDA
    events) and, as a yardstick the port never calls,
    F.scaled_dot_product_attention on windows already cut (the roll and
    partition not timed), with the bias and mask as its additive mask.
    The record keeps the unshifted rows; the shifted ones are printed."""
    from tpusr_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(12)
    b, h, w, heads, hd = WA_SHAPE
    hw, nt = (h, w), wa.WINDOW * wa.WINDOW
    windows = b * h * w // nt
    flops = 2 * 2 * windows * heads * nt * nt * hd
    index = wa.relative_position_index(wa.WINDOW, "cuda").view(-1)
    rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            qkv, table = wa_operands(dtype, gen)
            nbytes = qkv.numel() * 4 // 3 * qkv.element_size() \
                + table.numel() * 4
            for shift in (0, 4):
                x = qkv.view(b, h, w, -1)
                if shift:
                    x = torch.roll(x, (-shift, -shift), (1, 2))
                q, k, v = wa.window_partition(x, wa.WINDOW).reshape(
                    -1, nt, 3, heads, hd).permute(2, 0, 3, 1, 4).contiguous()
                bias = table[index].view(nt, nt, heads).permute(2, 0, 1)
                mask = bias[None].expand(windows, -1, -1, -1)
                if shift:
                    mask = mask + wa.shifted_window_mask(
                        hw, wa.WINDOW, shift, "cuda")[:, None]
                mask = mask.to(dtype).contiguous()
                row = measure(
                    f"window_attention at {WA_SHAPE} {str(dtype)[6:]} shift "
                    f"{shift}",
                    lambda: wa.window_attention(qkv, table, hw, heads, shift),
                    lambda: wa.window_attention_reference(qkv, table, hw,
                                                          heads, shift),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=hd ** -0.5),
                    flops, nbytes, dtype)
                if not shift:
                    row["shape"] = (f"qkv (1, 272 * 480, 540), 6 heads of 30, "
                                    f"unshifted, {str(dtype)[6:]}")
                    rows[str(dtype)[6:]] = row
                del q, k, v, mask
    return rows


def tg_operands(k, n, epi, gen, tokens=TG_TOKENS):
    """x N(0, 1) tokens, an nn.Linear's U(+-1/sqrt(K)) weight, bias and
    residual N(0, 1) (so that leaving either out moves the output), bf16."""
    x = torch.randn((tokens, k), generator=gen, device="cuda").bfloat16()
    w = ((torch.rand((n, k), generator=gen, device="cuda") * 2 - 1)
         / k ** 0.5).bfloat16()
    b = torch.randn(n, generator=gen, device="cuda").bfloat16()
    res = (torch.randn((tokens, n), generator=gen, device="cuda").bfloat16()
           if epi == "residual" else None)
    return x, w, b, res


def tg_measures(got, want):
    """(max |got - want| / max |want|, rms(got - want) / rms(want))."""
    d = got.double() - want
    return (float(d.abs().max() / want.abs().max()),
            float(d.square().mean().sqrt() / want.square().mean().sqrt()))


def check_token_gemm():
    """Phase 2, the token GEMM (ops/token_gemm.py) at the four products of
    a SwinIR-M layer on the cell's frame (TG_PRODUCTS, 130,560 tokens),
    and at an odd 1,919 tokens (the last tile ends 8 bytes past a 16-byte
    boundary), against the plain chain in f64 on the same values: both
    measures under TG_TOL (one rounding to bf16, 2^-9 at most), one launch
    a call. Then K's tail dropped (the k-step that runs past K: columns
    176-179 at K = 180, 352-359 at 360), held to the sound kernel, must
    read above TG_TOL. Returns the largest max-relative error."""
    from tpusr_torch.ops import token_gemm as tg

    gen = torch.Generator(device="cuda").manual_seed(14)
    worst = 0.0
    with torch.inference_mode():
        for name, k, n, epi in TG_PRODUCTS:
            for tokens in (TG_TOKENS, 1919):
                x, w, b, res = tg_operands(k, n, epi, gen, tokens)
                tg.reset_launch_counts()
                got = tg.token_linear(x, w, b, res, epi == "gelu",
                                      tg.pack(w, epi))
                torch.cuda.synchronize()
                launches = tg.LAUNCHES["token_gemm"]

                def plain(x):
                    return tg.token_linear_reference(
                        x.double(), w.double(), b.double(),
                        None if res is None else res.double(),
                        epi == "gelu")

                rel, rms = tg_measures(got, plain(x))
                worst = max(worst, rel)
                cut = x.clone()
                cut[:, k - k % 16:] = 0
                fault = tg_measures(got, plain(cut))
                print(f"check token_gemm {name} ({tokens}, {k}) -> {n} "
                      f"{epi}: rel {rel:.3e}, rms {rms:.3e}, {launches} "
                      f"launch; K's tail dropped: rel {fault[0]:.3e}, rms "
                      f"{fault[1]:.3e}")
                if not (rel < TG_TOL["rel"] and rms < TG_TOL["rms"]):
                    raise AssertionError(f"token_gemm {name} disagrees with "
                                         f"the plain chain: {rel}, {rms}")
                if launches != 1:
                    raise AssertionError(f"token_gemm launched {launches} "
                                         f"times in one call")
                if not (fault[0] > TG_TOL["rel"] and fault[1] > TG_TOL["rms"]):
                    raise AssertionError(f"token_gemm {name}: K's tail "
                                         f"dropped reads {fault}")
    return worst


def time_token_gemm():
    """Phase 7, the token GEMM at the four products of the cell's frame
    (weights packed beforehand, as the model packs them once a frame): its
    device time beside its bound (x, the residual and the output moved
    once, the weights and bias once, at 3.35 TB/s; the products' 2 M N K at
    989 TFLOP/s), the plain chain's time (CUDA events) and, as the library
    yardstick, the same chain as one call a step: F.linear (cuBLAS) then
    ATen's GELU or residual add, device time behind a sleep."""
    from tpusr_torch.ops import token_gemm as tg

    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = {}
    with torch.inference_mode():
        for name, k, n, epi in TG_PRODUCTS:
            x, w, b, res = tg_operands(k, n, epi, gen)
            packed = tg.pack(w, epi)
            gelu = epi == "gelu"
            nbytes = (x.numel() + TG_TOKENS * n * (2 if res is not None
                                                   else 1)
                      + w.numel() + n) * 2

            def chain():
                return tg.token_linear_reference(x, w, b, res, gelu)

            row = measure(
                f"token_gemm {name} ({TG_TOKENS}, {k}) -> {n} {epi}, "
                f"bfloat16",
                lambda: tg.token_linear(x, w, b, res, gelu, packed=packed),
                chain, chain, 2 * TG_TOKENS * n * k, nbytes, torch.bfloat16)
            row["shape"] = f"({TG_TOKENS}, {k}) -> {n} + {epi}, bfloat16"
            rows[name] = row
    return rows


def time_swinir_kernel_a():
    """Phase 7, SwinIR: kernel A at the 180-channel convs of the 272 x 480
    frame (180 -> 180, 180 -> 64, zero pad, bf16) against one cuDNN conv
    with its bias, the call the model makes there: why SwinIR's convs at
    180 channels stay on cuDNN. Printed, not kept in the record."""
    from tpusr_torch.ops import fused_conv as fc

    gen = torch.Generator(device="cuda").manual_seed(13)
    h, w = WA_SHAPE[1:3]
    with torch.inference_mode():
        for cout in (180, 64):
            x = torch.randn(1, h, w, 180, generator=gen,
                            device="cuda").to(torch.bfloat16)
            wt = (torch.randn(3, 3, 180, cout, generator=gen,
                              device="cuda") / 40).to(torch.bfloat16)
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            bias = torch.zeros(cout, device="cuda", dtype=torch.bfloat16)
            measure(f"fused_conv3x3_fwd at SwinIR's (1, {h}, {w}, 180) -> "
                    f"{cout}, zero pad, bfloat16 (library: cuDNN with bias)",
                    lambda: fc.fused_conv3x3_fwd(x, wt, reflect=False),
                    lambda: fc.fused_conv3x3_fwd_reference(x, wt,
                                                           reflect=False),
                    lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias,
                                     padding=1),
                    2 * 9 * 180 * cout * h * w,
                    (x.numel() + h * w * cout + wt.numel())
                    * x.element_size(), torch.bfloat16)


# ------------------------------------------------------------------ SRGAN
SRGAN_A_SHAPES = [  # (x shape, Cout) of every kernel-A call of the x8 eval
    ((1, *LR_GAN, 64), 64), ((1, *LR_GAN, 64), 256),
    ((1, 2 * LR_GAN[0], 2 * LR_GAN[1], 64), 256),
    ((1, 4 * LR_GAN[0], 4 * LR_GAN[1], 64), 256),
    ((1, *LR_RAGGED, 64), 64), ((1, *LR_RAGGED, 64), 256),
    ((1, 2 * LR_RAGGED[0], 2 * LR_RAGGED[1], 64), 256),
    ((1, 4 * LR_RAGGED[0], 4 * LR_RAGGED[1], 64), 256),
    # the same image with its x8 LR rounded up (255 x 170), halved
    ((1, LR_RAGGED[0] + 1, LR_RAGGED[1], 64), 64)]


def check_srgan_kernels(shapes=SRGAN_A_SHAPES, label="SRGAN"):
    """Phase 2, SRGAN: kernel A in the generator's configuration (zero pad,
    no prologue) at every shape the x8 eval gives it (or ``shapes``: one
    slab's window of the 2-shard eval). Returns the largest f32 abs
    error."""
    from tpusr_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            for shape, cout in shapes:
                x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                wt = ((torch.rand(3, 3, 64, cout, generator=gen,
                                  device="cuda") * 2 - 1) / 24).to(dtype)
                y, _ = fc.fused_conv3x3_fwd(x, wt, reflect=False)
                yr, _ = fc.fused_conv3x3_fwd_reference(
                    x.double() if f32 else x, wt.double() if f32 else wt,
                    reflect=False)
                torch.cuda.synchronize()
                err = rel_err(y, yr)
                print(f"check fused_conv3x3_fwd {label} configuration {shape} "
                      f"64->{cout} zero pad {str(dtype)[6:]}: {err:.3e}")
                if not err <= TOL[dtype]:
                    raise AssertionError(f"kernel A disagrees with its plain "
                                         f"version at {shape} -> {cout} "
                                         f"{dtype}: {err}")
                if f32:
                    worst = max(worst, abs_err(y, yr))
                del x, y, yr
    torch.backends.cudnn.allow_tf32 = True
    return worst


def srgan_generator(dtype, blocks=16, device="cuda"):
    """The full-width x8 Generator, weights from seed 0 and running
    statistics from seed 1 (mean U(-0.2, 0.2), var U(0.5, 1.5))."""
    from tpusr_torch.models.srgan import Generator

    g = Generator(factor=8, residual_blocks_count=blocks, dtype=dtype,
                  device=device, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in g.named_buffers():
            lo, hi = ((-0.2, 0.2) if name.endswith("running_mean")
                      else (0.5, 1.5))
            buf.copy_(torch.empty(buf.shape).uniform_(lo, hi, generator=gen))
    return g


def check_generator_net():
    """Phase 5a: the full-width x8 Generator through generator_forward on a
    24 x 40 LR input, against the unfused net (g_fuse 'off') run in f64
    from the same weights: fused (g_fuse 'eval', f32) with cuDNN's TF32
    off, to 1e-4 (kernel A's own accuracy); then as the eval CLI runs it,
    with PyTorch's default TF32 for the two 9x9 cuDNN convs, to TF32_TOL.
    The unfused f32 net's distance is printed beside each for scale."""
    from tpusr_torch.engine.gan import GANTrainConfig, generator_forward

    fused, off = GANTrainConfig(), GANTrainConfig(g_fuse="off")
    nets = {"auto": (srgan_generator(None), fused),
            "off": (srgan_generator(None), off),
            "off_f64": (srgan_generator(None).double(), off)}
    lr = torch.rand(1, 24, 40, 3, generator=torch.Generator().manual_seed(2))
    for tf32, tol in ((False, 1e-4), (True, TF32_TOL)):
        torch.backends.cudnn.allow_tf32 = tf32  # ends at PyTorch's default
        outs = {}
        with torch.inference_mode():
            for name, (net, cfg) in nets.items():
                outs[name] = generator_forward(
                    net, lr.to("cuda", next(net.parameters()).dtype), cfg)
        if outs["auto"].shape != (1, 192, 320, 3):
            raise AssertionError(f"Generator output "
                                 f"{tuple(outs['auto'].shape)}")
        err = {k: rel_err(outs[k], outs["off_f64"]) for k in ("auto", "off")}
        mode = "on, as the eval CLI runs" if tf32 else "off"
        print(f"SRGAN Generator x8 at 24x40 -> 192x320, full width (16 "
              f"blocks), cuDNN TF32 {mode}, against the f64 unfused net: "
              f"fused f32 {err['auto']:.3e} "
              f"(tolerance {tol:g}); unfused f32 {err['off']:.3e}; output "
              f"max |y| {float(outs['off_f64'].abs().max()):.4f}")
        if not err["auto"] <= tol:
            raise AssertionError("fused Generator disagrees with the f64 net")


def write_valid_tree(root):
    """A synthetic DIV2K valid tree: 0801, a 2048^2 HR with its 256^2 x8
    LR (the loader's /2 gives a 128^2 LR and a 1024^2 HR target), and 0802,
    a 2040 x 1356 HR with its 255 x 169 LR (an 84 x 127 LR, 672 x 1016
    target). Returns the reference-named .pth of seeded weights that the
    port's export writes."""
    from PIL import Image
    from tpusr_torch.io.checkpoint import (export_torch_generator,
                                           save_torch_pth)

    hr_dir = os.path.join(root, "DIV2K_valid_HR")
    lr_dir = os.path.join(root, "DIV2K_valid_LR_x8")
    os.makedirs(hr_dir)
    os.makedirs(lr_dir)
    rng = np.random.default_rng(0)
    for name, (w, h), lr_size in (("0801", (2048, 2048), (256, 256)),
                                  ("0802", (2040, 1356), (255, 169))):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([np.sin(xx / 37.0) * np.cos(yy / 23.0),
                        np.sin((xx + yy) / 51.0),
                        np.cos(xx / 17.0 - yy / 29.0)], -1) * 90 + 128
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
            np.uint8)
        hr = Image.fromarray(img)
        hr.save(os.path.join(hr_dir, f"{name}.png"))
        hr.resize(lr_size, Image.BICUBIC).save(
            os.path.join(lr_dir, f"{name}x8.png"))
    pth = os.path.join(root, "G.pth")
    save_torch_pth(export_torch_generator(
        srgan_generator(None).state_dict(), 16, 3), pth)
    return pth


def run_eval_main_path(root, pth, dtype):
    """Phase 5b: the eval CLI on the card, with the launch counts around
    it: 36 kernel-A launches per image, none of B-E."""
    from PIL import Image
    from tpusr_torch.cli import eval_gan

    out = os.path.join(root, f"out_{dtype}")
    os.makedirs(out)
    reset_counts()
    t0 = time.perf_counter()
    metrics = eval_gan.run(["--data_dir", root, "--out_dir", out,
                            "--model_path", pth, "--save_images", "True",
                            "--dtype", dtype, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    (stamp,) = os.listdir(os.path.join(out, "out", "GANx8"))
    img_dir = os.path.join(out, "out", "GANx8", stamp, "images")
    sizes = {f: Image.open(os.path.join(img_dir, f)).size
             for f in sorted(os.listdir(img_dir))}
    n = metrics["Number of images evaluated over"]
    print(f"eval main path {dtype}: {n} images in {wall:.3f} s (CLI wall "
          f"time: PNG decode, PIL "
          f"resizes, model load, metrics and PNG writes included); avg_psnr "
          f"{metrics['avg_psnr']:.4f} avg_ssim {metrics['avg_ssim']:.4f} "
          f"avg_lpips {metrics['avg_lpips']}; PNGs {sizes}; launches {counts}")
    if not (np.isfinite(metrics["avg_psnr"])
            and np.isfinite(metrics["avg_ssim"])
            and n == 2):
        raise AssertionError(f"eval metrics not finite: {metrics}")
    if sizes != {"0801.png": (1024, 1024), "0802.png": (1016, 672)}:
        raise AssertionError(f"eval wrote {sizes}")
    if counts != {**{k: 0 for k in counts}, "fused_conv3x3_fwd": 72}:
        raise AssertionError(f"eval main path missed kernel A or launched "
                             f"another kernel: {counts}")
    return counts


def time_generator(dtype, iters=3, top=12):
    """Phase 5c: generator_forward at 128^2 -> 1024^2 (bench.py's gan_eval
    workload), CUDA events over 10 images after 2, fused and through cuDNN
    (g_fuse 'off', for scale only), both with cuDNN's f32 convs in TF32,
    PyTorch's default, and in f32 the fused path once more with TF32 off
    (IEEE f32 throughout); then a profiled window of three images split
    into kernel A, the cuDNN convs and the PyTorch glue, per image."""
    import dataclasses
    from tpusr_torch.engine.gan import GANTrainConfig, generator_forward

    name = "float32" if dtype is None else str(dtype)[6:]
    net = srgan_generator(dtype)
    lr = torch.rand(1, *LR_GAN, 3, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    cfg = GANTrainConfig(dtype=None if dtype is None else name)
    off = dataclasses.replace(cfg, g_fuse="off")
    mpix = 64 * LR_GAN[0] * LR_GAN[1] / 1e6
    with torch.inference_mode():
        ms = time_ms(lambda: generator_forward(net, lr, cfg), 10, warmup=2)
        ms_off = time_ms(lambda: generator_forward(net, lr, off), 10,
                         warmup=2)
        ieee = ""
        if dtype is None:
            torch.backends.cudnn.allow_tf32 = False
            ms_ieee = time_ms(lambda: generator_forward(net, lr, cfg), 10,
                              warmup=2)
            torch.backends.cudnn.allow_tf32 = True
            ieee = (f", g_fuse eval with TF32 off {ms_ieee:.3f} ms "
                    f"({mpix / ms_ieee * 1e3:.3f} MPix/s)")
        kernels, busy = profile_window(
            lambda: generator_forward(net, lr, cfg), iters,
            expect={KERNEL_A: 36})
    split = {"kernel A": sum(e.self_device_time_total for e in kernels
                             if KERNEL_A in e.key) / iters / 1e3,
             "glue (PyTorch elementwise, copies)": sum(
                 e.self_device_time_total for e in kernels
                 if "at::native" in e.key or "Memcpy" in e.key
                 or "Memset" in e.key) / iters / 1e3}
    split["cuDNN 9x9 convs (the rest)"] = busy - sum(split.values())
    print(f"SRGAN x8 eval 128^2 -> 1024^2, full width, {name}: g_fuse eval "
          f"{ms:.3f} ms ({mpix / ms * 1e3:.3f} MPix/s), off (cuDNN) "
          f"{ms_off:.3f} ms ({mpix / ms_off * 1e3:.3f} MPix/s){ieee}; "
          f"profiled, "
          f"per image: busy {busy:.3f} ms, idle share {1 - busy / ms:.4f}, "
          f"kernel A's share of busy {split['kernel A'] / busy:.4f} "
          f"(all 36 of its launches recorded), "
          f"{sum(e.count for e in kernels) / iters:.1f} device operations; "
          + ", ".join(f"{g} {v:.3f} ms" for g, v in split.items()))
    print_top(kernels, iters, top, "image")
    return dict(ms=ms, ms_off=ms_off, busy=busy, **split)


# ------------------------------------------------------------ degradation
def check_gaussian(got, want, label):
    """Equal except at a fraction <= 1e-4 of elements, each off by 1."""
    diff = (got - want).abs()
    off = int((diff > 0).sum())
    if not (set(diff.unique().tolist()) <= {0.0, 1.0}
            and off <= 1e-4 * got.numel()):
        raise AssertionError(f"kernel D disagrees with its plain version at "
                             f"{label}: {off} elements differ, largest "
                             f"{float(diff.max())}")
    return off, float(diff.max())


def check_degrade_kernels():
    """Phase 2, degradation: kernels D and E against their plain versions
    (same seed, same image), then the statistics of tests/test_pallas.py
    on the HR frame. Returns the largest abs error of each."""
    from tpusr_torch.ops import fused_degrade as fd

    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {"fused_add_gaussian_noise": 0.0,
             "fused_add_salt_pepper_noise": 0.0}
    for shape in ((*DIV2K_HR, 3), (85, 128, 3), (7, 9, 3), (1, 1, 3)):
        img = torch.randint(0, 256, shape, generator=gen,
                            device="cuda").float()
        for seed in (0, 1, 2 ** 31 - 1):
            g = fd.fused_add_gaussian_noise(img, seed, std=0.1)
            gr = fd.fused_add_gaussian_noise_reference(img, seed, std=0.1)
            off, err = check_gaussian(g, gr, f"{shape} seed {seed}")
            worst["fused_add_gaussian_noise"] = max(
                worst["fused_add_gaussian_noise"], err)
            bad = 0
            for s, p in ((0.05, 0.05), (0.5, 0.3)):
                sp = fd.fused_add_salt_pepper_noise(img, seed, s=s, p=p)
                spr = fd.fused_add_salt_pepper_noise_reference(img, seed, s,
                                                               p)
                bad += int((sp != spr).sum())
            print(f"check degradation {shape} seed {seed}: Gaussian {off} of "
                  f"{g.numel()} elements differ by 1; salt and pepper "
                  f"{bad} differ")
            if bad:
                raise AssertionError(f"kernel E disagrees with its plain "
                                     f"version at {shape} seed {seed}")
    # tests/test_pallas.py's statistics, on the HR frame
    flat = torch.full((*DIV2K_HR, 3), 128.0, device="cuda")
    img_hr = torch.randint(0, 256, (*DIV2K_HR, 3), generator=gen,
                           device="cuda").float()
    g = fd.fused_add_gaussian_noise(flat, 7, std=0.1)
    gi = fd.fused_add_gaussian_noise(img_hr, 8, std=0.05)
    s = p = 0.05
    sp = fd.fused_add_salt_pepper_noise(flat, 5, s=s, p=p)
    salt, pepper = sp == 255, sp == 0
    stats = dict(
        mean=float(g.mean()), std=float(g.std()),
        salt=float(salt[..., 0].float().mean()),
        pepper=float(pepper[..., 0].float().mean()))
    print(f"degradation statistics on the {DIV2K_HR} HR frame: Gaussian "
          f"(flat 128, std 0.1) {stats['mean']:.4f} +- {stats['std']:.4f}; "
          f"salt rate {stats['salt']:.5f} (s (1 - p) = {s * (1 - p):.5f}), "
          f"pepper rate {stats['pepper']:.5f} (p = {p})")
    checks = {
        "in [0, 255] and integer": all(
            float(t.min()) >= 0 and float(t.max()) <= 255
            and bool(torch.equal(t, t.floor())) for t in (g, gi)),
        "mean within 3 of 128": abs(stats["mean"] - 128) < 3,
        "std in (20, 32)": 20 < stats["std"] < 32,
        "salt rate near s (1 - p)": abs(stats["salt"] - s * (1 - p)) < 2e-3,
        "pepper rate near p": abs(stats["pepper"] - p) < 2e-3,
        "masks shared across channels": bool(
            torch.equal(salt.all(-1), salt.any(-1))
            and torch.equal(pepper.all(-1), pepper.any(-1))),
        "untouched pixels unchanged": bool(
            torch.all(sp[~salt & ~pepper] == 128.0)),
        "noise moved the image": not torch.equal(gi, img_hr)}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"degradation statistics failed: {failed}")
    return worst


def run_degrade_path():
    """Phase 6: the two degradation functions on the DIV2K HR frame, with
    the launch counts around them."""
    from tpusr_torch.ops import fused_degrade as fd

    img = torch.randint(0, 256, (*DIV2K_HR, 3), generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda", dtype=torch.uint8)
    reset_counts()
    g = fd.fused_add_gaussian_noise(img, 11, std=0.05)
    sp = fd.fused_add_salt_pepper_noise(img, 12, s=0.01, p=0.01)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"degradation path on a {DIV2K_HR} uint8 frame: Gaussian mean "
          f"|change| {float((g - img.float()).abs().mean()):.4f}, salt and "
          f"pepper changed {float((sp != img.float()).float().mean()):.5f} "
          f"of elements; launches {counts}")
    if counts != {**{k: 0 for k in counts}, "fused_add_gaussian_noise": 1,
                  "fused_add_salt_pepper_noise": 1}:
        raise AssertionError(f"degradation path missed its kernels: "
                             f"{counts}")
    return counts


def device_ms(fn, n):
    """Device time per call of fn, for calls shorter than their Python
    launch path (kernels D and E take ~20 us): a sleep kernel holds the
    stream while the host enqueues n calls, so the events time the queued
    work back to back. The sleep is twice a dry run's enqueue time; raises
    if the host still took longer than the sleep."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dry_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(int(2 * dry_ms * 2e6) + 10_000_000)  # ~2e6 cycles/ms
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    b.record()
    torch.cuda.synchronize()
    if host_ms >= s0.elapsed_time(a):
        raise AssertionError(f"enqueueing {n} calls took {host_ms:.1f} ms, "
                             f"longer than the {s0.elapsed_time(a):.1f} ms "
                             f"sleep: the events would time the host")
    return a.elapsed_time(b) / n


def time_degrade_kernels():
    """Phase 7, degradation, at the DIV2K HR frame in f32: the device times
    of the kernel (sleep-held events), of its plain version and of the
    eager PyTorch chain that computes the same function with torch's own
    generator (no single PyTorch call does; both profiler busy time),
    beside the bound: bytes (read once, written once) or Philox's integer
    work, whichever is larger."""
    from tpusr_torch.ops import fused_degrade as fd

    gen = torch.Generator(device="cuda").manual_seed(10)
    img = torch.randint(0, 256, (*DIV2K_HR, 3), generator=gen,
                        device="cuda").float()
    n, hw = img.numel(), DIV2K_HR[0] * DIV2K_HR[1]
    std255, s, p = 0.05 * 255.0, 0.01, 0.01

    def gauss_chain():
        noise = torch.randn(img.shape, generator=gen, device="cuda")
        return torch.floor(torch.clamp(img + noise * std255, 0.0, 255.0))

    def sp_chain():
        us = torch.rand((*DIV2K_HR, 1), generator=gen, device="cuda")
        up = torch.rand((*DIV2K_HR, 1), generator=gen, device="cuda")
        return torch.where(up < p, 0.0, torch.where(us < s, 255.0, img))

    rows = {}
    for name, kern, plain, chain, calls in (
            ("fused_add_gaussian_noise",
             lambda: fd.fused_add_gaussian_noise(img, 1, 0.05),
             lambda: fd.fused_add_gaussian_noise_reference(img, 1, 0.05),
             gauss_chain, (n + 1) // 2),
            ("fused_add_salt_pepper_noise",
             lambda: fd.fused_add_salt_pepper_noise(img, 1, s, p),
             lambda: fd.fused_add_salt_pepper_noise_reference(img, 1, s, p),
             sp_chain, hw)):
        ms = device_ms(kern, 50)
        call_ms = time_ms(kern, 50)
        # the plain version and the chain launch many kernels each, whose
        # Python launch path outlasts them: their device busy time
        plain_ms = profile_window(plain, 5)[1]
        chain_ms = profile_window(chain, 5)[1]
        ops = PHILOX_OPS * calls
        bms, by, _ = bound(ops, 2 * 4 * n, torch.int32)
        print(f"time {name} at {DIV2K_HR + (3,)} f32 (device times): "
              f"kernel {ms:.4f} ms ({call_ms:.4f} ms per call from Python), "
              f"plain {plain_ms:.4f} ms, eager PyTorch chain "
              f"{chain_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}; bytes {2 * 4 * n / MEM_BW * 1e3:.4f}"
              f" ms, Philox {ops / RATE[torch.int32] * 1e3:.4f} ms), "
              f"{2 * 4 * n / ms / 1e6:.1f} GB/s")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                          library_chain_ms=chain_ms, call_ms=call_ms,
                          bound_ms=bms, bound_by=by,
                          shape=f"({DIV2K_HR[0]}, {DIV2K_HR[1]}, 3), f32")
    return rows


def time_srgan_kernel_a():
    """Phase 7, SRGAN: kernel A at (1, 128, 128, 64) -> 64 and (1, 512,
    512, 64) -> 256, zero pad, f32 and bf16, against one cuDNN conv
    without TF32."""
    from tpusr_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    with torch.inference_mode():
        for (shape, cout) in (((1, *LR_GAN, 64), 64),
                              ((1, 4 * LR_GAN[0], 4 * LR_GAN[1], 64), 256)):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                wt = (torch.randn(3, 3, 64, cout, generator=gen,
                                  device="cuda") / 24).to(dtype)
                w_oihw = wt.permute(3, 2, 0, 1).contiguous()
                _, h, w, _ = shape
                rows[(shape, cout, dtype)] = measure(
                    f"fused_conv3x3_fwd at {shape} -> {cout}, zero pad, "
                    f"{str(dtype)[6:]}",
                    lambda: fc.fused_conv3x3_fwd(x, wt, reflect=False),
                    lambda: fc.fused_conv3x3_fwd_reference(x, wt,
                                                           reflect=False),
                    lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw,
                                     padding=1),
                    2 * 9 * 64 * cout * h * w,
                    (x.numel() + h * w * cout + wt.numel())
                    * x.element_size(), dtype)
    torch.backends.cudnn.allow_tf32 = True
    return rows


def time_kernels(fc, name, size, act, has_base):
    """Phase 7 at one DIP shape, in f32 and bf16: kernels A and B, their
    plain versions and one cuDNN call each (F.conv2d, conv2d_weight; f32
    without TF32), beside the bound. Returns {kernel: {dtype: row}}."""
    torch.backends.cudnn.allow_tf32 = False
    flops = 2 * 9 * C * C * size * size
    rows = {"fused_conv3x3_fwd": {}, "fused_conv3x3_wgrad": {}}
    for dtype in (torch.float32, torch.bfloat16):
        o = operands(size, act, has_base, dtype,
                     torch.Generator(device="cuda").manual_seed(2))
        x, w, es, eb, base, g = (o[k] for k in ("x", "w", "es", "eb", "base",
                                                "g"))
        isz = x.element_size()
        act_bytes = size * size * C * isz
        xn = x.permute(0, 3, 1, 2)
        gn = g.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        ops = {
            "fused_conv3x3_fwd": (
                lambda: fc.fused_conv3x3_fwd(x, w, es, eb, base, act=act,
                                             reflect=True, stats=True),
                lambda: fc.fused_conv3x3_fwd_reference(
                    x, w, es, eb, base, act=act, reflect=True, stats=True),
                lambda: F.conv2d(xn, w_oihw, padding=1),
                # x, base read; y written; w, es/eb read; stats written
                act_bytes * (3 if has_base else 2) + w.numel() * isz
                + 2 * C * 4 + 2 * C * 4),
            "fused_conv3x3_wgrad": (
                lambda: fc.fused_conv3x3_wgrad(x, g, es, eb, act=act,
                                               reflect=True),
                lambda: fc.fused_conv3x3_wgrad_reference(
                    x, g, es, eb, act=act, reflect=True),
                lambda: torch.nn.grad.conv2d_weight(xn, w_oihw.shape, gn,
                                                    padding=1),
                # x, G, es/eb read; dw (f32) written
                act_bytes * 2 + 2 * C * 4 + w.numel() * 4),
        }
        for kname, (kern, plain, lib, nbytes) in ops.items():
            row = measure(f"{kname} at {name} ({size}^2, {C}->{C}, "
                          f"{str(dtype)[6:]})", kern, plain, lib, flops,
                          nbytes, dtype)
            row["shape"] = (f"{name}: (1, {size}, {size}, {C}) -> {C}, "
                            f"{str(dtype)[6:]}")
            rows[kname][dtype] = row
        del x, w, base, g, xn, gn, o
    torch.backends.cudnn.allow_tf32 = True
    return rows


def time_rrdb_kernels():
    """Phase 7, RRDB, in f32 and bf16: kernel C at (1, 270, 480, 64), with
    the five cuDNN convs of one block as its library time (no single
    PyTorch call computes a dense block) and its recompute factor; kernel
    A at 1080 x 1920, 64 -> 64, zero pad, against one cuDNN conv. Kernel
    C's weight units are packed once outside the timed calls, as
    RRDBNet.forward packs them once per frame for all its blocks."""
    from tpusr_torch.ops import dense_block as db
    from tpusr_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    h, w = LR_RRDB
    rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            with torch.inference_mode(False):
                x, ks, bs = rrdb_operands((1, h, w), dtype, gen)
            parts = [x.permute(0, 3, 1, 2)] + [
                torch.randn(1, h, w, db.GC, generator=gen, device="cuda")
                .to(dtype).permute(0, 3, 1, 2) for _ in range(4)]
            cats = [torch.cat(parts[:i + 1], 1) for i in range(5)]
            w_oihw = [k.to(dtype).permute(3, 2, 0, 1).contiguous()
                      for k in ks]
            b_lib = [b.to(dtype) for b in bs]
            flops = 2 * db.USEFUL_MACS * h * w
            # x read, y written, f32 kernels and biases read once
            nbytes = 2 * x.numel() * x.element_size() + 4 * sum(
                t.numel() for t in ks + bs)
            wp = db.packed_weights(ks, dtype)
            row = measure(
                f"dense_block at (1, {h}, {w}, 64), {name}",
                lambda: db.dense_block(x, ks, bs, wp),
                lambda: db.dense_block_reference(x, ks, bs), None,
                flops, nbytes, dtype)
            row["recompute_factor"] = db.recompute_factor(dtype)
            row["tile"] = "x".join(map(str, db.TILE[dtype]))
            row["library_five_convs_ms"] = time_ms(lambda: [
                F.conv2d(c, k, b, padding=1)
                for c, k, b in zip(cats, w_oihw, b_lib)])
            print(f"  five cuDNN convs of the block: "
                  f"{row['library_five_convs_ms']:.4f} ms; kernel C's "
                  f"{row['tile']} tile computes "
                  f"{row['recompute_factor']:.3f}x the useful work")
            rows[("dense_block", dtype)] = row
            del parts, cats

            xa = torch.randn(1, 4 * h, 4 * w, 64, generator=gen,
                             device="cuda").to(dtype)
            wa = (torch.randn(3, 3, 64, 64, generator=gen, device="cuda")
                  / 24).to(dtype)
            wa_oihw = wa.permute(3, 2, 0, 1).contiguous()
            rows[("fused_conv3x3_fwd", dtype)] = measure(
                f"fused_conv3x3_fwd at (1, {4 * h}, {4 * w}, 64) -> 64, "
                f"zero pad, {name}",
                lambda: fc.fused_conv3x3_fwd(xa, wa, reflect=False),
                lambda: fc.fused_conv3x3_fwd_reference(xa, wa, reflect=False),
                lambda: F.conv2d(xa.permute(0, 3, 1, 2), wa_oihw, padding=1),
                2 * 9 * 64 * 64 * 16 * h * w,
                2 * xa.numel() * xa.element_size()
                + wa.numel() * wa.element_size(), dtype)
            del xa
    torch.backends.cudnn.allow_tf32 = True
    return rows


# ------------------------------------------------------------ SRGAN train
TRAIN_B, TRAIN_HR, TRAIN_F = 8, 192, 8  # bench.py's gan_train workload
TRAIN_LR = TRAIN_HR // TRAIN_F
TRAIN_IMAGES, TRAIN_LR_SIDE = 16, 96  # bench.py:316: 16 images, 96^2 LR
TRAIN_A_SHAPES = [  # (x shape, Cout) of the training G's fused convs
    ((TRAIN_B, TRAIN_LR, TRAIN_LR, 64), 64),
    ((TRAIN_B, TRAIN_LR, TRAIN_LR, 64), 256),
    ((TRAIN_B, 2 * TRAIN_LR, 2 * TRAIN_LR, 64), 256),
    ((TRAIN_B, 4 * TRAIN_LR, 4 * TRAIN_LR, 64), 256)]
# one g_fuse='train' step: the 36 fused convs forward and their dgrads
# (kernel A), their wgrads (kernel B); a metrics forward adds 36 A
TRAIN_STEP_LAUNCHES = {KERNEL_A: 72, KERNEL_B: 36}
TRAIN_CLI_STEPS = 3 * TRAIN_IMAGES // TRAIN_B  # 2 + 1 epochs of 2 steps


def check_train_kernels(shapes=TRAIN_A_SHAPES):
    """Phase 2, SRGAN training: kernel A forward, its dgrad (Cout -> 64,
    Cin = 256 for the 64 -> 256 convs) and kernel B at every shape the
    training G gives them under g_fuse='train' (batch 8, the 24^2 patch
    and its x2 and x4 maps, zero pad, no prologue; or ``shapes``: a
    data-parallel rank's batch of 4). Returns the largest f32 abs error of
    each kernel."""
    from tpusr_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"fused_conv3x3_fwd": 0.0, "fused_conv3x3_wgrad": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for shape, cout in shapes:
            n, h, w, cin = shape
            x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            wt = ((torch.rand(3, 3, cin, cout, generator=gen, device="cuda")
                   * 2 - 1) / 24).to(dtype)
            g = torch.randn(n, h, w, cout, generator=gen,
                            device="cuda").to(dtype)
            xp, wp, gp = (t.double() if f32 else t for t in (x, wt, g))
            w_rot = wt.flip(0, 1).transpose(2, 3).contiguous()
            y, _ = fc.fused_conv3x3_fwd(x, wt, reflect=False)
            d, _ = fc.fused_conv3x3_fwd(g, w_rot, reflect=False)
            dw = fc.fused_conv3x3_wgrad(x, g, reflect=False)
            yr, _ = fc.fused_conv3x3_fwd_reference(xp, wp, reflect=False)
            dr, _ = fc.fused_conv3x3_fwd_reference(
                gp, wp.flip(0, 1).transpose(2, 3), reflect=False)
            dwr = fc.fused_conv3x3_wgrad_reference(xp, gp, reflect=False)
            torch.cuda.synchronize()
            errs = {"fwd": rel_err(y, yr), "dgrad": rel_err(d, dr),
                    "wgrad": rel_err(dw, dwr)}
            print(f"check SRGAN training {shape} 64->{cout} zero pad "
                  f"{str(dtype)[6:]} (dgrad {cout}->64): " + " ".join(
                      f"{k} {v:.3e}" for k, v in errs.items()))
            bad = {k: v for k, v in errs.items() if not v <= TOL[dtype]}
            if bad:
                raise AssertionError(f"kernels A/B disagree with their plain "
                                     f"versions at the training shape "
                                     f"{shape} -> {cout} {dtype}: {bad}")
            if f32:
                worst["fused_conv3x3_fwd"] = max(
                    worst["fused_conv3x3_fwd"], abs_err(y, yr),
                    abs_err(d, dr))
                worst["fused_conv3x3_wgrad"] = max(
                    worst["fused_conv3x3_wgrad"], abs_err(dw, dwr))
            del x, g, y, d, dw, yr, dr, dwr
    torch.backends.cudnn.allow_tf32 = True
    return worst


def check_train_generator(device="cuda", blocks=16):
    """Phase 8a: one train-mode forward and backward of the full-width x8
    Generator at batch 8 on the 24^2 training patch, fused (g_fuse
    'train': kernels A and B, f32) against the unfused net in f64 from the
    same weights, cuDNN's TF32 off: output within 1e-4 and all parameter
    gradients, as one vector against its largest entry, within 1e-3 (the
    DIP net's gate). The unfused f32 net's distance is printed beside."""
    torch.backends.cudnn.allow_tf32 = False
    nets = {"fused": srgan_generator(None, blocks, device),
            "off": srgan_generator(None, blocks, device),
            "off_f64": srgan_generator(None, blocks, device).double()}
    lr = torch.rand(TRAIN_B, 3, TRAIN_LR, TRAIN_LR,
                    generator=torch.Generator().manual_seed(4)).to(device)
    outs, grads = {}, {}
    for name, net in nets.items():
        y = net(lr.to(next(net.parameters()).dtype), True,
                fuse=name == "fused")
        y.square().mean().backward()
        outs[name] = y.detach()
        grads[name] = torch.cat([p.grad.flatten() for p in net.parameters()])
    err = {k: (rel_err(outs[k], outs["off_f64"]),
               rel_err(grads[k], grads["off_f64"])) for k in ("fused", "off")}
    print(f"SRGAN training G x8, batch {TRAIN_B} at {TRAIN_LR}^2, {blocks} "
          f"blocks, train mode, TF32 off, against the f64 unfused net: "
          f"fused f32 out {err['fused'][0]:.3e} grads {err['fused'][1]:.3e}; "
          f"unfused f32 out {err['off'][0]:.3e} grads {err['off'][1]:.3e}")
    if not (err["fused"][0] <= 1e-4 and err["fused"][1] <= 1e-3):
        raise AssertionError("fused training G disagrees with the f64 net")
    torch.backends.cudnn.allow_tf32 = True


def write_train_tree(root, n=TRAIN_IMAGES, lr_side=2 * TRAIN_LR_SIDE):
    """A synthetic DIV2K train tree: n HR images of 8 * lr_side and their x8
    LRs; the loader's /2 gives bench.py's 96^2 LR and 768^2 HR."""
    from PIL import Image

    hr_dir = os.path.join(root, "DIV2K_train_HR")
    lr_dir = os.path.join(root, "DIV2K_train_LR_x8")
    os.makedirs(hr_dir)
    os.makedirs(lr_dir)
    rng = np.random.default_rng(1)
    side = 8 * lr_side
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    for i in range(n):
        img = np.stack([np.sin(xx / (31.0 + i)) * np.cos(yy / 23.0),
                        np.sin((xx + yy + 40 * i) / 51.0),
                        np.cos(xx / 17.0 - yy / (29.0 + i))], -1) * 90 + 128
        img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(
            np.uint8)
        hr = Image.fromarray(img)
        hr.save(os.path.join(hr_dir, f"{i + 1:04d}.png"), compress_level=1)
        hr.resize((lr_side, lr_side), Image.BICUBIC).save(
            os.path.join(lr_dir, f"{i + 1:04d}x8.png"))


def run_train_cli(root, dtype, device="cuda", blocks=16):
    """One ``cli/train_gan.run`` (2 pre-train + 1 fine-tune epochs, log every
    epoch) with the launch counts around it; its files, finite losses and
    a pre-trained G that the eval CLI's loader takes. Returns (counts, s)."""
    from tpusr_torch.cli import eval_gan, train_gan
    from tpusr_torch.engine.gan import GANTrainConfig

    out = os.path.join(root, f"out_{dtype}_{os.getpid()}")
    os.makedirs(out)
    reset_counts()
    t0 = time.perf_counter()
    out_dir = train_gan.run([
        "--data_dir", root, "--out_dir", out, "--pre_train_epochs", "2",
        "--fine_tune_epochs", "1", "--train_log_freq", "1", "--dtype",
        dtype, "--residual_blocks", str(blocks), "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    files = set(os.listdir(out_dir))
    want = {f"{p}_{k}" for p in ("pre_trained", "fine_tuned")
            for k in ("state", "srgan_G.pth", "srgan_D.pth")}
    logs = [f for f in files if f.endswith("_log.txt")]
    if not (want <= files and len(logs) == 2):
        raise AssertionError(f"train CLI wrote {sorted(files)}")
    final = {}
    for f in logs:
        for line in open(os.path.join(out_dir, f)).read().splitlines():
            key, value = line.split(": ", 1)
            final[key] = value
    losses = [float(final[k]) for k in ("Final Generator loss",
                                        "Final Discriminator loss")]
    psnrs = json.loads(final["Average PSNR during training"])
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(psnrs))):
        raise AssertionError(f"train CLI losses/PSNR not finite: {final}")
    g, _ = eval_gan.load_generator(
        os.path.join(out_dir, "pre_trained_srgan_G.pth"),
        GANTrainConfig(residual_blocks_count=blocks), device)
    with torch.inference_mode():
        y = g(torch.rand(1, 3, 24, 24, device=device))
    if not (y.shape == (1, 3, 192, 192) and bool(torch.isfinite(y).all())):
        raise AssertionError("the pre-trained G.pth does not serve eval")
    print(f"train CLI {dtype}: {TRAIN_CLI_STEPS} steps of batch {TRAIN_B} "
          f"in {wall:.3f} s (PNG decode, PIL resizes, init, metrics and "
          f"saves included); final losses G {losses[0]:.4f} D "
          f"{losses[1]:.4f}; PSNR per epoch {psnrs}; launches {counts}")
    return counts, wall


def train_cli_child(root, out_json):
    """Subprocess body: the train CLI in both dtypes with TPUSR_G_FUSE set
    by the parent, its launch counts written to out_json."""
    res = {dtype: run_train_cli(root, dtype)[0]
           for dtype in ("float32", "bfloat16")}
    with open(out_json, "w") as f:
        json.dump(res, f)


def run_train_main_paths(root):
    """Phase 8b: the train CLI in f32 and bf16, in this process (default
    routing, g_fuse 'eval': the training G on cuDNN) and in a subprocess
    with TPUSR_G_FUSE=train (read at import). Per train-routed step 72 A and
    36 B; the metrics forward of each step of a log epoch 36 A."""
    paths = {}
    for dtype in ("float32", "bfloat16"):
        paths[f"srgan train {dtype} g_fuse=eval"], _ = run_train_cli(root,
                                                                     dtype)
    out_json = os.path.join(root, "child_counts.json")
    env = dict(os.environ, TPUSR_G_FUSE="train")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--train-cli-child", root, out_json], env=env,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"train CLI child failed: {proc.returncode}")
    with open(out_json) as f:
        child = json.load(f)
    for dtype, counts in child.items():
        paths[f"srgan train {dtype} g_fuse=train"] = counts
    zero = {k: 0 for k in read_counts()}
    steps = TRAIN_CLI_STEPS
    want_train = {**zero, "fused_conv3x3_fwd": steps * (72 + 36),
                  "fused_conv3x3_wgrad": steps * 36}
    for name, counts in paths.items():
        want = want_train if name.endswith("train") else zero
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, want {want}")
    return paths


def train_workload(cfg, device="cuda", n=TRAIN_IMAGES, side=TRAIN_LR_SIDE):
    """bench.py's gan_train inputs: random uint8 stacks of n images of
    side^2 LR (and x8 HR), all valid; a state from seed 0."""
    from tpusr_torch.engine.gan import create_gan_state

    state = create_gan_state(cfg, cfg.pre_train_lr,
                             generator=torch.Generator().manual_seed(0),
                             device=device)
    rng = np.random.default_rng(0)
    f = cfg.factor
    lr_u8 = torch.from_numpy(rng.integers(0, 256, (n, side, side, 3),
                                          dtype=np.uint8)).to(device)
    hr_u8 = torch.from_numpy(rng.integers(0, 256, (n, f * side, f * side, 3),
                                          dtype=np.uint8)).to(device)
    valid = torch.full((n, 2), side, dtype=torch.int32, device=device)
    return state, lr_u8, hr_u8, valid


def random_vgg(device="cuda"):
    """VGG19 feature weights drawn from seed 0 (He normal, small biases)."""
    from tpusr_torch.models import vgg19

    gen = torch.Generator().manual_seed(0)
    params, cin = {}, 3
    names = iter(vgg19.vgg19_layer_names())
    for cout, n in vgg19._VGG19_BLOCKS:
        for _ in range(n):
            params[next(names)] = {
                "weight": (torch.randn(cout, cin, 3, 3, generator=gen)
                           * (2.0 / (9 * cin)) ** 0.5).to(device),
                "bias": (torch.randn(cout, generator=gen) * 0.01).to(device)}
            cin = cout
    return params


def time_gan_train(label, cfg, steps=50, warmup=6, device="cuda",
                   content_loss=None):
    """Phase 8c: bench.py's gan_train workload through the port's epoch
    trainer: patches/s over ``steps`` steps after ``warmup`` (the first
    epoch of each call takes its metrics forward, as bench.py's does)."""
    from tpusr_torch.engine import losses
    from tpusr_torch.engine.gan_epochs import gan_train_epochs

    state, lr_u8, hr_u8, valid = train_workload(cfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    per_epoch = lr_u8.shape[0] // cfg.batch_size
    content = content_loss or losses.mse

    def run(n):
        _, logs = gan_train_epochs(state, lr_u8, hr_u8, valid, gen, cfg,
                                   content, n_epochs=max(1, n // per_epoch))
        return float(logs["losses_G"][-1, -1])

    run(warmup)
    t0 = time.perf_counter()
    last = run(steps)
    dt = time.perf_counter() - t0
    if not np.isfinite(last):
        raise AssertionError(f"{label}: loss not finite")
    rate = cfg.batch_size * steps / dt
    print(f"SRGAN train {label}: {rate:.2f} patches/s ({dt / steps * 1e3:.3f}"
          f" ms/step over {steps} steps after {warmup})")
    return dict(patches_per_s=rate, ms_per_step=dt / steps * 1e3)


def profile_train_step(label, cfg, device="cuda", top=10):
    """Phase 8c: one step's device time, profiled: busy, idle share and
    operations of the whole step (which must record all its kernel-A/B
    launches under g_fuse 'train'), and the busy time of its parts from
    windows of their own on the same state and patches: the G forward, the
    D update (forward + backward), the G update (D on the fake, content,
    backward through D and G), the two Adam steps; glue = PyTorch's own
    elementwise, reduction and copy kernels of the whole step; VGG = a
    step with VGG19 content on seeded weights minus the MSE step."""
    from tpusr_torch.engine import gan as eng
    from tpusr_torch.engine import losses
    from tpusr_torch.engine.gan_epochs import _crop_pair

    state, lr_u8, hr_u8, valid = train_workload(cfg, device)
    gen = torch.Generator(device=device).manual_seed(1)
    lr_p, hr_p = _crop_pair(lr_u8[:cfg.batch_size], hr_u8[:cfg.batch_size],
                            valid[:cfg.batch_size], gen, TRAIN_LR, cfg.factor)
    vgg = losses.make_content_loss(random_vgg(device))
    fused = cfg.g_fuse == "train"

    def step(content=losses.mse):
        return lambda: eng.gan_train_step(state, lr_p, hr_p, cfg, content)

    def g_and_d():
        eng._d_update(state, eng._g_forward(state, lr_p, cfg), hr_p, cfg)

    ms = time_ms(step(), 20, warmup=3)
    ms_vgg = time_ms(step(vgg), 5, warmup=2)
    kernels, busy = profile_window(step(), 1, expect=TRAIN_STEP_LAUNCHES
                                   if fused else None)
    parts = {
        "G forward": profile_window(
            lambda: eng._g_forward(state, lr_p, cfg), 3)[1],
        "G forward + D update": profile_window(g_and_d, 3)[1],
        "Adam D": profile_window(lambda: state.opt_D.step(), 3)[1],
        "Adam G": profile_window(lambda: state.opt_G.step(), 3)[1],
        "step with VGG19 content": profile_window(step(vgg), 1)[1]}
    split = {
        "G forward": parts["G forward"],
        "D update": parts["G forward + D update"] - parts["G forward"]
        - parts["Adam D"],
        "G update": busy - parts["G forward + D update"] - parts["Adam G"],
        "Adam": parts["Adam D"] + parts["Adam G"],
        "glue (whole step)": sum(
            e.self_device_time_total for e in kernels
            if "at::native" in e.key or "Memcpy" in e.key
            or "Memset" in e.key) / 1e3,
        "VGG19 content": parts["step with VGG19 content"] - busy}
    ab = ""
    if fused:
        a, b = (sum(e.self_device_time_total for e in kernels if k in e.key)
                / 1e3 for k in (KERNEL_A, KERNEL_B))
        ab = (f"; kernel A {a:.3f} ms, kernel B {b:.3f} ms (all 72 A and "
              f"36 B launches recorded)")
    ops = sum(e.count for e in kernels)
    print(f"SRGAN train step {label}, batch {cfg.batch_size} at "
          f"{cfg.hr_patch}^2: {ms:.3f} ms (CUDA events over 20), busy "
          f"{busy:.3f} ms, idle share {1 - busy / ms:.4f}, {ops} device "
          f"operations{ab}; with VGG19 content {ms_vgg:.3f} ms; busy by "
          f"part: " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    print_top(kernels, 1, top, "step")
    return dict(ms=ms, busy=busy, idle=1 - busy / ms, ops=ops,
                ms_vgg=ms_vgg, **split)


def time_train_kernels():
    """Phase 7, SRGAN training, f32 and bf16: kernel A at the residual
    convs' (8, 24, 24, 64) -> 64 and at the largest dgrad, (8, 96, 96, 256)
    -> 64; kernel B at (8, 24, 24, 64) x 64 and (8, 96, 96, 64) x 256; each
    against one cuDNN call (F.conv2d, conv2d_weight; f32 without TF32)."""
    from tpusr_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {"fused_conv3x3_fwd": {}, "fused_conv3x3_wgrad": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        isz = torch.tensor([], dtype=dtype).element_size()
        for (n, h, w, cin), cout in (((TRAIN_B, TRAIN_LR, TRAIN_LR, 64), 64),
                                     ((TRAIN_B, 4 * TRAIN_LR, 4 * TRAIN_LR,
                                       256), 64)):
            x = torch.randn(n, h, w, cin, generator=gen,
                            device="cuda").to(dtype)
            wt = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda")
                  / 24).to(dtype)
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            label = f"({n}, {h}, {w}, {cin}) -> {cout}, zero pad, {name}"
            rows["fused_conv3x3_fwd"][label] = measure(
                f"fused_conv3x3_fwd at {label}",
                lambda: fc.fused_conv3x3_fwd(x, wt, reflect=False),
                lambda: fc.fused_conv3x3_fwd_reference(x, wt, reflect=False),
                lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1),
                2 * 9 * cin * cout * n * h * w,
                (x.numel() + n * h * w * cout + wt.numel()) * isz, dtype)
        for (n, h, w, cin), cout in (((TRAIN_B, TRAIN_LR, TRAIN_LR, 64), 64),
                                     ((TRAIN_B, 4 * TRAIN_LR, 4 * TRAIN_LR,
                                       64), 256)):
            x = torch.randn(n, h, w, cin, generator=gen,
                            device="cuda").to(dtype)
            g = torch.randn(n, h, w, cout, generator=gen,
                            device="cuda").to(dtype)
            label = f"({n}, {h}, {w}, {cin}) x {cout}, zero pad, {name}"
            rows["fused_conv3x3_wgrad"][label] = measure(
                f"fused_conv3x3_wgrad at {label}",
                lambda: fc.fused_conv3x3_wgrad(x, g, reflect=False),
                lambda: fc.fused_conv3x3_wgrad_reference(x, g, reflect=False),
                lambda: torch.nn.grad.conv2d_weight(
                    x.permute(0, 3, 1, 2), (cout, cin, 3, 3),
                    g.permute(0, 3, 1, 2), padding=1),
                2 * 9 * cin * cout * n * h * w,
                (x.numel() + g.numel()) * isz + 9 * cin * cout * 4, dtype)
    torch.backends.cudnn.allow_tf32 = True
    return rows


# ------------------------------------------------------------ DIP variants
# phase 9's DIP rows: (label, CLI flags, iterations, log_freq, tree); every
# row at full width, f32, conv_fusion 'auto', on a 512^2 canvas ('ragged':
# a 496 x 472 HR padded to 512^2 by --bucket 64)
VARIANT_ROWS = (
    ("dip lbfgs fixed", ["--optimizer", "lbfgs", "--lbfgs_line_search",
                         "fixed"], 10, 1, "square"),
    ("dip lbfgs zoom", ["--optimizer", "lbfgs"], 10, 1, "square"),
    ("dip meshgrid", ["--input_method", "meshgrid", "--input_depth", "2"],
     20, 10, "square"),
    ("dip opt_over net,input,down", ["--opt_over", "net,input,down"], 20,
     10, "square"),
    ("dip bucket 64", ["--bucket", "64"], 20, 10, "ragged"),
    ("dip bucket 64 batch 2", ["--bucket", "64", "--batch_images", "2",
                               "--num_images", "2"], 20, 10, "ragged"),
    ("dip profile", ["--profile_dir", "PROFILE"], 5, 5, "square"))
RAGGED_HR = (496, 472)  # H x W after the loader's /2
TILED_LR = (512, 128)  # H x W: 4 windows of 224 rows (halo 48) at 16 blocks


def write_ragged_tree(root):
    """Two DIV2K-layout pairs whose HR, after get_image_pair's /2, is
    496 x 472 (LR 62 x 59): not a multiple of the 64 bucket."""
    from PIL import Image

    hr_dir = os.path.join(root, "DIV2K_train_HR")
    lr_dir = os.path.join(root, "DIV2K_train_LR_x8")
    os.makedirs(hr_dir)
    os.makedirs(lr_dir)
    h, w = 2 * RAGGED_HR[0], 2 * RAGGED_HR[1]
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i, name in enumerate(("0001", "0002")):
        img = np.stack([np.sin(xx / (31.0 + 6 * i)) * np.cos(yy / 19.0),
                        np.sin((xx - yy) / 43.0), np.cos(xx / 13.0)],
                       -1) * 90 + 128
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
            np.uint8)
        hr = Image.fromarray(img)
        hr.save(os.path.join(hr_dir, f"{name}.png"))
        hr.resize((w // 8, h // 8), Image.BICUBIC).save(
            os.path.join(lr_dir, f"{name}x8.png"))


class EngineSpy:
    """Records, around one CLI run, what the engine hands back and what it
    trains: the curves of every dip_superresolve* call the CLI makes (for
    their gradient-evaluation counts) and the first and last z and kernel
    that each iteration's forward and backward (dip_forward_backward, which
    a CUDA graph captures once) trains (opt_over input/down). Restores the
    engine's functions on exit."""

    NAMES = ("dip_superresolve", "dip_superresolve_bucketed",
             "dip_superresolve_scan_bucketed")

    def __init__(self, cli, dip):
        self.cli, self.dip, self.curves, self.leaves = cli, dip, [], {}

    def __enter__(self):
        self.saved = {n: getattr(self.cli, n) for n in self.NAMES}
        self.saved_iter = self.dip.dip_forward_backward
        for n, fn in self.saved.items():
            setattr(self.cli, n, self._wrap(fn))
        spy = self

        def iteration(net, down, z, noise, lr, std, kernel=None,
                      lr_mask=None):
            for name, t in (("z", z), ("kernel", kernel)):
                if t is not None and t.requires_grad:
                    spy.leaves.setdefault(name, [t.detach().clone(), t])
            return spy.saved_iter(net, down, z, noise, lr, std, kernel,
                                  lr_mask)

        self.dip.dip_forward_backward = iteration
        return self

    def _wrap(self, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            self.curves.append(out[1])
            return out
        return call

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.cli, n, fn)
        self.dip.dip_forward_backward = self.saved_iter

    def grad_evals(self, warmup):
        """Gradient evaluations of the run: the curves' 'evals' (each
        image's; a grouped call's curves carry a leading image axis), plus
        ``warmup`` per image."""
        total = 0
        for c in self.curves:
            e = np.asarray(c["evals"])
            images = e.shape[0] if e.ndim == 2 else 1
            total += int(e.sum()) + warmup * images
        return total

    def losses(self):
        """Each image's loss curve."""
        return [row for c in self.curves
                for row in np.atleast_2d(np.asarray(c["loss"]))]

    def moved(self):
        return {k: float((t.detach() - t0).abs().max())
                for k, (t0, t) in self.leaves.items()}


def run_variant(cli, dip, root, label, flags, num_iter, log_freq):
    """Phase 9: one DIP variant through cli.run on the card, with the
    launch counts read around it: at least 20 kernel-A and 10 kernel-B
    launches per gradient evaluation, the resolved PNG at the image's own
    size, finite PSNR and loss; the loss falling on the L-BFGS rows (whose
    curves start after the warm-up); the PSNR curve rising on the Adam
    rows but opt_over and the 5-iteration profile row (one point). Adam
    at lr 0.01 on the downsampler's kernel (entries near 1e-3) wrecks the
    forward model within a few steps, and PSNR and loss then swing in
    tpusr as in the port, so that row asserts that z and the kernel
    trained, not a trend."""
    from PIL import Image

    out = os.path.join(root, "out_" + label.replace(" ", "_").replace(
        ",", "_"))
    os.makedirs(out)
    flags = [os.path.join(out, "trace") if f == "PROFILE" else f
             for f in flags]
    argv = ["--data_dir", root, "--out_dir", out, "--num_iter",
            str(num_iter), "--train_log_freq", str(log_freq),
            "--save_output", "True", "--device", "cuda", *flags]
    reset_counts()
    t0 = time.perf_counter()
    with EngineSpy(cli, dip) as spy:
        metrics = cli.run(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    lbfgs = "lbfgs" in flags
    evals = spy.grad_evals(dip.WARMUP_ITERS if lbfgs else 0)
    n = metrics["Number of images evaluated over"]
    iters = n * (num_iter + (dip.WARMUP_ITERS if lbfgs else 0))
    curve = [float(v) for v in metrics["Average PSNR per epoch"]]
    final = float(metrics["Average final PSNR"])
    (stamp,) = os.listdir(os.path.join(out, "out", "DIPx8"))
    img_dir = os.path.join(out, "out", "DIPx8", stamp, "images")
    sizes = {f: Image.open(os.path.join(img_dir, f)).size
             for f in sorted(os.listdir(img_dir)) if "resolved" in f}
    extra = ""
    if "zoom" in label:
        steps = evals - dip.WARMUP_ITERS - 1
        extra = (f"; {evals - dip.WARMUP_ITERS} objective evaluations in "
                 f"{num_iter} L-BFGS iterations ({steps / num_iter:.2f} "
                 f"line-search trial points per iteration after the first "
                 f"evaluation)")
    if spy.leaves:
        extra += f"; trained leaves moved by (max abs) {spy.moved()}"
    print(f"{label}: {n} image(s), {iters} iterations in {wall:.3f} s "
          f"({wall / iters * 1e3:.3f} ms/iteration incl. set-up, metrics and "
          f"PNGs); {evals} gradient evaluations; PSNR curve {curve} final "
          f"{final:.4f}; resolved {sizes}; launches {counts}{extra}")
    want_size = (RAGGED_HR[1], RAGGED_HR[0]) if "bucket" in label else (
        512, 512)
    if set(sizes.values()) != {want_size} or len(sizes) != n:
        raise AssertionError(f"{label}: resolved PNGs {sizes}")
    losses = spy.losses()
    print(f"  loss curves {[[float(v) for v in row] for row in losses]}")
    if not (np.all(np.isfinite(curve)) and np.isfinite(final)
            and all(np.all(np.isfinite(row)) for row in losses)):
        raise AssertionError(f"{label}: PSNR or loss not finite: {curve} "
                             f"{final} {losses}")
    if lbfgs:
        if not all(row[-1] < row[0] for row in losses):
            raise AssertionError(f"{label}: loss did not fall: {losses}")
    elif "opt_over" not in label and len(curve) > 1 and not (
            curve[-1] > curve[0]):
        raise AssertionError(f"{label}: PSNR not rising: {curve}")
    if not (counts["fused_conv3x3_fwd"] >= 20 * evals
            and counts["fused_conv3x3_wgrad"] >= 10 * evals and evals > 0):
        raise AssertionError(f"{label}: fewer than 20 A / 10 B launches per "
                             f"gradient evaluation ({evals}): {counts}")
    if "batch" in label and n != 2:
        raise AssertionError(f"{label}: {n} images logged, not 2")
    if "opt_over" in label:
        moved = spy.moved()
        if not (set(moved) == {"z", "kernel"}
                and all(v > 0 for v in moved.values())):
            raise AssertionError(f"{label}: z and the kernel did not train: "
                                 f"{moved}")
    if "profile" in label:
        traces = os.listdir(os.path.join(out, "trace"))
        size = sum(os.path.getsize(os.path.join(out, "trace", t))
                   for t in traces)
        print(f"  trace files {traces}, {size} bytes")
        if not (traces and size > 0):
            raise AssertionError(f"{label}: no trace written")
    return counts


def time_variants(iters=10, warmup=3):
    """Phase 9b: ms per iteration of each variant, steady state, at full
    width on the 512^2 canvas, f32, kernels on, in one process: CUDA events
    over ``iters`` iterations after ``warmup`` (the zoom iteration reads its
    trial values back, so its events enclose those syncs); each variant
    timed twice, in ABBA order, and beside the Adam iteration."""
    from tpusr_torch.engine import dip
    from tpusr_torch.engine.lbfgs import (ZoomLBFGS, lbfgs_fixed_init,
                                          lbfgs_fixed_step)
    from tpusr_torch.engine.metrics import _valid_mask

    def setup(input_depth=32, opt_over=()):
        config = dip.DIPConfig(input_depth=input_depth)
        net, down = dip.build(config, torch.Generator().manual_seed(0))
        net.to("cuda", memory_format=torch.channels_last)
        down.to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        if input_depth == 2:
            z = dip.meshgrid_input(512, 512).cuda().permute(0, 3, 1, 2)
        else:
            z = torch.rand(1, 512, 512, 32, generator=gen,
                           device="cuda").permute(0, 3, 1, 2) * 0.1
        lr = torch.rand(1, 3, 64, 64, generator=gen, device="cuda")
        leaves, kernel = list(net.parameters()), None
        if "input" in opt_over:
            z = z.clone().requires_grad_()
            leaves.append(z)
        if "down" in opt_over:
            kernel = down.kernel.clone().requires_grad_()
            leaves.append(kernel)
        return net, down, z, lr, leaves, kernel, gen

    def adam(input_depth=32, opt_over=(), mask=None):
        net, down, z, lr, leaves, kernel, gen = setup(input_depth, opt_over)
        opt = torch.optim.Adam(leaves, lr=0.01)

        def step():
            noise = torch.randn(1, 512, 512, input_depth, generator=gen,
                                device="cuda").permute(0, 3, 1, 2)
            dip.dip_iteration(net, down, opt, z, noise, lr, 0.05, kernel,
                              mask)
        return step

    def lbfgs(search):
        net, down, z, lr, leaves, _, _ = setup()
        x, vg = dip.flat_objective(net, down, leaves, z, lr)
        box = {"x": x}
        if search == "fixed":
            box["state"] = lbfgs_fixed_init(x.numel(), 10, "cuda")

            def step():
                _, g = vg(box["x"])
                upd, box["state"] = lbfgs_fixed_step(g, box["state"], 0.01)
                box["x"] = box["x"] + upd
        else:
            zoom = ZoomLBFGS(x.numel(), 10, "cuda")
            box["zoom"] = zoom

            def step():
                box["x"], _ = zoom.step(box["x"], vg)
        return step, box

    mask = _valid_mask((64, 64), (RAGGED_HR[0] // 8, RAGGED_HR[1] // 8),
                       "cuda")[None, None, :, :, 0]
    steps = {"adam (base)": adam(), "meshgrid": adam(input_depth=2),
             "opt_over net,input,down": adam(opt_over=("input", "down")),
             "bucketed (512^2 canvas, 496 x 472 valid)": adam(mask=mask)}
    boxes = {}
    for search in ("fixed", "zoom"):
        steps[f"lbfgs {search}"], boxes[search] = lbfgs(search)
    # host-bound times drift within a process: each step is timed twice,
    # in the order A..F then F..A, and the two are averaged
    times = {k: [] for k in steps}
    for k in [*steps, *reversed(steps)]:
        times[k].append(time_ms(steps[k], iters, warmup))
    base = sum(times["adam (base)"]) / 2
    print("DIP variants at 512^2 x8, full width, f32, kernels on, steady "
          f"state (CUDA events over {iters} iterations after {warmup}, "
          f"timed twice in ABBA order):")
    rows = {}
    for k, (t1, t2) in times.items():
        rows[k] = (t1 + t2) / 2
        print(f"  {k}: {rows[k]:.3f} ms/iteration ({t1:.3f}, {t2:.3f}); "
              f"{rows[k] / base:.3f}x the Adam iteration")
    zoom = boxes["zoom"]["zoom"]
    rows["lbfgs zoom evals/iteration"] = (
        (zoom.evals - 1) / len(zoom.linesearch_steps))
    print(f"  lbfgs zoom: {rows['lbfgs zoom evals/iteration']:.3f} objective "
          f"evaluations per iteration after the first; line-search steps "
          f"{zoom.linesearch_steps}")
    return rows


def check_tiled_eval(tiles=4, iters=5):
    """Phase 9c: tiled_generator_forward with 4 tiles of a 512 x 128 LR
    (windows of 224 rows, shorter than the image) at full width (16
    blocks), f32, held against generator_forward of the whole image with
    cuDNN's TF32 off, to 1e-4 max-abs on [-1, 1]; 36 kernel-A launches per
    call (one batched forward); then both timed (CUDA events, TF32 on as
    the eval CLI runs)."""
    from tpusr_torch.engine.gan import GANTrainConfig, generator_forward
    from tpusr_torch.parallel.spatial import (generator_receptive_halo,
                                              tiled_generator_forward)

    cfg = GANTrainConfig()
    net = srgan_generator(None)
    lr = torch.rand(1, *TILED_LR, 3, generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda") * 2 - 1
    halo = generator_receptive_halo(cfg)
    core = -(-TILED_LR[0] // tiles)
    window = min(TILED_LR[0], core + 2 * halo)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        reset_counts()
        tiled = tiled_generator_forward(net, lr, cfg, n_tiles=tiles)
        torch.cuda.synchronize()
        counts = read_counts()
        whole = generator_forward(net, lr, cfg)
        err = abs_err(tiled, whole)
        torch.backends.cudnn.allow_tf32 = True
        ms_tiled = time_ms(lambda: tiled_generator_forward(
            net, lr, cfg, n_tiles=tiles), iters, warmup=2)
        ms_whole = time_ms(lambda: generator_forward(net, lr, cfg), iters,
                           warmup=2)
    print(f"SRGAN x8 tiled eval, LR {TILED_LR[0]} x {TILED_LR[1]} -> "
          f"{8 * TILED_LR[0]} x {8 * TILED_LR[1]}, full width, f32, "
          f"{tiles} tiles (halo {halo}, windows of {window} rows, "
          f"{tiles * window / TILED_LR[0]:.3f}x the rows): max abs vs the "
          f"whole image {err:.3e} (TF32 off; tolerance 1e-4); tiled "
          f"{ms_tiled:.3f} ms, whole {ms_whole:.3f} ms "
          f"({ms_tiled / ms_whole:.3f}x); launches per call {counts}")
    if tiled.shape != whole.shape or not err <= 1e-4:
        raise AssertionError(f"tiled eval disagrees with the whole image: "
                             f"{err}")
    if counts != {**{k: 0 for k in counts}, "fused_conv3x3_fwd": 36}:
        raise AssertionError(f"tiled eval: not 36 kernel-A launches: "
                             f"{counts}")
    return counts, dict(err=err, ms_tiled=ms_tiled, ms_whole=ms_whole)


# ------------------------------------------------------- multi-device paths
SHARD_LR = TILED_LR  # 2 slabs of 256 rows, halo 48: edge-exact (256 >= 96)
SHARD_HALO = 2 * 16 + 16  # generator_receptive_halo at 16 blocks
SHARD_A_SHAPES = [  # every kernel-A call of one slab's window (352 rows)
    ((1, SHARD_LR[0] // 2 + 2 * SHARD_HALO, SHARD_LR[1], 64), 64),
    ((1, SHARD_LR[0] // 2 + 2 * SHARD_HALO, SHARD_LR[1], 64), 256),
    ((1, SHARD_LR[0] + 4 * SHARD_HALO, 2 * SHARD_LR[1], 64), 256),
    ((1, 2 * SHARD_LR[0] + 8 * SHARD_HALO, 4 * SHARD_LR[1], 64), 256)]
DP_RANKS = 2  # processes sharing the one card in phase 10
DP_TRAIN_SHAPES = [((TRAIN_B // DP_RANKS, *shape[1:]), cout)
                   for shape, cout in TRAIN_A_SHAPES]
LANE_ITERS = 10  # the sharded DIP's iterations
# the sharded DIP's PSNR gap to the lane batch after one step, and its
# loss's relative gap then, measured on an H100: 1.26e-3 dB and 1.22e-3
# (a rerun of the batch 1.2e-4 dB, 3.5e-5; the batch at learning rate 0
# 1.13 dB, 0.197)
SHARDED_DIP_DB = 0.03
SHARDED_DIP_LOSS = 0.02
# D's reduced gradient at W=2, f32, kernels A and B: its gradient through
# the fake group is ill-conditioned in f32 (port f32 against f64 3.5e-3,
# tests/test_torch_gan_train.py); measured 3.05e-3 on an H100
DP_D_GRAD_REL = 1e-2
# both nets' in the f64 exact step: G's output and D's logits are f32 by
# design (as tpusr), which rounds the f64 nets' differences up; measured
# G 3.4e-8, D 1.0e-5 on an H100
EXACT_GRAD_REL = 1e-4
# a g_fuse='train' step's launches by counter (TRAIN_STEP_LAUNCHES by
# profiler name)
STEP_COUNTS = {"fused_conv3x3_fwd": 72, "fused_conv3x3_wgrad": 36}


def train_batch(seed=0):
    """bench.py's gan_train patch shapes, seeded: LR (8, 24, 24, 3) in
    [0, 1], HR (8, 192, 192, 3) in [-1, 1]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lr = torch.rand(TRAIN_B, TRAIN_LR, TRAIN_LR, 3, generator=gen,
                    device="cuda")
    hr = torch.rand(TRAIN_B, TRAIN_HR, TRAIN_HR, 3, generator=gen,
                    device="cuda") * 2 - 1
    return lr, hr


def gan_state(cfg):
    from tpusr_torch.engine.gan import create_gan_state

    return create_gan_state(cfg, cfg.pre_train_lr,
                            generator=torch.Generator().manual_seed(0),
                            device="cuda")


def state_err(a, b):
    """Largest abs difference over both nets' parameters and statistics,
    and the largest relative one (against the larger magnitude)."""
    worst, rel = 0.0, 0.0
    for net in ("G", "D"):
        sa = getattr(a, net).state_dict()
        for k, v in getattr(b, net).state_dict().items():
            d = (sa[k].double() - v.double()).abs()
            worst = max(worst, float(d.max()))
            mag = torch.maximum(sa[k].double().abs(), v.double().abs())
            rel = max(rel, float((d / mag.clamp(min=1e-30)).max()))
    return worst, rel


class exact_convs:
    """cuDNN deterministic and without TF32 inside the block, so that two
    routes through the same convs round alike."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cudnn.deterministic, b.cudnn.benchmark,
                      b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.deterministic, b.cudnn.benchmark = True, False
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        b = torch.backends
        (b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
         b.cuda.matmul.allow_tf32) = self.saved


def host_ms(fn, n, warmup=2, barrier=None):
    """Host clock per call over n calls after warmup, synchronized (and
    behind a group barrier when given)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if barrier is not None:
        barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def check_native_loader():
    """Phase 10a: the native loader's status; where it builds, byte for
    byte the PIL path's arrays on the phase-5 valid tree and the phase-8
    train tree."""
    from tpusr_torch import native
    from tpusr_torch.data import div2k

    status = native.status()
    print(f"phase 10: native loader {status}")
    if not native.available():
        print("native loader unavailable here: get_image_pair decodes "
              "through PIL (the same bytes; a host path, no device)")
        return status, 0
    checked = 0
    with tempfile.TemporaryDirectory() as valid, \
            tempfile.TemporaryDirectory() as train:
        write_valid_tree(valid)
        write_train_tree(train)
        for root, split in ((valid, "valid"), (train, "train")):
            hr_dir = os.path.join(root, f"DIV2K_{split}_HR")
            lr_dir = os.path.join(root, f"DIV2K_{split}_LR_x8")
            for name in sorted(os.listdir(hr_dir)):
                for down in (False, True):
                    cfg = div2k.DatasetConfig(LR_dir=lr_dir, HR_dir=hr_dir,
                                              scale_factor=8,
                                              downsample=down)
                    hr_p = os.path.join(hr_dir, name)
                    lr_p = os.path.join(lr_dir, name[:-4] + "x8.png")
                    got = native.load_pair(hr_p, lr_p, 8, down)
                    want = div2k._pil_pair(cfg, hr_p, lr_p)
                    for a, b in zip(got, want):
                        if a.shape != b.shape or not np.array_equal(a, b):
                            raise AssertionError(f"native loader differs "
                                                 f"from PIL on {hr_p}")
                    checked += 1
    print(f"native loader: {checked} pairs byte-identical to PIL")
    return status, checked


def check_dp_world1(steps=5):
    """Phase 10b: NCCL at world size 1 in this process. make_dp_train_step
    at bench.py's gan_train shapes (batch 8, 192^2 HR, 16 blocks, seed 0),
    g_fuse='train', bf16 (tpusr's defaults) and f32: losses, both nets and
    their statistics equal to gan_train_step's from the same state (cuDNN
    deterministic, no TF32), 72 kernel-A and 36 kernel-B launches per
    step; then ms/step of both, host clock over ``steps`` after 2, in ABBA
    order; and sharded_generator_forward with one shard equal to
    generator_forward."""
    import dataclasses
    from tpusr_torch.engine.gan import (GANTrainConfig, gan_train_step,
                                        generator_forward)
    from tpusr_torch.parallel.gan_dp import make_dp_train_step
    from tpusr_torch.parallel.mesh import make_mesh
    from tpusr_torch.parallel.spatial import sharded_generator_forward

    mesh = make_mesh(devices="cuda")
    print(f"phase 10: {mesh} over NCCL {torch.cuda.nccl.version()}")
    counts = {k: 0 for k in read_counts()}
    rows = {}
    for label, dtype in (("bf16", "bfloat16"), ("f32", None)):
        cfg = dataclasses.replace(GANTrainConfig(dtype="bfloat16"),
                                  dtype=dtype, g_fuse="train")
        lr, hr = train_batch()
        with exact_convs():
            single, dp = gan_state(cfg), gan_state(cfg)
            single, ls = gan_train_step(single, lr, hr, cfg)
            place, step = make_dp_train_step(mesh, cfg, cfg.pre_train_lr)
            dp = place(dp)
            reset_counts()
            dp, ld = step(dp, lr, hr)
            torch.cuda.synchronize()
            c = read_counts()
        loss_err = max(abs(float(ls[k]) - float(ld[k])) for k in ls)
        err, rel = state_err(single, dp)
        grad_rel = moments_rel(single, dp)
        print(f"DP step at W=1 (NCCL), {label}, g_fuse=train: losses "
              f"{ {k: float(v) for k, v in ld.items()} }, max abs vs "
              f"gan_train_step: losses {loss_err:.3e}, parameters and "
              f"statistics {err:.3e} (relative {rel:.3e}), first moments "
              f"(relative L2) {grad_rel}; launches {c}")
        if c != {**{k: 0 for k in c}, **STEP_COUNTS}:
            raise AssertionError(f"DP step {label}: launches {c}")
        # f32 within 1e-5; bf16 storage within its rounding (2^-8); the
        # gradients (first moments) within 1e-6
        if not (loss_err <= 1e-5 and (err <= 1e-5 if dtype is None
                                      else rel <= 2.0 ** -8)
                and max(grad_rel.values()) <= 1e-6):
            raise AssertionError(f"DP step at W=1 {label} differs from "
                                 f"gan_train_step: {loss_err}, {err}, {rel}, "
                                 f"{grad_rel}")
        for k in counts:
            counts[k] += c[k]
        a = host_ms(lambda: gan_train_step(single, lr, hr, cfg), steps)
        b = host_ms(lambda: step(dp, lr, hr), steps)
        b2 = host_ms(lambda: step(dp, lr, hr), steps)
        a2 = host_ms(lambda: gan_train_step(single, lr, hr, cfg), steps)
        rows[label] = dict(single=(a, a2), dp=(b, b2))
        print(f"DP step at W=1 {label}: {(b + b2) / 2:.3f} ms/step "
              f"({b:.3f}, {b2:.3f}) against gan_train_step "
              f"{(a + a2) / 2:.3f} ({a:.3f}, {a2:.3f}), ABBA, "
              f"{(b + b2) / (a + a2):.3f}x")
        del single, dp
    from tpusr_torch.models.layers import BatchNorm
    from tpusr_torch.parallel.mesh import all_reduce_grad

    st = gan_state(cfg)
    n_bn = [sum(isinstance(m, BatchNorm) for m in net.modules())
            for net in (st.G, st.D)]
    # forward and backward: every G BN once, every D BN in D's and in G's
    # update; then D's and G's gradients and the losses
    per_step = 2 * (n_bn[0] + 2 * n_bn[1]) + 3
    buf = torch.zeros(128, device="cuda", requires_grad=True)
    group = mesh.get_group("data")
    us = host_ms(lambda: all_reduce_grad(buf, group).sum().backward(), 200,
                 warmup=10) * 1e3 / 2
    print(f"DP step collectives: {per_step} per step (BN layers: G {n_bn[0]},"
          f" D {n_bn[1]}); one 128-float all-reduce costs {us:.1f} us on the "
          f"host (forward and backward timed together, halved)")
    costs = {env: collective_cost(env) for env in ("default", "0")}
    print(f"one 128-float dist.all_reduce at W=1, host clock over 300 after "
          f"20, in a fresh process: {costs['default']:.1f} us with torch's "
          f"default flight recorder, {costs['0']:.1f} us with "
          f"TORCH_FR_BUFFER_SIZE=0")
    rows["collectives"] = dict(per_step=per_step, us_each=us,
                               plain_us=costs)
    del st
    gcfg = GANTrainConfig()
    net = srgan_generator(None)
    x = torch.rand(1, 64, 48, 3, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    with torch.inference_mode():
        one = sharded_generator_forward(
            net, x, gcfg, mesh=make_mesh({"spatial": 1}, "cuda"))
        whole = generator_forward(net, x, gcfg)
    if not torch.equal(one, whole):
        raise AssertionError("one shard differs from generator_forward")
    print("sharded_generator_forward with one shard equals "
          "generator_forward")
    torch.distributed.destroy_process_group()
    return counts, rows


def collective_cost(fr_buffer):
    """Host microseconds of one 128-float dist.all_reduce in a fresh
    one-rank NCCL process (``--collective-child``), with torch's NCCL
    flight recorder at its default ('default') or its buffer size set."""
    env = dict(os.environ)
    if fr_buffer != "default":
        env["TORCH_FR_BUFFER_SIZE"] = fr_buffer
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--collective-child"], capture_output=True,
                          text=True, env=env, timeout=300, check=True)
    return float(proc.stdout.strip().splitlines()[-1])


def collective_child():
    from tpusr_torch.parallel.mesh import make_mesh

    group = make_mesh(devices="cuda").get_group("data")
    buf = torch.zeros(128, device="cuda")
    us = host_ms(lambda: torch.distributed.all_reduce(buf, group=group),
                 300, warmup=20) * 1e3
    torch.distributed.destroy_process_group()
    print(us)


def dip_canvas(seed):
    """A 512^2 HR canvas and its 64^2 LR (PIL bicubic), (1, H, W, 3) f32
    in [0, 1]."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:512, 0:512].astype(np.float32)
    img = np.stack([np.sin(xx / (19.0 + seed)) * np.cos(yy / 23.0),
                    np.sin((xx + yy) / 31.0), np.cos(xx / 13.0 - yy / 17.0)],
                   -1) * 90 + 128
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    lr = np.asarray(Image.fromarray(img).resize((64, 64), Image.BICUBIC))
    return (lr[None].astype(np.float32) / 255.0,
            img[None].astype(np.float32) / 255.0)


def shared_card_child(rank, work):
    """Phase 10c, one of two processes on the one card in a gloo group (NCCL
    refuses two ranks on one GPU, "Duplicate GPU detected"; gloo stages
    every collective through host memory): the 2-shard forward, one DP
    step at W=2 and the sharded DIP; rank 0 holds each against its
    one-process counterpart. Results go to work/shared{rank}.pt."""
    from tpusr_torch.engine.dip import (DIPConfig, dip_superresolve_batch)
    from tpusr_torch.engine.gan import (GANTrainConfig, gan_train_step,
                                        generator_forward)
    from tpusr_torch.parallel.dip_batch import dip_superresolve_sharded
    from tpusr_torch.parallel.gan_dp import make_dp_train_step
    from tpusr_torch.parallel.mesh import make_mesh
    from tpusr_torch.parallel.spatial import sharded_generator_forward
    import dataclasses

    out = {}
    barrier = torch.distributed.barrier
    mesh = make_mesh(devices="cuda", backend="gloo")
    smesh = make_mesh({"spatial": DP_RANKS}, "cuda", backend="gloo")

    cfg = GANTrainConfig()
    net = srgan_generator(None)
    lr = torch.rand(1, *SHARD_LR, 3, generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda") * 2 - 1
    with torch.inference_mode():
        with exact_convs():
            reset_counts()
            got = sharded_generator_forward(net, lr, cfg, mesh=smesh)
            torch.cuda.synchronize()
            out["shard_counts"] = read_counts()
            whole = generator_forward(net, lr, cfg)
            out["shard_err"] = abs_err(got, whole)
        out["shard_ms"] = host_ms(lambda: sharded_generator_forward(
            net, lr, cfg, mesh=smesh), 5, barrier=barrier)
        barrier()
        if rank == 0:
            out["whole_ms"] = host_ms(lambda: generator_forward(
                net, lr, cfg), 5)
        barrier()
    del net, got, whole

    tcfg = GANTrainConfig(dtype=None, g_fuse="train")
    lo, hi = train_batch(1)
    with exact_convs():
        place, step = make_dp_train_step(mesh, tcfg, tcfg.pre_train_lr)
        state = place(gan_state(tcfg))
        reset_counts()
        state, logs = step(state, lo, hi)
        torch.cuda.synchronize()
        out["dp_counts"] = read_counts()
        out["dp_losses"] = {k: float(v) for k, v in logs.items()}
        barrier()
        if rank == 0:
            single, ls = gan_train_step(gan_state(tcfg), lo, hi, tcfg)
            out["dp_loss_err"] = max(abs(float(ls[k]) - float(logs[k]))
                                     for k in ls)
            out["dp_err"] = state_err(single, state)
            out["dp_grad_rel"] = moments_rel(single, state)
            del single
        del state
        # the EXACT step: the reduced gradients themselves, held through
        # the first moments
        ecfg = GANTrainConfig(dtype=None, adv_weight=0.0)
        place, step = make_dp_train_step(mesh, ecfg, 0.0)
        lo64, hi64 = lo.double(), hi.double()
        state, _ = step(place(exact_state(ecfg)), lo64, hi64)
        barrier()
        if rank == 0:
            single, _ = gan_train_step(exact_state(ecfg), lo64, hi64, ecfg)
            out["exact_grad_rel"] = moments_rel(single, state)
            del single
        del state

    dcfg = DIPConfig(num_iter=LANE_ITERS, log_freq=1)
    canv = [dip_canvas(s) for s in range(DP_RANKS)]
    lr_d = np.stack([c[0] for c in canv])
    hr_d = np.stack([c[1] for c in canv])

    def gens(lanes):
        return [torch.Generator().manual_seed(s) for s in lanes]

    with exact_convs():
        reset_counts()
        res, curves = dip_superresolve_sharded(lr_d, hr_d,
                                               gens(range(DP_RANKS)), dcfg,
                                               mesh)
        out["dip_counts"] = read_counts()
        barrier()
        if rank == 0:
            # all lanes in one process, twice: the second run is the
            # noise floor of the first (upsample and reflection-pad
            # backward add with atomics on the card, and Adam's first
            # step turns any gradient-sign flip into 2 lr); and a control
            # at learning rate 0, what a sharded run that never stepped
            # would give
            runs = [dip_superresolve_batch(lr_d, hr_d, gens(range(DP_RANKS)),
                                           cfg) for cfg in
                    (dcfg, dcfg, dataclasses.replace(dcfg,
                                                     learning_rate=0.0))]
            out["dip"] = dict(sharded=curves_apart((res, curves), runs[0]),
                              rerun=curves_apart(runs[1], runs[0]),
                              control=curves_apart(runs[2], runs[0]),
                              lanes_in_order=lanes_in_order(res, runs[0][0]),
                              psnr_last=curves["psnr"][:, -1].tolist(),
                              **lane_count_step(dcfg, lr_d))
    torch.save(out, os.path.join(work, f"shared{rank}.pt"))


def moments_rel(a, b):
    """Relative L2 distance of b's Adam first moments from a's, per net:
    after one step they are (1 - b1) times the step's gradients."""
    from tpusr_torch.engine.gan import adam_moments

    rel = {}
    for net in ("G", "D"):
        ma = adam_moments(getattr(a, f"opt_{net}"))[1]
        mb = adam_moments(getattr(b, f"opt_{net}"))[1]
        va = torch.cat([m.double().reshape(-1) for m in ma])
        vb = torch.cat([m.double().reshape(-1) for m in mb])
        rel[net] = float((vb - va).norm() / va.norm())
    return rel


def exact_state(cfg):
    """gan_state in f64 at learning rate 0: a step moves no net, so its
    first moments are the gradients at the start, of G and D alike."""
    from tpusr_torch.engine.gan import create_gan_state

    state = create_gan_state(cfg, 0.0, generator=torch.Generator()
                             .manual_seed(0), device="cuda")
    state.G.double()
    state.D.double()
    return state


def curves_apart(a, b):
    """How far DIP run a (result, curves) lies from run b: the pixels'
    median abs difference and the share above 1e-3; the PSNR curves'
    largest gap over the lanes at each head (``psnr_at``; head 0 is
    before any step) and over all; the loss curves' largest relative gap
    at each head (``loss_at``) and over all."""
    diff = (a[0] - b[0]).abs().float().cpu().numpy()
    pa, pb = a[1]["psnr"], b[1]["psnr"]
    la, lb = np.asarray(a[1]["loss"]), np.asarray(b[1]["loss"])
    psnr_at = np.abs(pa - pb).max(0)
    loss_at = (np.abs(la - lb) / np.abs(lb)).max(0)
    return dict(median=float(np.median(diff)),
                frac=float((diff > 1e-3).mean()),
                psnr=float(psnr_at.max()), head=float(psnr_at[0]),
                psnr_at=psnr_at.tolist(), loss=float(loss_at.max()),
                loss_at=loss_at.tolist())


def lanes_in_order(res, ref):
    """Each lane's result lies nearer the same lane of ``ref`` than any
    other lane of it (mean abs difference)."""
    n = res.shape[0]
    d = [[float((res[i] - ref[j]).abs().mean()) for j in range(n)]
         for i in range(n)]
    return all(d[i][i] < min(d[i][j] for j in range(n) if j != i)
               for i in range(n))


def lane_count_step(cfg, lr_d):
    """One lane_iteration of two lanes batched and of each lane alone, from
    the same nets, z and noise: the gradients' relative L2 difference (the
    largest over the lanes) and the share of parameters whose first Adam
    update differs by more than lr / 2 (a gradient-sign flip moves a
    parameter 2 lr apart)."""
    import dataclasses
    from tpusr_torch.engine import dip

    cfg = dataclasses.replace(cfg, conv_fusion="off")
    n = lr_d.shape[0]
    nets = [dip.build(cfg, torch.Generator().manual_seed(i))[0]
            for i in range(n)]
    down = dip.build(cfg)[1].cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    z = torch.rand(n, 1, cfg.input_depth, 512, 512, generator=gen,
                   device="cuda") * cfg.input_noise_scale
    noise = torch.randn(z.shape, generator=gen, device="cuda")
    lrs = torch.from_numpy(lr_d).permute(0, 1, 4, 2, 3).cuda()

    def step(lanes):
        params = dip.stack_lanes([nets[i] for i in lanes], "cuda")
        opt = torch.optim.Adam(params.values(), lr=cfg.learning_rate)
        dip.lane_iteration(nets[0].cuda(), down, params, opt, z[lanes],
                           noise[lanes], lrs[lanes], cfg.reg_noise_std)
        return params

    both = step(list(range(n)))
    alone = [step([i]) for i in range(n)]
    grad_rel, moved, total = 0.0, 0, 0
    with torch.no_grad():
        for i in range(n):
            g1 = torch.cat([alone[i][k].grad[0].reshape(-1) for k in both])
            g2 = torch.cat([both[k].grad[i].reshape(-1) for k in both])
            grad_rel = max(grad_rel, float((g2 - g1).norm() / g1.norm()))
            for k, p in both.items():
                moved += int(((p[i] - alone[i][k][0]).abs()
                              > cfg.learning_rate / 2).sum())
            total += g1.numel()
    return dict(grad_rel=grad_rel, flipped=moved / total, params=total)


def run_shared_card():
    """Phase 10c: spawn the two processes, read and hold their results:
    the 2-shard forward within 1e-4 of the whole (TF32 off) with 36 A
    launches per rank, the W=2 DP step against one process (losses 5e-4,
    parameters 1e-3, tests/test_parallel.py's bounds), the sharded DIP
    against the lane batch by tpusr's criteria (tests/test_parallel.py:
    183-190)."""
    from tpusr_torch.parallel.mesh import spawn

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        spawn(shared_card_child, DP_RANKS, (work,), backend="gloo",
              store_dir=work)
        res = [torch.load(os.path.join(work, f"shared{r}.pt"),
                          weights_only=False) for r in range(DP_RANKS)]
    r0 = res[0]
    shard = {k: sum(r["shard_counts"][k] for r in res)
             for k in r0["shard_counts"]}
    dp = {k: sum(r["dp_counts"][k] for r in res) for k in r0["dp_counts"]}
    print(f"2 processes on one card (gloo, host-staged): 2-shard forward "
          f"of a {SHARD_LR[0]} x {SHARD_LR[1]} LR, max abs vs the whole "
          f"{max(r['shard_err'] for r in res):.3e} (TF32 off; tolerance "
          f"1e-4); {r0['shard_ms']:.3f} ms against the whole forward "
          f"{r0['whole_ms']:.3f} ms ({r0['shard_ms'] / r0['whole_ms']:.3f}x,"
          f" host clock, 5 after 2); launches per rank "
          f"{[r['shard_counts'] for r in res]}")
    print(f"DP step at W=2 (global batch 8, f32, g_fuse=train): losses "
          f"{r0['dp_losses']}, vs one process: losses "
          f"{r0['dp_loss_err']:.3e}, parameters and statistics "
          f"{r0['dp_err'][0]:.3e}, first moments (relative L2) "
          f"{r0['dp_grad_rel']}; launches per rank "
          f"{[r['dp_counts'] for r in res]}")
    print(f"exact DP step at W=2 (f64, lr 0, adv_weight 0, cuDNN): first "
          f"moments vs one process (relative L2) {r0['exact_grad_rel']}")
    d = r0["dip"]
    print(f"sharded DIP, {DP_RANKS} lanes x {LANE_ITERS} iterations at 512^2,"
          f" full width, f32 (TF32 off), against all lanes batched in one "
          f"process: {d['sharded']}; that batch run again against itself: "
          f"{d['rerun']}; the batch at learning rate 0 against it: "
          f"{d['control']} (median / share above 1e-3 of the pixels' abs "
          f"difference; PSNR curves' largest gap, at the first head; loss "
          f"curves' largest relative gap); lanes in order "
          f"{d['lanes_in_order']}; final "
          f"PSNR {d['psnr_last']}; lane batch, one iteration, batched "
          f"against alone: "
          f"gradients {d['grad_rel']:.3e} apart (relative L2), first Adam "
          f"update apart by more than lr/2 on {d['flipped']:.3e} of "
          f"{d['params']} parameters; launches "
          f"{[r['dip_counts'] for r in res]}")
    zero = {k: 0 for k in shard}
    for r in res:
        if not r["shard_err"] <= 1e-4:
            raise AssertionError(f"2-shard forward: {r['shard_err']}")
        if r["shard_counts"] != {**zero, "fused_conv3x3_fwd": 36}:
            raise AssertionError(f"2-shard forward launches "
                                 f"{r['shard_counts']}")
        if r["dp_counts"] != {**zero, **STEP_COUNTS}:
            raise AssertionError(f"DP step launches {r['dp_counts']}")
        if r["dip_counts"] != zero:
            raise AssertionError(f"sharded DIP launched {r['dip_counts']}")
        if r["dp_losses"] != r0["dp_losses"]:
            raise AssertionError("the ranks logged different losses")
    # losses and parameters at tests/test_parallel.py's bounds (which
    # Adam's sign-like first step passes whatever the gradients), D's
    # reduced gradient (taken before any update) through its first
    # moments, and both nets' in the exact f64 step (the all-reduce's f32
    # buffer rounds to ~6e-8)
    if not (r0["dp_loss_err"] < 5e-4 and r0["dp_err"][0] < 1e-3
            and r0["dp_grad_rel"]["D"] < DP_D_GRAD_REL
            and max(r0["exact_grad_rel"].values()) < EXACT_GRAD_REL):
        raise AssertionError(f"DP step at W=2 differs: {r0['dp_loss_err']},"
                             f" {r0['dp_err']}, {r0['dp_grad_rel']}, "
                             f"{r0['exact_grad_rel']}")
    # the sharded DIP against the lane batch: the same start (head 0,
    # 1e-4 dB), the lanes in order, and the same first step: head 1's
    # PSNR and loss within SHARDED_DIP_DB / SHARDED_DIP_LOSS, bounds that
    # the batch at learning rate 0 (a sharded run that never stepped)
    # must exceed. Later heads are printed, not held: upsample and
    # reflection-pad backward add with atomics, so a rerun of the same
    # batch parts from it by tenths of a dB within 10 iterations
    c, ctl = d["sharded"], d["control"]
    if not (c["head"] < 1e-4 and d["lanes_in_order"]
            and c["psnr_at"][1] < SHARDED_DIP_DB
            and c["loss_at"][1] < SHARDED_DIP_LOSS
            and ctl["psnr_at"][1] > SHARDED_DIP_DB
            and ctl["loss_at"][1] > SHARDED_DIP_LOSS
            and np.isfinite(d["psnr_last"]).all()):
        raise AssertionError(f"sharded DIP differs from the lane batch: {d}")
    # the lane batch itself: one iteration's gradients against each lane
    # alone, the DIP net's 1e-3 gradient gate of phase 3
    if not d["grad_rel"] < 1e-3:
        raise AssertionError(f"lane batch gradients: {d['grad_rel']}")
    return shard, dp, dict(shard_ms=r0["shard_ms"], whole_ms=r0["whole_ms"])


def time_lanes(iters=10, warmup=3):
    """Phase 10d: ms per image per DIP iteration at 512^2, full width, f32:
    the lane batch (N = 2 and 4 lanes, conv_fusion 'off' as tpusr forces)
    against the loop of dip_superresolve_scan_bucketed (one image's
    dip_iteration after another; conv_fusion 'auto', kernels A and B, and
    'off'); CUDA events over ``iters`` after ``warmup``."""
    import dataclasses
    from tpusr_torch.engine import dip

    base = dip.DIPConfig()
    lr_img, _ = dip_canvas(0)
    lr = torch.from_numpy(lr_img).permute(0, 3, 1, 2).cuda()
    rows = {}
    for fusion in ("auto", "off"):
        cfg = dataclasses.replace(base, conv_fusion=fusion)
        net, down = dip.build(cfg, torch.Generator().manual_seed(0))
        net.to("cuda", memory_format=torch.channels_last)
        down.to("cuda")
        opt = dip.make_optimizer(net, cfg)
        z = torch.rand(1, 512, 512, 32, device="cuda").permute(0, 3, 1, 2)
        rows[f"loop, conv_fusion {fusion}"] = time_ms(
            lambda: dip.dip_iteration(net, down, opt, z, torch.randn_like(z),
                                      lr, cfg.reg_noise_std), iters, warmup)
        del net, opt
    for n in (2, 4):
        cfg = dataclasses.replace(base, conv_fusion="off")
        nets = [dip.build(cfg, torch.Generator().manual_seed(i))[0]
                for i in range(n)]
        params = dip.stack_lanes(nets, "cuda")
        template = nets[0].cuda()
        opt = torch.optim.Adam(params.values(), lr=cfg.learning_rate)
        z = torch.rand(n, 1, 32, 512, 512, device="cuda") * 0.1
        lrs = lr[None].expand(n, -1, -1, -1, -1).contiguous()
        rows[f"lanes, N={n}"] = time_ms(
            lambda: dip.lane_iteration(template, down, params, opt, z,
                                       torch.randn_like(z), lrs,
                                       cfg.reg_noise_std),
            iters, warmup) / n
        del nets, params, template, opt, z
        torch.cuda.empty_cache()
    print("DIP iteration per image, 512^2, full width, f32 (CUDA events, "
          f"{iters} after {warmup}): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in rows.items()))
    return rows


# phase 10e: the L-BFGS lanes. Lanes, the lanes' iterations after the
# warm-up, and the bound on one batched iteration against each lane alone:
# phase 10c's lane-gradient bound (relative L2 of the parameters' update)
LBFGS_LANES = 2
LBFGS_LANE_ITERS = 10
LBFGS_STEP_REL = 1e-3


def lbfgs_lane_inputs(n=LBFGS_LANES):
    """n canvases (dip_canvas(0..n-1)) stacked as the lane batch takes
    them: lr (n, 1, 64, 64, 3), hr (n, 1, 512, 512, 3)."""
    pairs = [dip_canvas(i) for i in range(n)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def run_lbfgs_lane_batch(search):
    """Phase 10e (ii, iii): dip_superresolve_batch with L-BFGS at full
    width on 2 canvases, f32, TF32 off: WARMUP_ITERS Adam steps, then
    LBFGS_LANE_ITERS L-BFGS iterations (log_freq 1), the launch counts read
    around it (tpusr's vmap path is unfused: none of A-E may launch); every
    lane's loss finite and falling, the images finite. Returns the counts,
    the curves and a copy of the warm-up state that the engine handed
    lane_objective (template, downsampler, params, z, lr images)."""
    from tpusr_torch.engine import dip

    cfg = dip.DIPConfig(optimizer="lbfgs", lbfgs_line_search=search,
                        num_iter=LBFGS_LANE_ITERS, log_freq=1)
    lr, hr = lbfgs_lane_inputs()
    gens = [torch.Generator().manual_seed(i) for i in range(len(lr))]
    saved, warm = dip.lane_objective, {}

    def spy(template, down, params, z, lrs, kernel=None, lr_mask=None):
        warm.update(template=template, down=down, z=z.detach().clone(),
                    lrs=lrs.clone(), params={k: v.detach().clone()
                                             for k, v in params.items()})
        return saved(template, down, params, z, lrs, kernel, lr_mask)

    dip.lane_objective = spy
    try:
        reset_counts()
        t0 = time.perf_counter()
        res, curves = dip.dip_superresolve_batch(lr, hr, gens, cfg, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        dip.lane_objective = saved
    loss = curves["loss"]
    print(f"phase 10e: lane batch, L-BFGS {search}, {len(lr)} lanes x "
          f"({dip.WARMUP_ITERS} warm-up + {LBFGS_LANE_ITERS}) iterations in "
          f"{wall:.3f} s; loss curves {loss.tolist()}; PSNR "
          f"{curves['psnr'][:, -1].tolist()}; evaluations per lane "
          f"{curves['evals'].sum(1).tolist()}; launches {counts}")
    if any(counts.values()):
        raise AssertionError(f"L-BFGS lanes launched a kernel: {counts}")
    if not (np.isfinite(loss).all() and (loss[:, -1] < loss[:, 0]).all()
            and torch.isfinite(res).all() and res.shape == hr.shape):
        raise AssertionError(f"L-BFGS lanes ({search}): loss not finite or "
                             f"not falling: {loss.tolist()}")
    return counts, curves, warm


def lbfgs_steppers(search, n, size, memory=10):
    """(step(x, value_and_grad) -> (x, trial counts of this iteration,
    the update), the optimizer) of n lanes; L-BFGS 'fixed' at the default
    lr 0.01. The fixed update is the stepper's own: its first step,
    lr g / ||g||_1, is about 5e-9 an element at full width, the rounding
    of the parameters themselves (an ulp of 0.05 is 3.7e-9), so x' - x
    would measure the rounding of x + update; the zoom update (g / ||g||_2
    times the stepsize) is x' - x."""
    from tpusr_torch.engine.lbfgs import (ZoomLBFGSLanes,
                                          lbfgs_fixed_init_lanes,
                                          lbfgs_fixed_step_lanes)

    if search == "zoom":
        opt = ZoomLBFGSLanes(n, size, memory, "cuda")

        def step(x, vg):
            x1, _ = opt.step(x, vg)
            return x1, [s[-1] for s in opt.linesearch_steps], x1 - x
        return step, opt
    box = {"state": lbfgs_fixed_init_lanes(n, size, memory, "cuda")}

    def step(x, vg):
        _, g = vg(x, list(range(n)))
        upd, box["state"] = lbfgs_fixed_step_lanes(g, box["state"], 0.01)
        return x + upd, [1] * n, upd
    return step, box


def lane_alone(warm, i, fusion="off"):
    """Lane i of the warm-up state as a single run's net on the card:
    (x, flat_objective's value_and_grad) with the one-lane signature."""
    from tpusr_torch.engine import dip
    from tpusr_torch.engine.lbfgs import one_lane

    cfg = dip.DIPConfig(conv_fusion=fusion)
    net = dip.build(cfg, torch.Generator().manual_seed(i))[0]
    net.to("cuda", memory_format=torch.channels_last)
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(warm["params"][k][i])
    x, vg = dip.flat_objective(net, warm["down"], list(net.parameters()),
                               warm["z"][i], warm["lrs"][i])
    return x[None], one_lane(vg)


def check_lbfgs_lane_step(search, warm):
    """Phase 10e (i): from the warm-up state, one L-BFGS iteration of the
    lanes batched against each lane alone (the lane objective over that
    lane only, phase 10c's sense): the same trial counts per lane, and the
    update (new minus old parameters) within LBFGS_STEP_REL in relative L2
    (so the new parameters too). Printed beside it, not held: the same
    iteration through the single run's own net (flat_objective on a
    channels_last net, other conv algorithms), whose gradient can part by
    more at a trained state (a tiny net on a CPU: 1.4e-3)."""
    from tpusr_torch.engine import dip

    n = warm["z"].shape[0]
    x, vg = dip.lane_objective(warm["template"], warm["down"],
                               dict(warm["params"]), warm["z"], warm["lrs"])
    step, _ = lbfgs_steppers(search, n, x.shape[1])
    x1, counts, upd = step(x, vg)
    row = {"trials": counts, "alone": [], "rel": [], "params_rel": [],
           "single": [], "single_rel": []}

    def apart(d, db):
        d, db = d.double(), db.double()
        return float((d - db).norm() / db.norm())

    for i in range(n):
        step_i, _ = lbfgs_steppers(search, 1, x.shape[1])
        xi1, ci, upd_i = step_i(x[i:i + 1],
                                lambda xs, lanes, i=i: vg(xs, [i]))
        row["alone"] += ci
        row["rel"].append(apart(upd[i], upd_i[0]))
        row["params_rel"].append(apart(x1[i], xi1[0]))
        xs, one = lane_alone(warm, i)
        if not torch.equal(xs[0], x[i]):
            raise AssertionError(f"lane {i}: the flat vectors differ")
        step_s, _ = lbfgs_steppers(search, 1, x.shape[1])
        _, cs, upd_s = step_s(xs, one)
        row["single"] += cs
        row["single_rel"].append(apart(upd[i], upd_s[0]))
    print(f"phase 10e: one L-BFGS {search} iteration from the warm-up state, "
          f"lanes batched against each lane alone: trial counts "
          f"{counts} / {row['alone']}, update apart (rel. L2) {row['rel']}, "
          f"new parameters {row['params_rel']}; against the single run's "
          f"net: trial counts {row['single']}, update {row['single_rel']}")
    if counts != row["alone"] or not max(row["rel"]) < LBFGS_STEP_REL:
        raise AssertionError(f"L-BFGS {search} lanes differ from each lane "
                             f"alone: {row}")
    return row


def time_lbfgs_lanes(search, warm, iters=5, warmup=1):
    """Phase 10e (iv): ms per L-BFGS iteration per image from the warm-up
    state: the lanes batched against the loop of
    dip_superresolve_scan_bucketed (one image's iteration after the other,
    conv_fusion 'auto' as the default config runs it: kernels A and B);
    CUDA events over ``iters`` after ``warmup``, in ABBA order. Beside
    them, the batched value-and-gradient calls per iteration and each
    lane's own evaluations per iteration."""
    from tpusr_torch.engine import dip

    n = warm["z"].shape[0]
    x, vg = dip.lane_objective(warm["template"], warm["down"],
                               dict(warm["params"]), warm["z"], warm["lrs"])
    step, opt = lbfgs_steppers(search, n, x.shape[1])
    box = {"x": x}

    def lanes():
        box["x"] = step(box["x"], vg)[0]

    singles = []
    for i in range(n):
        xi, one = lane_alone(warm, i, "auto")
        singles.append([xi, one, *lbfgs_steppers(search, 1, xi.shape[1])])

    def loop():
        for s in singles:
            s[0] = s[2](s[0], s[1])[0]

    times = {"lanes": [], "loop": []}
    for k in ("lanes", "loop", "loop", "lanes"):
        times[k].append(time_ms(lanes if k == "lanes" else loop, iters,
                                warmup) / n)
    done = 2 * (iters + warmup)
    row = {k: sum(v) / 2 for k, v in times.items()}
    if search == "zoom":
        row["calls_per_iteration"] = opt.calls / done
        row["lane_evals_per_iteration"] = [e / done for e in opt.evals]
        row["loop_evals_per_iteration"] = [s[3].evals[0] / done
                                           for s in singles]
    else:
        row["calls_per_iteration"] = 1.0
        row["lane_evals_per_iteration"] = [1.0] * n
    print(f"phase 10e: L-BFGS {search} ms per iteration per image (CUDA "
          f"events, {iters} after {warmup}, ABBA): lanes {row['lanes']:.3f} "
          f"({times['lanes']}), loop (auto) {row['loop']:.3f} "
          f"({times['loop']}), {row['lanes'] / row['loop']:.3f}x; batched "
          f"calls per iteration {row['calls_per_iteration']:.3f}, each "
          f"lane's evaluations per iteration "
          f"{row['lane_evals_per_iteration']}"
          + (f", the loop's {row['loop_evals_per_iteration']}"
             if search == "zoom" else ""))
    return row


def run_lbfgs_lanes():
    """Phase 10e: the lane batch with L-BFGS 'fixed' and 'zoom' at full
    width, f32, TF32 off (cuDNN's and cuBLAS's)."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    paths, rows = {}, {}
    try:
        for search in ("fixed", "zoom"):
            counts, _, warm = run_lbfgs_lane_batch(search)
            paths[f"dip lanes lbfgs {search}"] = counts
            rows[search] = dict(step=check_lbfgs_lane_step(search, warm),
                                **time_lbfgs_lanes(search, warm))
            del warm
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return paths, rows


def run_multi_device():
    """Phase 10: the native loader, NCCL at world size 1, two processes on
    the card, the lane-batch times, the L-BFGS lanes."""
    native_status, _ = check_native_loader()
    dp1, dp1_rows = check_dp_world1()
    shard, dp2, shard_times = run_shared_card()
    lanes = time_lanes()
    t0 = time.perf_counter()
    lbfgs_paths, lbfgs_rows = run_lbfgs_lanes()
    print(f"phase 10e: L-BFGS lanes in {time.perf_counter() - t0:.1f} s")
    paths = {"srgan eval sharded": shard,
             "srgan train dp": {k: dp1[k] + dp2[k] for k in dp1},
             **lbfgs_paths}
    return paths, dict(native=native_status, dp_w1=dp1_rows,
                       shard=shard_times, lanes=lanes, lbfgs=lbfgs_rows)


# ------------------------------------------------------------ checkpoints
CKPT_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "data", "orbax_tpusr_small")
CKPT_FIXTURE_SEED = 20261017


def ckpt_fixture_tree():
    """The leaves of the committed tpusr-written checkpoint
    (tests/data/orbax_tpusr_small), from its seed; bf16 as its uint16 bits.
    A copy of tests/test_torch_orbax.py's fixture_tree."""
    rng = np.random.default_rng(CKPT_FIXTURE_SEED)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": (rng.standard_normal(40).astype(np.float32).view(
            np.uint32) >> 16).astype(np.uint16),
        "i32": rng.integers(-2**31, 2**31 - 1, (4, 4), dtype=np.int32),
        "step": np.asarray(rng.integers(0, 1000), np.int32),
        "nested": {"ramp": (np.arange(8192) % 61).astype(np.float32),
                   "pair": [rng.standard_normal(4).astype(np.float32),
                            rng.standard_normal((2, 3)).astype(np.float32)]},
        "random": rng.standard_normal(32768).astype(np.float32),
    }


def leaf_bits(t):
    """A CPU tensor's bytes (bf16 through its int16 view)."""
    t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return t.contiguous().numpy().reshape(-1).view(np.uint8)


def tree_mismatch(a, b, where=""):
    """The first place where two trees of CPU tensors (dicts, lists, None)
    differ in structure, shape, dtype or bits; None when they are equal."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            return f"{where}: keys"
        return next((m for k in b for m in [tree_mismatch(
            a[k], b[k], f"{where}/{k}")] if m), None)
    if isinstance(b, (list, tuple)):
        if not isinstance(a, (list, tuple)) or len(a) != len(b):
            return f"{where}: length"
        return next((m for i, (x, y) in enumerate(zip(a, b)) for m in [
            tree_mismatch(x, y, f"{where}/{i}")] if m), None)
    if b is None:
        return None if a is None else f"{where}: not None"
    if a.shape != b.shape or a.dtype != b.dtype:
        return (f"{where}: {a.dtype}{tuple(a.shape)} vs "
                f"{b.dtype}{tuple(b.shape)}")
    return None if np.array_equal(leaf_bits(a), leaf_bits(b)) else \
        f"{where}: values"


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def timed_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_ckpt_round_trip(root, cfg):
    """Phase 11a: the full-width gan_train state (seed 0) after 2 steps,
    written by save_train_state and read into a fresh state: every leaf,
    moment and the step bit-equal; bytes, seconds and MB/s beside
    torch.save / torch.load of the same tree. Returns (state, dir)."""
    from tpusr_torch.engine.gan import gan_train_step
    from tpusr_torch.io.checkpoint import load_train_state, save_train_state
    from tpusr_torch.io.weights import (export_flax_gan_state,
                                        load_flax_gan_state)

    state = gan_state(cfg)
    with exact_convs():
        for seed in (0, 1):
            gan_train_step(state, *train_batch(seed), cfg)
    ckpt = os.path.join(root, "ckpt_epoch1")
    _, w_s = timed_s(lambda: save_train_state(ckpt, state))
    back, r_s = timed_s(lambda: load_train_state(ckpt, gan_state(cfg)))
    want = export_flax_gan_state(state)
    bad = tree_mismatch(export_flax_gan_state(back), want)
    if bad or back.step != state.step or state.step != 2:
        raise AssertionError(f"orbax round trip differs at {bad} (step "
                             f"{back.step} vs {state.step})")
    pt = os.path.join(root, "state.pt")
    _, tw_s = timed_s(lambda: torch.save(export_flax_gan_state(state), pt))
    _, tr_s = timed_s(lambda: load_flax_gan_state(
        gan_state(cfg), torch.load(pt, weights_only=True)))
    nb, tb = dir_bytes(ckpt), os.path.getsize(pt)
    leaves = sum(1 for d, _, fs in os.walk(ckpt) if ".zarray" in fs)
    print(f"phase 11a: full-width gan_train state (16 blocks, D at 192^2, "
          f"bf16 D state, step {state.step}) through save_train_state / "
          f"load_train_state bit-equal ({leaves} leaves); orbax directory "
          f"{nb} bytes, write {w_s:.3f} s ({nb / w_s / 1e6:.1f} MB/s), read "
          f"{r_s:.3f} s ({nb / r_s / 1e6:.1f} MB/s); torch.save / torch.load "
          f"of the same tree {tb} bytes, write {tw_s:.3f} s "
          f"({tb / tw_s / 1e6:.1f} MB/s), read {tr_s:.3f} s "
          f"({tb / tr_s / 1e6:.1f} MB/s) (host clock, export and restore "
          f"into the card's state included)")
    return state, ckpt, dict(bytes=nb, write_s=w_s, read_s=r_s,
                             torch_bytes=tb, torch_write_s=tw_s,
                             torch_read_s=tr_s)


def check_ckpt_resumed_step(state, ckpt, cfg):
    """Phase 11b: one step from the restored state against one from the
    in-memory state, on the same batch (cuDNN deterministic, TF32 off):
    the losses bit-equal, or within the spread of two steps from two
    restores of the same directory; 72 A and 36 B launches each."""
    from tpusr_torch.engine.gan import gan_train_step
    from tpusr_torch.io.checkpoint import load_train_state

    batch = train_batch(2)
    runs = {}
    with exact_convs():
        for name in ("memory", "restored", "restored again"):
            st = state if name == "memory" else load_train_state(
                ckpt, gan_state(cfg))
            reset_counts()
            _, logs = gan_train_step(st, *batch, cfg)
            torch.cuda.synchronize()
            counts = read_counts()
            if (counts["fused_conv3x3_fwd"], counts["fused_conv3x3_wgrad"]
                    ) != (72, 36):
                raise AssertionError(f"resumed step launches {counts}")
            runs[name] = (float(logs["loss_D"]), float(logs["loss_G"]))
            del st
    diff = max(abs(a - b) for a, b in zip(runs["memory"], runs["restored"]))
    spread = max(abs(a - b) for a, b in zip(runs["restored"],
                                            runs["restored again"]))
    print(f"phase 11b: one step from the restored state: losses (D, G) "
          f"{runs['restored']} against {runs['memory']} from the in-memory "
          f"state ({'bit-equal' if diff == 0 else f'{diff:.3e} apart'}); "
          f"two restores apart by {spread:.3e}; 72 A and 36 B launches each")
    if diff > spread:
        raise AssertionError(f"resumed step's losses {runs}")
    return counts


def check_ckpt_eval(g_state, ckpt):
    """Phase 11c: the eval CLI with --model_path the orbax directory on the
    phase-5 synthetic tree: 36 A launches per image, its PNGs and metrics
    bit-equal to the .pth route of the same G (``g_state``, the written
    state's G)."""
    from PIL import Image
    from tpusr_torch.cli import eval_gan
    from tpusr_torch.io.checkpoint import (export_torch_generator,
                                           save_torch_pth)

    with tempfile.TemporaryDirectory() as root:
        write_valid_tree(root)
        pth = os.path.join(root, "trained_G.pth")
        save_torch_pth(export_torch_generator(g_state, 16, 3), pth)
        outs = {}
        with exact_convs():
            for name, model in (("orbax", ckpt), ("pth", pth)):
                out = os.path.join(root, f"out_{name}")
                os.makedirs(out)
                reset_counts()
                metrics = eval_gan.run([
                    "--data_dir", root, "--out_dir", out, "--model_path",
                    model, "--save_images", "True", "--device", "cuda"])
                torch.cuda.synchronize()
                counts = read_counts()
                (stamp,) = os.listdir(os.path.join(out, "out", "GANx8"))
                img_dir = os.path.join(out, "out", "GANx8", stamp, "images")
                outs[name] = (metrics, counts, {
                    f: np.asarray(Image.open(os.path.join(img_dir, f)))
                    for f in sorted(os.listdir(img_dir))})
    (m_o, c_o, img_o), (m_p, _, img_p) = outs["orbax"], outs["pth"]
    if c_o != {**{k: 0 for k in c_o}, "fused_conv3x3_fwd": 72}:
        raise AssertionError(f"eval from the orbax directory launched "
                             f"{c_o}")
    same = (set(img_o) == set(img_p) == {"0801.png", "0802.png"}
            and all(np.array_equal(img_o[f], img_p[f]) for f in img_o)
            and all(m_o[k] == m_p[k] for k in ("avg_psnr", "avg_ssim")))
    print(f"phase 11c: eval CLI from the orbax directory: avg_psnr "
          f"{m_o['avg_psnr']!r} avg_ssim {m_o['avg_ssim']!r}, .pth route "
          f"{m_p['avg_psnr']!r} {m_p['avg_ssim']!r}; PNGs "
          f"{'bit-equal' if same else 'DIFFER'}; launches {c_o}")
    if not same:
        raise AssertionError("eval from the orbax directory differs from "
                             "the .pth route")
    return c_o


def check_ckpt_fixture():
    """Phase 11d: the committed tpusr-written checkpoint (OCDBT, zstd-
    compressed nodes and chunks) decoded by the port's own zstd, OCDBT and
    zarr code on this host: every leaf equals its seed's values."""
    from tpusr_torch.io.orbax import read_tree
    from tpusr_torch.native import zstd

    got, secs = timed_s(lambda: read_tree(CKPT_FIXTURE))
    want = ckpt_fixture_tree()
    flat = [(("bf16",), got["bf16"], want["bf16"])]
    for path in (("f32",), ("i32",), ("step",), ("random",),
                 ("nested", "ramp"), ("nested", "pair", 0),
                 ("nested", "pair", 1)):
        a, b = got, want
        for k in path:
            a, b = a[k], b[k]
        flat.append((path, a, b))
    for path, a, b in flat:
        bits = leaf_bits(a)
        if a.shape != b.shape or not np.array_equal(
                bits, np.ascontiguousarray(b).reshape(-1).view(np.uint8)):
            raise AssertionError(f"fixture leaf {path} differs")
    print(f"phase 11d: the tpusr-written fixture ({dir_bytes(CKPT_FIXTURE)} "
          f"bytes, OCDBT + zstd) decoded on the host by the port's own "
          f"zstd ({os.path.basename(zstd._load()._name)}), {len(flat)} "
          f"leaves equal to their seed's values, in {secs:.3f} s")


def run_checkpoints():
    """Phase 11: tpusr's orbax checkpoint directories in the port."""
    import dataclasses
    from tpusr_torch.engine.gan import GANTrainConfig

    cfg = dataclasses.replace(GANTrainConfig(dtype="bfloat16"),
                              g_fuse="train")  # bench.py's gan_train
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        state, ckpt, row = check_ckpt_round_trip(root, cfg)
        g_state = {k: v.clone() for k, v in state.G.state_dict().items()}
        paths["srgan train resumed"] = check_ckpt_resumed_step(state, ckpt,
                                                               cfg)
        paths["srgan eval orbax"] = check_ckpt_eval(g_state, ckpt)
        del state
        torch.cuda.empty_cache()
    check_ckpt_fixture()
    return paths, row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--train-cli-child"]:
        train_cli_child(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--collective-child"]:
        collective_child()
        return 0
    from tpusr_torch.cli import dip as cli
    from tpusr_torch.ops import _build
    from tpusr_torch.ops import fused_conv as fc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    secs = _build.build_all(verbose=True)
    print(f"phase 1: kernels built in {secs:.2f} s")

    worst = check_kernels(fc)
    rrdb_worst = check_rrdb_kernels()
    worst["dense_block"] = rrdb_worst["dense_block"]
    train_worst = check_train_kernels()
    dp_worst = check_train_kernels(DP_TRAIN_SHAPES)
    worst["fused_conv3x3_fwd"] = max(worst["fused_conv3x3_fwd"],
                                     rrdb_worst["fused_conv3x3_fwd"],
                                     check_srgan_kernels(),
                                     check_srgan_kernels(SHARD_A_SHAPES,
                                                         "2-shard slab"),
                                     train_worst["fused_conv3x3_fwd"],
                                     dp_worst["fused_conv3x3_fwd"])
    worst["fused_conv3x3_wgrad"] = max(worst["fused_conv3x3_wgrad"],
                                       train_worst["fused_conv3x3_wgrad"],
                                       dp_worst["fused_conv3x3_wgrad"])
    worst.update(check_degrade_kernels())
    worst.update(check_bn_act_kernels())
    worst["window_attention"] = check_window_attention()
    worst["token_gemm"] = check_token_gemm()  # bf16, max relative
    print(f"phase 2: kernels agree with their plain versions; largest f32 "
          f"abs errors {worst}")

    paths = {}
    check_fused_net()
    with tempfile.TemporaryDirectory() as root:
        write_pair(root)
        paths["dip float32"] = run_main_path(cli, root, "float32", 100, 25)
        paths["dip bfloat16"] = run_main_path(cli, root, "bfloat16", 25, 5)
    print("phase 3: DIP main path ran through the kernels")
    for dtype, fusion in (("float32", "auto"), ("float32", "off"),
                          ("bfloat16", "auto")):
        profile_iteration(dtype, fusion)

    check_rrdb_net()
    for dtype in (None, torch.bfloat16):
        name = "float32" if dtype is None else "bfloat16"
        paths[f"rrdb {name}"] = run_rrdb_main_path(dtype)
    print("phase 4: RRDB main path ran through the kernels")
    check_swinir_net()
    for dtype in (None, torch.bfloat16):
        name = "float32" if dtype is None else "bfloat16"
        paths[f"swinir {name}"] = run_swinir_main_path(dtype)
    print("phase 4: SwinIR main path ran through the window kernel and "
          "kernel A")

    check_generator_net()
    with tempfile.TemporaryDirectory() as root:
        pth = write_valid_tree(root)
        for dtype in ("float32", "bfloat16"):
            paths[f"srgan eval {dtype}"] = run_eval_main_path(root, pth,
                                                              dtype)
    print("phase 5: SRGAN eval main path ran through kernel A")
    for dtype in (None, torch.bfloat16):
        time_generator(dtype)

    paths["degrade"] = run_degrade_path()
    print("phase 6: degradation path ran through kernels D and E")

    down = time_kernels(fc, "down0_conv2", 256, "leaky_relu", False)
    up = time_kernels(fc, "up0_conv", 512, None, True)
    timed = {k: dict(up[k][torch.float32],
                     bfloat16=up[k][torch.bfloat16],
                     down0_conv2={str(d)[6:]: r for d, r in down[k].items()})
             for k in up}
    rrdb_timed = time_rrdb_kernels()
    timed["dense_block"] = dict(
        rrdb_timed[("dense_block", torch.float32)],
        shape="(1, 270, 480, 64), f32",
        bfloat16=rrdb_timed[("dense_block", torch.bfloat16)])
    timed["fused_conv3x3_fwd"]["rrdb"] = {
        "shape": "(1, 1080, 1920, 64) -> 64, zero pad",
        "float32": rrdb_timed[("fused_conv3x3_fwd", torch.float32)],
        "bfloat16": rrdb_timed[("fused_conv3x3_fwd", torch.bfloat16)]}
    srgan_timed = time_srgan_kernel_a()
    timed["fused_conv3x3_fwd"]["srgan"] = {
        f"{shape} -> {cout}, zero pad, {str(dtype)[6:]}": row
        for (shape, cout, dtype), row in srgan_timed.items()}
    train_timed = time_train_kernels()
    for k, rows in train_timed.items():
        timed[k]["srgan_train"] = rows
    timed.update(time_degrade_kernels())
    bn_timed = time_bn_act_kernels()
    for k, rows in bn_timed.items():
        timed[k] = dict(rows["float32"], bfloat16=rows["bfloat16"])
    timed["partials_sum"] = {"shape": "timed inside channel_moments and "
                                      "affine_act_grad"}
    wa_timed = time_window_attention()
    timed["window_attention"] = dict(wa_timed["float32"],
                                     bfloat16=wa_timed["bfloat16"])
    tg_timed = time_token_gemm()
    timed["token_gemm"] = dict(tg_timed["qkv"], proj=tg_timed["proj"],
                               fc1=tg_timed["fc1"], fc2=tg_timed["fc2"])
    time_swinir_kernel_a()
    print("phase 7: timed (the record below is at up0_conv, 512^2, for A "
          "and B, at (1, 270, 480, 64) for C, at the DIV2K HR frame for D "
          "and E, at up0's (1, 512, 512, 128) for the BatchNorm glue, at "
          "SwinIR-M's qkv (1, 272 * 480, 540) for the window kernel, at "
          "the frame's four products for the token GEMM)")

    import dataclasses
    from tpusr_torch.engine.gan import GANTrainConfig

    check_train_generator()
    with tempfile.TemporaryDirectory() as root:
        write_train_tree(root)
        paths.update(run_train_main_paths(root))
    print("phase 8: SRGAN training main path ran, through kernels A and B "
          "under g_fuse=train")
    bench_cfg = GANTrainConfig(dtype="bfloat16")  # bench.py:313
    train_rows = {
        "bf16 g_fuse=eval": bench_cfg,
        "bf16 g_fuse=train": dataclasses.replace(bench_cfg, g_fuse="train"),
        "f32 g_fuse=eval": dataclasses.replace(bench_cfg, dtype=None),
        "f32 g_fuse=train": dataclasses.replace(bench_cfg, dtype=None,
                                                g_fuse="train")}
    for label, cfg in train_rows.items():
        time_gan_train(label, cfg)
    for label, cfg in train_rows.items():
        profile_train_step(label, cfg)

    from tpusr_torch.engine import dip as dip_engine

    with tempfile.TemporaryDirectory() as square, \
            tempfile.TemporaryDirectory() as ragged:
        write_pair(square)
        write_ragged_tree(ragged)
        for label, flags, num_iter, log_freq, tree in VARIANT_ROWS:
            paths[label] = run_variant(
                cli, dip_engine, square if tree == "square" else ragged,
                label, flags, num_iter, log_freq)
    time_variants()
    paths["srgan eval tiled"], _ = check_tiled_eval()
    print("phase 9: DIP variants and tiled eval ran through kernels A and B")

    t10 = time.perf_counter()
    multi, _ = run_multi_device()
    paths.update(multi)
    print(f"phase 10: multi-device paths ran (sharded eval through kernel "
          f"A, data-parallel training through A and B) in "
          f"{time.perf_counter() - t10:.1f} s")

    t11 = time.perf_counter()
    ckpt_paths, _ = run_checkpoints()
    paths.update(ckpt_paths)
    print(f"phase 11: orbax checkpoints written, read and resumed (the "
          f"resumed step through A and B, eval from the directory through "
          f"A) in {time.perf_counter() - t11:.1f} s")

    replaces = {"fused_conv3x3_fwd": "tpusr/ops/pallas_conv.py:72",
                "fused_conv3x3_wgrad": "tpusr/ops/pallas_conv.py:297",
                "dense_block": "tpusr/ops/pallas_dense.py:103",
                "fused_add_gaussian_noise": "tpusr/ops/pallas_degrade.py:38",
                "fused_add_salt_pepper_noise":
                    "tpusr/ops/pallas_degrade.py:52",
                **{k: "none: XLA fuses tpusr's BatchNorm glue" for k in BN_ACT},
                "window_attention": "none: tpusr has no transformer",
                "token_gemm": "none: tpusr has no transformer"}
    sources = {"fused_conv3x3_fwd": "tpusr_torch/csrc/fused_conv3x3.cu",
               "fused_conv3x3_wgrad": "tpusr_torch/csrc/fused_conv3x3.cu",
               "dense_block": "tpusr_torch/csrc/dense_block.cu",
               "fused_add_gaussian_noise": "tpusr_torch/csrc/degrade.cu",
               "fused_add_salt_pepper_noise": "tpusr_torch/csrc/degrade.cu",
               **{k: "tpusr_torch/csrc/bn_act.cu" for k in BN_ACT},
               "window_attention": "tpusr_torch/csrc/window_attention.cu",
               "token_gemm": "tpusr_torch/csrc/token_gemm.cu"}
    designs = {
        "fused_conv3x3_fwd": "wgmma bf16 (m64nNk16, N 64/128, 16x16-pixel "
                             "tile, 9 taps as descriptors into one staged "
                             "window) / 3xTF32 mma.sync f32",
        "fused_conv3x3_wgrad": "wgmma bf16 (dw_t = window^T G, one warpgroup "
                               "per kernel row, split-K row slices) / 3xTF32 "
                               "mma.sync f32",
        "dense_block": "bf16 warp-specialised on wgmma (16x16 tile): a "
                       "producer warp streams 120 weight units (one per "
                       "stage, chunk and kernel row) by bulk async copies "
                       "into a 5-slot ring behind full/empty mbarriers; two "
                       "consumer warpgroups, m64n32k16 for c1..c4 and one "
                       "m64n64k16 for y, A from shared memory (c1, y: 8x8 "
                       "pixel blocks) or ldmatrix registers (c2..c4) / f32 "
                       "3xTF32 mma.sync (8x8 tile, cp.async weight ring); "
                       "halo recompute, every stage on its region, x and "
                       "c1..c4 in shared memory in the dtype",
        "fused_add_gaussian_noise": "Philox4x32-10 in the kernel, one thread "
                                    "per element pair",
        "fused_add_salt_pepper_noise": "Philox4x32-10 in the kernel, one "
                                       "thread per pixel",
        **{k: "one pass over NHWC, a thread owning 16 bytes of channels for "
              "the launch, UNROLL pixels in flight; block partials in a fixed "
              "tree, summed by partials_sum" for k in BN_ACT},
        "window_attention": "one block a window: mma.sync m16n8k16 bf16 (P "
                            "kept in registers) / 3xTF32 m16n8k8 f32 (P "
                            "through shared memory), head dimension padded "
                            "to 32, softmax in f32 registers; the cyclic "
                            "shift, the relative-position bias and the "
                            "shifted-window mask in its addressing, tokens "
                            "read and written in image order",
        "token_gemm": "persistent blocks, each with one slice of N's packed "
                      "weights resident in shared memory; wgmma m64n96k16 "
                      "bf16, A from registers, each 64-row tile of x "
                      "brought in by one bulk copy into a ring; bias, "
                      "residual and erff GELU on the f32 accumulator, one "
                      "rounding to bf16, stores staged in shared memory "
                      "(qkv at the top, proj, fc1, fc2 nested)"}
    record = {"kernels": [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k],
             design=designs[k],
             launches=sum(c.get(k, 0) for c in paths.values()),
             launches_by_path={p: c.get(k, 0) for p, c in paths.items()},
             max_abs_err=worst[k], **timed[k]) for k in replaces]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
