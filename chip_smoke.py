"""Smoke run of tpusr_torch on one NVIDIA GPU: kernels, main paths, times.

    python3 chip_smoke.py

Kernels A, B and C run on the tensor cores: wgmma in bf16 and 3xTF32
mma.sync in f32 (three TF32 products per f32 product, so the f32 gates
below hold unchanged); D and E as before.

Phases (any failure raises, so the exit code is non-zero):
  1. build the CUDA kernels from tpusr_torch/csrc (one nvcc per source, in
     parallel, sm_90a): A and B (fused_conv3x3.cu), C (dense_block.cu),
     D and E (degrade.cu);
  2. hold each kernel against its plain PyTorch version at its main path's
     shapes: f32 kernels against the plain version in f64 (max relative
     error 1e-4), bf16 ones against it in bf16 (2e-2). A and B at the DIP
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
  3. DIP: check the whole fused net against the unfused one (in f64) on a
     128^2 input, then drive the main path, ``tpusr_torch.cli.dip.main``,
     at full width (input 32, 128 channels, 5 scales, x8) on a synthetic
     DIV2K-layout pair (512^2 HR canvas): 100 f32 iterations and a short
     bf16 run, with the kernels' launch counts read around each run; then
     the time of one iteration and a torch.profiler breakdown of it, whose
     window must record all 20 kernel-A and 10 kernel-B launches of each
     fused iteration;
  4. RRDB: the full-width RRDBNet (nf 64, nb 23, gc 32, x4), fused in f32
     against unfused in f64 on a 27 x 45 input (ragged tiles at every
     scale); then bench.py's rrdb
     workload, ``RRDBNet(scale=4, dtype=...).forward`` under
     inference_mode on a 270 x 480 LR frame (1080 x 1920 out), in f32 and
     bf16: 69 kernel-C and 4 kernel-A launches per frame (the weight units
     of all 69 blocks packed anew in each frame), the frame time (fused and
     unfused) and a torch.profiler breakdown of one frame;
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
     SRGAN training shapes (batch 8) against cuDNN too;
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
# kernel launches of one DIP training iteration: 10 fused convs forward,
# their 10 dgrads (kernel A) and 10 wgrads (kernel B)
DIP_ITER_LAUNCHES = {KERNEL_A: 20, KERNEL_B: 10}
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
    from tpusr_torch.ops import dense_block as db
    from tpusr_torch.ops import fused_conv as fc
    from tpusr_torch.ops import fused_degrade as fd

    fc.reset_launch_counts()
    db.reset_launch_counts()
    fd.reset_launch_counts()


def read_counts():
    from tpusr_torch.ops import dense_block as db
    from tpusr_torch.ops import fused_conv as fc
    from tpusr_torch.ops import fused_degrade as fd

    return {**fc.LAUNCHES, **db.LAUNCHES, **fd.LAUNCHES}


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
            and counts["fused_conv3x3_wgrad"] >= 10 * num_iter):
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
                err = rel_err(y, yr)
                print(f"check dense_block {shape} {str(dtype)[6:]}: "
                      f"{err:.3e}")
                if not err <= TOL[dtype]:
                    raise AssertionError(f"kernel C disagrees with its plain "
                                         f"version at {shape} {dtype}: {err}")
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


def check_srgan_kernels():
    """Phase 2, SRGAN: kernel A in the generator's configuration (zero pad,
    no prologue) at every shape the x8 eval gives it. Returns the largest
    f32 abs error."""
    from tpusr_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            for shape, cout in SRGAN_A_SHAPES:
                x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                wt = ((torch.rand(3, 3, 64, cout, generator=gen,
                                  device="cuda") * 2 - 1) / 24).to(dtype)
                y, _ = fc.fused_conv3x3_fwd(x, wt, reflect=False)
                yr, _ = fc.fused_conv3x3_fwd_reference(
                    x.double() if f32 else x, wt.double() if f32 else wt,
                    reflect=False)
                torch.cuda.synchronize()
                err = rel_err(y, yr)
                print(f"check fused_conv3x3_fwd SRGAN configuration {shape} "
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


def check_train_kernels():
    """Phase 2, SRGAN training: kernel A forward, its dgrad (Cout -> 64,
    Cin = 256 for the 64 -> 256 convs) and kernel B at every shape the
    training G gives them under g_fuse='train' (batch 8, the 24^2 patch
    and its x2 and x4 maps, zero pad, no prologue). Returns the largest
    f32 abs error of each kernel."""
    from tpusr_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"fused_conv3x3_fwd": 0.0, "fused_conv3x3_wgrad": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for shape, cout in TRAIN_A_SHAPES:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--train-cli-child"]:
        train_cli_child(*sys.argv[2:4])
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
    worst["fused_conv3x3_fwd"] = max(worst["fused_conv3x3_fwd"],
                                     rrdb_worst["fused_conv3x3_fwd"],
                                     check_srgan_kernels(),
                                     train_worst["fused_conv3x3_fwd"])
    worst["fused_conv3x3_wgrad"] = max(worst["fused_conv3x3_wgrad"],
                                       train_worst["fused_conv3x3_wgrad"])
    worst.update(check_degrade_kernels())
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
    print("phase 7: timed (the record below is at up0_conv, 512^2, for A "
          "and B, at (1, 270, 480, 64) for C, at the DIV2K HR frame for D "
          "and E)")

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

    replaces = {"fused_conv3x3_fwd": "tpusr/ops/pallas_conv.py:72",
                "fused_conv3x3_wgrad": "tpusr/ops/pallas_conv.py:297",
                "dense_block": "tpusr/ops/pallas_dense.py:103",
                "fused_add_gaussian_noise": "tpusr/ops/pallas_degrade.py:38",
                "fused_add_salt_pepper_noise":
                    "tpusr/ops/pallas_degrade.py:52"}
    sources = {"fused_conv3x3_fwd": "tpusr_torch/csrc/fused_conv3x3.cu",
               "fused_conv3x3_wgrad": "tpusr_torch/csrc/fused_conv3x3.cu",
               "dense_block": "tpusr_torch/csrc/dense_block.cu",
               "fused_add_gaussian_noise": "tpusr_torch/csrc/degrade.cu",
               "fused_add_salt_pepper_noise": "tpusr_torch/csrc/degrade.cu"}
    designs = {
        "fused_conv3x3_fwd": "wgmma bf16 (m64nNk16, N 64/128, 16x16-pixel "
                             "tile, 9 taps as descriptors into one staged "
                             "window) / 3xTF32 mma.sync f32",
        "fused_conv3x3_wgrad": "wgmma bf16 (dw_t = window^T G, one warpgroup "
                               "per kernel row, split-K row slices) / 3xTF32 "
                               "mma.sync f32",
        "dense_block": "wgmma bf16 (m64n32k16, A from ldmatrix registers, "
                       "16x16 tile) / 3xTF32 mma.sync f32 (8x8 tile); "
                       "halo recompute, every stage on its region, x and "
                       "c1..c4 in shared memory in the dtype, packed "
                       "weight units streamed by a cp.async ring",
        "fused_add_gaussian_noise": "Philox4x32-10 in the kernel, one thread "
                                    "per element pair",
        "fused_add_salt_pepper_noise": "Philox4x32-10 in the kernel, one "
                                       "thread per pixel"}
    record = {"kernels": [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k],
             design=designs[k], launches=sum(c[k] for c in paths.values()),
             launches_by_path={p: c[k] for p, c in paths.items()},
             max_abs_err=worst[k], **timed[k]) for k in replaces]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
