"""Smoke run of tpusr_torch on one NVIDIA GPU: kernels, main paths, times.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. build the CUDA kernels from tpusr_torch/csrc (one nvcc per source, in
     parallel, sm_90a): A and B (fused_conv3x3.cu), C (dense_block.cu);
  2. hold each kernel against its plain PyTorch version at its main path's
     shapes: f32 kernels against the plain version in f64 (max relative
     error 1e-4), bf16 ones against it in bf16 (2e-2). A and B at the DIP
     shapes; C (tpusr/ops/pallas_dense.py:103) at the RRDB trunk's
     (1, 270, 480, 64) and at ragged shapes; A in the RRDB configuration
     (zero pad, no prologue, 64 -> 64) at 270 x 480, 540 x 960 and
     1080 x 1920;
  3. DIP: check the whole fused net against the unfused one (in f64) on a
     128^2 input, then drive the main path, ``tpusr_torch.cli.dip.main``,
     at full width (input 32, 128 channels, 5 scales, x8) on a synthetic
     DIV2K-layout pair (512^2 HR canvas): 100 f32 iterations and a short
     bf16 run, with the kernels' launch counts read around each run; then
     the time of one iteration and a torch.profiler breakdown of it;
  4. RRDB: the full-width RRDBNet (nf 64, nb 23, gc 32, x4), fused in f32
     against unfused in f64 on a 27 x 45 input (ragged tiles at every
     scale); then bench.py's rrdb
     workload, ``RRDBNet(scale=4, dtype=...).forward`` under
     inference_mode on a 270 x 480 LR frame (1080 x 1920 out), in f32 and
     bf16: 69 kernel-C and 4 kernel-A launches per frame, the frame time
     (fused and unfused) and a torch.profiler breakdown of one frame;
  5. time each kernel, its plain version and the PyTorch calls computing
     the same function, beside the least time the card could take.
The line before the last holds the kernels' JSON record, the last line
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

RATE = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM peaks
MEM_BW = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
C = 128  # DIP skip-net width
LR_RRDB = (270, 480)  # bench.py's rrdb workload: a 1080 x 1920 frame at x4


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

    fc.reset_launch_counts()
    db.reset_launch_counts()


def read_counts():
    from tpusr_torch.ops import dense_block as db
    from tpusr_torch.ops import fused_conv as fc

    return {**fc.LAUNCHES, **db.LAUNCHES}


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


def profile_window(fn, iters):
    """torch.profiler over ``iters`` calls of fn: the device operations,
    most device time first, and the device's busy ms per call."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # user annotations (the optimizer's record_function range) also sit on
    # the device timeline; counting them would count their kernels twice
    kernels = [e for e in prof.key_averages()
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
    idle share, and the kernels that take the most device time."""
    step = dip_step(dtype, fusion)
    ms = time_ms(step, 30, warmup=5)
    kernels, busy = profile_window(step, iters)
    ops = sum(e.count for e in kernels) // iters
    print(f"DIP iteration at 512^2 x8, full width, {dtype}, conv_fusion="
          f"{fusion}: {ms:.3f} ms per iteration (CUDA events); kernels "
          f"busy {busy:.3f} ms of it, idle share {1 - busy / ms:.3f}, "
          f"{ops} device operations per iteration")
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

            for shape in ((1, h, w), (1, 7, 9), (1, 13, 70), (2, 16, 20)):
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
            # leave a ragged last row of 8 x 16 tiles
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
    # 27 x 45, 54 x 90, 108 x 180: no side a multiple of kernel A's 8 x 16
    # tile or kernel C's 8 x 8 one
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
        kernels, busy = profile_window(lambda: net(lr), 1)
        off = rrdb_net(dtype, "off")
        ms_off = time_ms(lambda: off(lr), 3, warmup=1)
        del off
    groups = {"kernel C": "dense_block_kernel", "kernel A": "fwd_kernel"}
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
    t_ops, t_bytes = flops / RATE[dtype], nbytes / MEM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def measure(label, kern, plain, lib, flops, nbytes, dtype):
    """Kernel, plain version and library times (CUDA events, 20 calls after
    3 warm-up ones) beside the bound; ``lib`` may be None."""
    ms, plain_ms = time_ms(kern), time_ms(plain)
    lib_ms = None if lib is None else time_ms(lib)
    bms, by = bound(flops, nbytes, dtype)
    lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"time {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib_txt}, bound {bms:.4f} ms ({by}), "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by)


def time_kernels(fc, name, size, act, has_base):
    """Phase 5 at one DIP shape, f32: kernel, plain, library and bound."""
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.float32
    o = operands(size, act, has_base, dtype,
                 torch.Generator(device="cuda").manual_seed(2))
    x, w, es, eb, base, g = (o[k] for k in ("x", "w", "es", "eb", "base",
                                            "g"))
    isz = x.element_size()
    flops = 2 * 9 * C * C * size * size
    act_bytes = size * size * C * isz
    xn = x.permute(0, 3, 1, 2)
    gn = g.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    rows = {}
    ops = {
        "fused_conv3x3_fwd": (
            lambda: fc.fused_conv3x3_fwd(x, w, es, eb, base, act=act,
                                         reflect=True, stats=True),
            lambda: fc.fused_conv3x3_fwd_reference(x, w, es, eb, base,
                                                   act=act, reflect=True,
                                                   stats=True),
            lambda: F.conv2d(xn, w_oihw, padding=1),
            # x, base read; y written; w, es/eb read; stats written
            act_bytes * (3 if has_base else 2) + w.numel() * isz
            + 2 * C * 4 + 2 * C * 4),
        "fused_conv3x3_wgrad": (
            lambda: fc.fused_conv3x3_wgrad(x, g, es, eb, act=act,
                                           reflect=True),
            lambda: fc.fused_conv3x3_wgrad_reference(x, g, es, eb, act=act,
                                                     reflect=True),
            lambda: torch.nn.grad.conv2d_weight(xn, w_oihw.shape, gn,
                                                padding=1),
            # x, G, es/eb read; dw (f32) written
            act_bytes * 2 + 2 * C * 4 + w.numel() * 4),
    }
    for kname, (kern, plain, lib, nbytes) in ops.items():
        rows[kname] = measure(f"{kname} at {name} ({size}^2, {C}->{C}, f32)",
                              kern, plain, lib, flops, nbytes, dtype)
        rows[kname]["shape"] = f"{name}: (1, {size}, {size}, {C}) -> {C}"
    torch.backends.cudnn.allow_tf32 = True
    return rows


def time_rrdb_kernels():
    """Phase 5, RRDB, in f32 and bf16: kernel C at (1, 270, 480, 64), with
    the five cuDNN convs of one block as its library time (no single
    PyTorch call computes a dense block); kernel A at 1080 x 1920, 64 ->
    64, zero pad, against one cuDNN conv."""
    from tpusr_torch.ops import dense_block as db
    from tpusr_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    h, w = LR_RRDB
    rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            x, ks, bs = rrdb_operands((1, h, w), dtype, gen)
            parts = [x.permute(0, 3, 1, 2)] + [
                torch.randn(1, h, w, db.GC, generator=gen, device="cuda")
                .to(dtype).permute(0, 3, 1, 2) for _ in range(4)]
            cats = [torch.cat(parts[:i + 1], 1) for i in range(5)]
            w_oihw = [k.to(dtype).permute(3, 2, 0, 1).contiguous()
                      for k in ks]
            b_lib = [b.to(dtype) for b in bs]
            flops = 2 * 239_616 * h * w
            # x read, y written, f32 kernels and biases read once
            nbytes = 2 * x.numel() * x.element_size() + 4 * sum(
                t.numel() for t in ks + bs)
            row = measure(
                f"dense_block at (1, {h}, {w}, 64), {name}",
                lambda: db.dense_block(x, ks, bs),
                lambda: db.dense_block_reference(x, ks, bs), None,
                flops, nbytes, dtype)
            row["library_five_convs_ms"] = time_ms(lambda: [
                F.conv2d(c, k, b, padding=1)
                for c, k, b in zip(cats, w_oihw, b_lib)])
            print(f"  five cuDNN convs of the block: "
                  f"{row['library_five_convs_ms']:.4f} ms")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
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
    worst["fused_conv3x3_fwd"] = max(worst["fused_conv3x3_fwd"],
                                     rrdb_worst["fused_conv3x3_fwd"])
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

    time_kernels(fc, "down0_conv2", 256, "leaky_relu", False)
    timed = time_kernels(fc, "up0_conv", 512, None, True)
    rrdb_timed = time_rrdb_kernels()
    timed["dense_block"] = dict(
        rrdb_timed[("dense_block", torch.float32)],
        shape="(1, 270, 480, 64), f32",
        bfloat16=rrdb_timed[("dense_block", torch.bfloat16)])
    timed["fused_conv3x3_fwd"]["rrdb"] = {
        "shape": "(1, 1080, 1920, 64) -> 64, zero pad",
        "float32": rrdb_timed[("fused_conv3x3_fwd", torch.float32)],
        "bfloat16": rrdb_timed[("fused_conv3x3_fwd", torch.bfloat16)]}
    print("phase 5: timed (the record below is at up0_conv, 512^2, for A "
          "and B, at (1, 270, 480, 64) for C)")

    replaces = {"fused_conv3x3_fwd": "tpusr/ops/pallas_conv.py:72",
                "fused_conv3x3_wgrad": "tpusr/ops/pallas_conv.py:297",
                "dense_block": "tpusr/ops/pallas_dense.py:103"}
    sources = {"fused_conv3x3_fwd": "tpusr_torch/csrc/fused_conv3x3.cu",
               "fused_conv3x3_wgrad": "tpusr_torch/csrc/fused_conv3x3.cu",
               "dense_block": "tpusr_torch/csrc/dense_block.cu"}
    record = {"kernels": [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k],
             launches=sum(c[k] for c in paths.values()),
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
