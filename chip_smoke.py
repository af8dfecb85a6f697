"""Smoke run of tpusr_torch on one NVIDIA GPU: kernels, main path, times.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. build the CUDA kernels from tpusr_torch/csrc (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version at the DIP main
     path's shapes: f32 kernels against the plain version in f64 (max
     relative error 1e-4), bf16 ones against it in bf16 (2e-2);
  3. check the whole fused net against the unfused one (in f64) on a
     128^2 input, then drive the main path, ``tpusr_torch.cli.dip.main``,
     at full width (input 32, 128 channels, 5 scales, x8) on a synthetic
     DIV2K-layout pair (512^2 HR canvas): 100 f32 iterations and a short
     bf16 run, with the kernels' launch counts read around each run; then
     the time of one iteration and a torch.profiler breakdown of it;
  4. time each kernel, its plain version and one PyTorch call computing the
     same function, beside the least time the card could take.
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


def run_main_path(fc, cli, root, dtype, num_iter, log_freq):
    """Phase 3b: one CLI main() run with the launch counts around it."""
    lr_dir, hr_dir = os.path.join(root, "DIV2K_train_LR_x8"), os.path.join(
        root, "DIV2K_train_HR")
    out_dir = os.path.join(root, f"out_{dtype}")
    config = cli.DIPConfig(factor=8, num_iter=num_iter, log_freq=log_freq,
                           dtype=dtype)
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = cli.main(lr_dir, hr_dir, out_dir, 8, 1, config, True, None,
                       False, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fc.LAUNCHES)
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


def profile_iteration(dtype, fusion, iters=3, top=12):
    """Phase 3c: time per iteration (CUDA events, profiler off), then a
    torch.profiler window: device kernel time per iteration, the device's
    idle share, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    step = dip_step(dtype, fusion)
    ms = time_ms(step, 30, warmup=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    # user annotations (the optimizer's record_function range) also sit on
    # the device timeline; counting them would count their kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / iters / 1e3
    ops = sum(e.count for e in kernels) // iters
    print(f"DIP iteration at 512^2 x8, full width, {dtype}, conv_fusion="
          f"{fusion}: {ms:.3f} ms per iteration (CUDA events); kernels "
          f"busy {busy:.3f} ms of it, idle share {1 - busy / ms:.3f}, "
          f"{ops} device operations per iteration")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / iters / 1e3:8.3f} ms/iter "
              f"{e.count // iters:5d} calls/iter  {e.key[:90]}")


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


def time_kernels(fc, name, size, act, has_base):
    """Phase 4 at one path shape, f32: kernel, plain, library and bound."""
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
        ms, plain_ms = time_ms(kern), time_ms(plain)
        lib_ms = time_ms(lib)
        bms, by = bound(flops, nbytes, dtype)
        rows[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bms, bound_by=by)
        print(f"time {kname} at {name} ({size}^2, {C}->{C}, f32): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s")
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
    print(f"phase 2: kernels agree with their plain versions; largest f32 "
          f"abs errors {worst}")

    check_fused_net()
    with tempfile.TemporaryDirectory() as root:
        write_pair(root)
        counts = run_main_path(fc, cli, root, "float32", 100, 25)
        run_main_path(fc, cli, root, "bfloat16", 25, 5)
    print("phase 3: main path ran through the kernels")
    for dtype, fusion in (("float32", "auto"), ("float32", "off"),
                          ("bfloat16", "auto")):
        profile_iteration(dtype, fusion)

    time_kernels(fc, "down0_conv2", 256, "leaky_relu", False)
    timed = time_kernels(fc, "up0_conv", 512, None, True)
    print("phase 4: timed (the record below is at up0_conv, 512^2)")

    replaces = {"fused_conv3x3_fwd": "tpusr/ops/pallas_conv.py:72",
                "fused_conv3x3_wgrad": "tpusr/ops/pallas_conv.py:297"}
    record = {"kernels": [
        dict(name=k, route="cuda", source="tpusr_torch/csrc/fused_conv3x3.cu",
             replaces=replaces[k], launches=counts[k], max_abs_err=worst[k],
             **timed[k]) for k in replaces]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
