"""DIP super-resolution CLI on the card — the port of ``tpusr/cli/dip.py``.

Usage (flags mirror the JAX CLI, itself DIP.py:236-248, plus --device):
    python -m tpusr_torch.cli.dip --data_dir D --out_dir O --num_iter 1000 \
        [--train_log_freq 100] [--save_output True] [--num_images 1] \
        [--noise_type gauss --noise_param 0.05] [--downsample True] \
        [--device cuda] [--conv_fusion auto|off] \
        [--optimizer adam|lbfgs --lbfgs_line_search zoom|fixed] \
        [--input_method noise|meshgrid] [--opt_over net,input,down] \
        [--bucket 64 [--batch_images N]] [--profile_dir P]

Writes the same ``out/DIPx{f}/<timestamp>[/<noise>/<p>]`` tree, PNGs and
``*_log.txt`` as the JAX CLI. LPIPS (the curve at each chunk head and the
final one) comes from ``tpusr_torch.models.lpips.make_lpips`` and logs NaN
without weights (``TPUSR_LPIPS_WEIGHTS``), as in the JAX CLI. --bucket pads
each image to multiples of the bucket and masks the loss and the curves to
the image; --batch_images runs a group of same-bucket images in one call;
--profile_dir writes a torch.profiler Chrome trace of the run.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpusr_torch.cli.common import (check_num_images, require_dir, str2bool,
                                    timestamp, validate_noise)
from tpusr_torch.data.div2k import DIV2KDataset
from tpusr_torch.device import resolve_device
from tpusr_torch.engine.dip import (DIPConfig, dip_superresolve,
                                    dip_superresolve_bucketed,
                                    dip_superresolve_scan_bucketed,
                                    pad_to_bucket)
from tpusr_torch.engine.metrics import psnr as psnr_fn
from tpusr_torch.engine.metrics import ssim as ssim_fn
from tpusr_torch.io.images import save_image, to_uint8
from tpusr_torch.io.logs import save_log
from tpusr_torch.models.lpips import make_lpips
from tpusr_torch.utils.profiling import maybe_trace


def _pad_pair(lr_img, hr_img, bucket, factor):
    hr_pad, (h, w) = pad_to_bucket(hr_img, bucket)
    lth, ltw = hr_pad.shape[0] // factor, hr_pad.shape[1] // factor
    lr_pad = np.pad(lr_img, ((0, lth - lr_img.shape[0]),
                             (0, ltw - lr_img.shape[1]), (0, 0)))
    return lr_pad, hr_pad, (h, w)


def main(LR_dir, HR_dir, out_dir, factor, num_images, config: DIPConfig,
         save_output, noise_type, downsample, seed=0, device="cuda",
         bucket=0, batch_images=1):
    dev = resolve_device(device)
    dataset = DIV2KDataset(LR_dir=LR_dir, HR_dir=HR_dir, scale_factor=factor,
                           num_images=num_images, noise_type=noise_type,
                           downsample=downsample, seed=seed)
    n = len(dataset)
    print(f"Performing DIP SISR on {n} images.")
    print(f"Output directory: {out_dir}")

    lpips_fn = make_lpips()
    running = {"psnr": 0.0, "ssim": 0.0, "lpips": 0.0}
    n_points = config.num_iter // config.log_freq
    curves = {
        "Average PSNR per epoch": np.zeros(n_points),
        "Average SSIM per epoch": np.zeros(n_points),
        "Average LPIPS per epoch": np.zeros(n_points),
    }
    seeds = torch.Generator().manual_seed(seed)
    start_time = time.time()

    def next_generator():
        return torch.Generator().manual_seed(
            int(torch.randint(0, 2 ** 62, (1,), generator=seeds)))

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def account(resolved, image_curves, lr_img, hr_img, name):
        hr_dev = torch.from_numpy(hr_img[None]).to(dev)
        running["psnr"] += float(psnr_fn(resolved, hr_dev))
        running["ssim"] += float(ssim_fn(resolved, hr_dev, data_range=1.0))
        running["lpips"] += (float(lpips_fn(resolved, hr_dev))
                             if lpips_fn else float("nan"))
        curves["Average PSNR per epoch"] += image_curves["psnr"][:n_points]
        curves["Average SSIM per epoch"] += image_curves["ssim"][:n_points]
        curves["Average LPIPS per epoch"] += image_curves["lpips"][:n_points]
        for i, (p, s) in enumerate(zip(image_curves["psnr"],
                                       image_curves["ssim"])):
            print(f"Iteration {i * config.log_freq + 1}/{config.num_iter}: "
                  f"PSNR: {p:.4f} SSIM: {s:.4f}")
        if save_output:
            print("Done.")
            res_u8 = torch.clamp(torch.round(resolved * 255.0), 0, 255)
            save_image(res_u8.to(torch.uint8).cpu().numpy()[0],
                       f"{name}_resolved", out_dir)
            save_image(to_uint8(lr_img), f"{name}_LR", out_dir)
            save_image(to_uint8(hr_img), f"{name}_HR", out_dir)

    def u8(img):
        return np.round(img * 255.0).astype(np.uint8)

    if batch_images > 1:
        # same-bucket images one after another in one call; a partial group
        # repeats its last image, and only the real ones are accounted
        groups: dict[tuple, list] = {}

        def flush(shape_key):
            items = groups.pop(shape_key)
            real = len(items)
            while len(items) < batch_images:
                items.append(items[-1])
            lr_b = np.stack([it[0][None] for it in items])
            hr_b = np.stack([it[1][None] for it in items])
            valid = [it[2] for it in items]
            gens = [next_generator() for _ in items]
            t0 = time.time()
            res_b, curves_b = dip_superresolve_scan_bucketed(
                lr_b, hr_b, valid, gens, config, dev, lpips_fn)
            fence()
            print(f"Batch of {real} images runtime: {time.time() - t0:.2f}s")
            for lane in range(real):
                _, _, (h, w), lr_img, hr_img, name = items[lane]
                account(res_b[lane][:, :h, :w],
                        {k: v[lane] for k, v in curves_b.items()},
                        lr_img, hr_img, name)

        for idx, (lr_img, hr_img, name) in enumerate(dataset):
            print(f"Queueing {name} (image {idx + 1}/{n}).")
            lr_pad, hr_pad, (h, w) = _pad_pair(u8(lr_img), u8(hr_img),
                                               bucket, factor)
            skey = hr_pad.shape
            groups.setdefault(skey, []).append(
                (lr_pad, hr_pad, (h, w), lr_img, hr_img, name))
            if len(groups[skey]) == batch_images:
                flush(skey)
        for skey in list(groups):
            flush(skey)
    else:
        for idx, (lr_img, hr_img, name) in enumerate(dataset):
            print(f"Starting on {name} (image {idx + 1}/{n}) "
                  f"for {config.num_iter} iterations.")
            gen = next_generator()
            t0 = time.time()
            lr_u8, hr_u8 = u8(lr_img), u8(hr_img)
            if bucket:
                lr_pad, hr_pad, (h, w) = _pad_pair(lr_u8, hr_u8, bucket,
                                                   factor)
                resolved, image_curves = dip_superresolve_bucketed(
                    lr_pad[None], hr_pad[None], (h, w), config, gen, dev,
                    lpips_fn)
                resolved = resolved[:, :h, :w]
            else:
                resolved, image_curves = dip_superresolve(
                    lr_u8[None], hr_u8[None], config, gen, dev, lpips_fn)
            fence()
            print(f"Image runtime: {time.time() - t0:.2f}s")
            account(resolved, image_curves, lr_img, hr_img, name)

    print(f"Done for all {n} images.")
    metrics = dict(curves)
    metrics["runtime"] = time.time() - start_time
    metrics["Average final PSNR"] = running["psnr"] / n
    metrics["Average final SSIM"] = running["ssim"] / n
    metrics["Average final LPIPS"] = running["lpips"] / n
    metrics["Number of images evaluated over"] = n
    for k in curves:
        metrics[k] = metrics[k] / n
    save_log(out_dir, **metrics, **(noise_type or {}))
    return metrics


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="DIP super-resolution in PyTorch on an NVIDIA GPU")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--num_iter", type=int, default=1)
    parser.add_argument("--train_log_freq", type=int, default=100)
    parser.add_argument("--save_output", type=str2bool, default=False)
    parser.add_argument("--num_images", type=int, default=1)
    parser.add_argument("--noise_type", type=str)
    parser.add_argument("--noise_param", type=float)
    parser.add_argument("--downsample", type=str2bool, default=False)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--input_depth", type=int, default=32)
    parser.add_argument("--num_scales", type=int, default=5)
    parser.add_argument("--skip_n33d", type=int, default=128)
    parser.add_argument("--skip_n33u", type=int, default=128)
    parser.add_argument("--skip_n11", type=int, default=4)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="activation compute dtype (params stay f32)")
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "lbfgs"])
    parser.add_argument("--lbfgs_line_search", type=str, default="zoom",
                        choices=["zoom", "fixed"],
                        help="'fixed' = torch-exact LBFGS stepping (lr as a "
                             "fixed step, no line search); 'zoom' = optax's "
                             "zoom line search (supersedes lr)")
    parser.add_argument("--input_method", type=str, default="noise",
                        choices=["noise", "meshgrid"])
    parser.add_argument("--opt_over", type=str, default="net",
                        help="comma-set of net,input,down")
    parser.add_argument("--resolve_clean", type=str2bool, default=False,
                        help="resolve the final image with the un-noised "
                             "input (the reference keeps the last reg-noise "
                             "draw, DIP.py:102)")
    parser.add_argument("--bucket", type=int, default=0,
                        help="pad images to multiples of this (a multiple "
                             "of the factor); 0 = exact shapes")
    parser.add_argument("--batch_images", type=int, default=1,
                        help="run N same-bucket images per call (requires "
                             "--bucket)")
    parser.add_argument("--profile_dir", type=str,
                        help="write a torch.profiler Chrome trace here")
    parser.add_argument("--conv_fusion", type=str, default="auto",
                        choices=["auto", "off"],
                        help="fused conv+BN+act kernels (auto) or plain "
                             "PyTorch convs (off)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def run(argv=None):
    args = build_parser().parse_args(argv)
    require_dir(args.out_dir)
    LR_dir = os.path.join(args.data_dir, "DIV2K_train_LR_x8/")
    HR_dir = os.path.join(args.data_dir, "DIV2K_train_HR/")
    check_num_images(args.num_images)

    factor = 8  # DIP.py:271
    if args.downsample:
        factor *= 2
    out_dir = os.path.join(args.out_dir, f"out/DIPx{factor}/{timestamp()}")
    noise_type = validate_noise(args)
    if noise_type:
        param = noise_type.get("std", noise_type.get("s"))
        out_dir = os.path.join(out_dir, f"{noise_type['type']}/{param}")
    os.makedirs(out_dir, exist_ok=True)

    config = DIPConfig(
        factor=factor,
        num_iter=args.num_iter,
        learning_rate=0.01,                               # DIP.py:318
        reg_noise_std=0.07 if args.downsample else 0.05,  # DIP.py:320-323
        log_freq=args.train_log_freq,
        input_depth=args.input_depth,
        num_scales=args.num_scales,
        skip_n33d=args.skip_n33d,
        skip_n33u=args.skip_n33u,
        skip_n11=args.skip_n11,
        dtype=args.dtype,
        optimizer=args.optimizer,
        lbfgs_line_search=args.lbfgs_line_search,
        input_method=args.input_method,
        opt_over=args.opt_over,
        resolve_clean=args.resolve_clean,
        conv_fusion=args.conv_fusion,
    )
    if args.bucket and args.bucket % factor != 0:
        print(f"--bucket must be a multiple of the scale factor ({factor})")
        sys.exit(1)
    if args.batch_images > 1 and not args.bucket:
        print("--batch_images requires --bucket (lanes must share a canvas)")
        sys.exit(1)

    with maybe_trace(args.profile_dir):
        return main(LR_dir, HR_dir, out_dir, factor, args.num_images,
                    config, args.save_output, noise_type, args.downsample,
                    args.seed, device=args.device, bucket=args.bucket,
                    batch_images=args.batch_images)


if __name__ == "__main__":
    run()
