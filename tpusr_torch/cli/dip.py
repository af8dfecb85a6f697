"""DIP super-resolution CLI on the card — the port of ``tpusr/cli/dip.py``.

Usage (flags mirror the JAX CLI, itself DIP.py:236-248, plus --device):
    python -m tpusr_torch.cli.dip --data_dir D --out_dir O --num_iter 1000 \
        [--train_log_freq 100] [--save_output True] [--num_images 1] \
        [--noise_type gauss --noise_param 0.05] [--downsample True] \
        [--device cuda] [--conv_fusion auto|off]

Writes the same ``out/DIPx{f}/<timestamp>[/<noise>/<p>]`` tree, PNGs and
``*_log.txt`` as the JAX CLI. LPIPS logs NaN (the LPIPS model is not ported
yet, as the JAX CLI logs NaN without weights). L-BFGS, meshgrid input,
opt_over other than net, --bucket, --batch_images and --profile_dir are not
ported yet and exit with a message when set.
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
from tpusr_torch.engine.dip import DIPConfig, check_ported, dip_superresolve
from tpusr_torch.engine.metrics import psnr as psnr_fn
from tpusr_torch.engine.metrics import ssim as ssim_fn
from tpusr_torch.io.images import save_image, to_uint8
from tpusr_torch.io.logs import save_log


def main(LR_dir, HR_dir, out_dir, factor, num_images, config: DIPConfig,
         save_output, noise_type, downsample, seed=0, device="cuda"):
    dev = resolve_device(device)
    check_ported(config)
    dataset = DIV2KDataset(LR_dir=LR_dir, HR_dir=HR_dir, scale_factor=factor,
                           num_images=num_images, noise_type=noise_type,
                           downsample=downsample, seed=seed)
    n = len(dataset)
    print(f"Performing DIP SISR on {n} images.")
    print(f"Output directory: {out_dir}")

    running = {"psnr": 0.0, "ssim": 0.0, "lpips": 0.0}
    n_points = config.num_iter // config.log_freq
    curves = {
        "Average PSNR per epoch": np.zeros(n_points),
        "Average SSIM per epoch": np.zeros(n_points),
        "Average LPIPS per epoch": np.zeros(n_points),
    }
    seeds = torch.Generator().manual_seed(seed)
    start_time = time.time()

    for idx, (lr_img, hr_img, name) in enumerate(dataset):
        print(f"Starting on {name} (image {idx + 1}/{n}) "
              f"for {config.num_iter} iterations.")
        gen = torch.Generator().manual_seed(
            int(torch.randint(0, 2 ** 62, (1,), generator=seeds)))
        t0 = time.time()
        lr_u8 = np.round(lr_img * 255.0).astype(np.uint8)[None]
        hr_u8 = np.round(hr_img * 255.0).astype(np.uint8)[None]
        resolved, image_curves = dip_superresolve(lr_u8, hr_u8, config, gen,
                                                  dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"Image runtime: {time.time() - t0:.2f}s")

        hr_dev = torch.from_numpy(hr_img[None]).to(dev)
        running["psnr"] += float(psnr_fn(resolved, hr_dev))
        running["ssim"] += float(ssim_fn(resolved, hr_dev, data_range=1.0))
        running["lpips"] += float("nan")
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
                        choices=["zoom", "fixed"])
    parser.add_argument("--input_method", type=str, default="noise",
                        choices=["noise", "meshgrid"])
    parser.add_argument("--opt_over", type=str, default="net")
    parser.add_argument("--resolve_clean", type=str2bool, default=False,
                        help="resolve the final image with the un-noised "
                             "input (the reference keeps the last reg-noise "
                             "draw, DIP.py:102)")
    parser.add_argument("--bucket", type=int, default=0)
    parser.add_argument("--batch_images", type=int, default=1)
    parser.add_argument("--profile_dir", type=str)
    parser.add_argument("--conv_fusion", type=str, default="auto",
                        choices=["auto", "off"],
                        help="fused conv+BN+act kernels (auto) or plain "
                             "PyTorch convs (off)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


_NOT_PORTED = (("optimizer", "adam"), ("input_method", "noise"),
               ("opt_over", "net"), ("bucket", 0), ("batch_images", 1),
               ("profile_dir", None))


def run(argv=None):
    args = build_parser().parse_args(argv)
    for flag, default in _NOT_PORTED:
        if getattr(args, flag) != default:
            print(f"--{flag} {getattr(args, flag)} is not yet ported to "
                  f"tpusr_torch (the JAX CLI, python -m tpusr.cli.dip, has it)")
            sys.exit(1)

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
        resolve_clean=args.resolve_clean,
        conv_fusion=args.conv_fusion,
    )
    return main(LR_dir, HR_dir, out_dir, factor, args.num_images, config,
                args.save_output, noise_type, args.downsample, args.seed,
                device=args.device)


if __name__ == "__main__":
    run()
