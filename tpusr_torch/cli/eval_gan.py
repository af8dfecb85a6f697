"""SRGAN evaluation CLI on the card — the port of ``tpusr/cli/eval_gan.py``.

Usage (flags mirror the JAX CLI, itself eval_GAN.py:122-134, plus
--device):
    python -m tpusr_torch.cli.eval_gan --data_dir D --out_dir O \
        --model_path G.pth [--save_images True] [--num_images -1] \
        [--noise_type gauss --noise_param 0.05] [--factor 8] \
        [--residual_blocks 16] [--dtype float32|bfloat16] [--device cuda]

Loads a reference-named generator .pth, runs full-image inference at batch
1 on ``DIV2K_valid_LR_x8`` against ``DIV2K_valid_HR`` (the generator's 3x3
convs through kernel A), and writes the same ``out/GANx{f}/<timestamp>``
tree, PNGs and ``*_log.txt`` as the JAX CLI. As there, HR images are in
[-1, 1]; PSNR infers its range from the target and SSIM takes
data_range 1.0; averages divide by the images evaluated; tanh output maps
[-1, 1] -> [0, 255] before the PNG cast. --tiles N runs each image as N
exact overlap-and-discard row tiles in one batched forward
(``tpusr_torch.parallel.spatial``). --spatial_shards above 1 (several
devices) is not ported yet and exits with a message.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import warnings

import torch

from tpusr_torch.cli.common import (check_num_images, require_dir, str2bool,
                                    timestamp, validate_noise)
from tpusr_torch.data.div2k import GANDIV2KDataset
from tpusr_torch.device import resolve_device
from tpusr_torch.engine.gan import (GANTrainConfig, build_generator,
                                    generator_forward)
from tpusr_torch.engine.metrics import psnr as psnr_fn
from tpusr_torch.engine.metrics import ssim as ssim_fn
from tpusr_torch.io.checkpoint import (import_torch_generator,
                                       infer_generator_arch,
                                       load_torch_state_dict)
from tpusr_torch.io.images import save_image, to_uint8
from tpusr_torch.io.logs import save_log
from tpusr_torch.models.lpips import make_lpips
from tpusr_torch.models.srgan import N_SHUFFLES
from tpusr_torch.parallel.spatial import tiled_generator_forward


def load_generator(model_path: str, config: GANTrainConfig, device="cuda"):
    """A reference-named torch .pth (DDP prefixes stripped) -> (Generator
    on ``device``, config).

    config's residual_blocks_count is corrected to what the checkpoint
    holds, with a warning; a pixel-shuffle count that does not fit
    config.factor raises with the factor the model was trained for.
    """
    if os.path.isdir(model_path) or not model_path.endswith(".pth"):
        raise ValueError(
            f"{model_path}: tpusr_torch reads generator .pth files only; an "
            f"orbax checkpoint directory needs JAX. Convert it with tpusr: "
            f"tpusr.io.checkpoint.export_torch_generator(params, stats) and "
            f"save_torch_pth(sd, 'G.pth')")
    n_shuffles = N_SHUFFLES[config.factor]
    sd = load_torch_state_dict(model_path)
    rb, ns = infer_generator_arch(sd)
    if ns != n_shuffles:
        ckpt_factor = {v: k for k, v in N_SHUFFLES.items()}[ns]
        raise ValueError(
            f"{model_path} holds a x{ckpt_factor} generator ({ns} pixel-"
            f"shuffle blocks) but --factor/--downsample request "
            f"x{config.factor} ({n_shuffles}); rerun with the factor the "
            f"model was trained for")
    if rb != config.residual_blocks_count:
        warnings.warn(
            f"checkpoint has {rb} residual blocks; overriding "
            f"--residual_blocks {config.residual_blocks_count}")
        config = dataclasses.replace(config, residual_blocks_count=rb)
    generator = build_generator(config, device)
    generator.load_state_dict(import_torch_generator(
        sd, residual_blocks_count=rb, n_shuffles=ns))
    return generator, config


def evaluate(generator, dataset, out_dir, config: GANTrainConfig,
             save_images: bool = True, device="cuda", tiles: int = 1):
    """GAN_ISR_Batch_eval parity (eval_GAN.py:21-69); returns (metrics, n).
    ``tiles`` > 1 runs each image through ``tiled_generator_forward``."""
    dev = resolve_device(device)
    lpips_fn = make_lpips()
    running = {"psnr": 0.0, "ssim": 0.0, "lpips": 0.0}
    n = 0
    for lr_img, hr_img, name in dataset:
        print(f"Starting on {name}.")
        lr_dev = torch.from_numpy(lr_img[None]).to(dev)
        hr_dev = torch.from_numpy(hr_img[None]).to(dev)
        with torch.inference_mode():
            if tiles > 1:
                resolved = tiled_generator_forward(generator, lr_dev, config,
                                                   n_tiles=tiles)
            else:
                resolved = generator_forward(generator, lr_dev, config,
                                             train=False)
            running["psnr"] += float(psnr_fn(resolved, hr_dev))
            running["ssim"] += float(ssim_fn(resolved, hr_dev,
                                             data_range=1.0))
            running["lpips"] += (float(lpips_fn(resolved, hr_dev))
                                 if lpips_fn else float("nan"))
        n += 1
        print(f"Done evaluating over {name}.")
        if save_images:
            save_image(to_uint8(resolved.cpu().numpy(), from_range="pm1"),
                       name, out_dir)
    return {
        "avg_psnr": running["psnr"] / max(n, 1),
        "avg_ssim": running["ssim"] / max(n, 1),
        "avg_lpips": running["lpips"] / max(n, 1),
    }, n


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="SRGAN evaluation in PyTorch on an NVIDIA GPU")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--num_images", type=int, default=-1)
    parser.add_argument("--save_images", type=str2bool, default=False)
    parser.add_argument("--noise_type", type=str)
    parser.add_argument("--noise_param", type=float)
    parser.add_argument("--factor", type=int, default=8)
    parser.add_argument("--downsample", type=str2bool, default=False)
    parser.add_argument("--spatial_shards", type=int, default=1,
                        help="not yet ported (JAX CLI: shard huge images "
                             "across devices)")
    parser.add_argument("--tiles", type=int, default=1,
                        help="exact overlap-discard tiling of each image "
                             "into this many row tiles, one batched forward")
    parser.add_argument("--residual_blocks", type=int, default=16)
    parser.add_argument("--legacy_scale", type=str2bool, default=False,
                        help="reproduce the reference's double-/255 image "
                             "scaling bug (dataset.py:151-157)")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="activation dtype for inference (params stay "
                             "f32); in float32 the 3x3 convs multiply in "
                             "full f32 (kernel A) and the two 9x9 cuDNN "
                             "convs in TF32, PyTorch's default")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def run(argv=None):
    args = build_parser().parse_args(argv)
    if args.spatial_shards > 1:
        print(f"--spatial_shards {args.spatial_shards} is not yet ported to "
              f"tpusr_torch (the JAX CLI, python -m tpusr.cli.eval_gan, has "
              f"it)")
        sys.exit(1)
    require_dir(args.data_dir)
    require_dir(args.out_dir)
    check_num_images(args.num_images)

    LR_dir = os.path.join(args.data_dir, "DIV2K_valid_LR_x8/")
    HR_dir = os.path.join(args.data_dir, "DIV2K_valid_HR/")

    factor = args.factor
    if args.downsample:
        factor *= 2

    out_dir = os.path.join(args.out_dir, f"out/GANx{factor}/{timestamp()}")
    os.makedirs(out_dir, exist_ok=True)

    noise_type = validate_noise(args)

    print("Starting GAN evaluation..")
    config = GANTrainConfig(factor=factor,
                            residual_blocks_count=args.residual_blocks,
                            dtype=None if args.dtype == "float32"
                            else args.dtype)
    generator, config = load_generator(args.model_path, config, args.device)

    dataset = GANDIV2KDataset(
        LR_dir=LR_dir, HR_dir=HR_dir, scale_factor=factor,
        num_images=args.num_images, noise_type=noise_type,
        downsample=args.downsample, train=False, seed=args.seed,
        legacy_scale=args.legacy_scale)

    start_time = time.time()
    eval_metrics, n = evaluate(generator, dataset, out_dir, config,
                               save_images=args.save_images,
                               device=args.device, tiles=args.tiles)
    runtime = time.time() - start_time

    print(f"Done evaluating for all {n} images.")
    eval_metrics["Number of images evaluated over"] = n
    eval_metrics["Eval runtime"] = time.strftime("%H:%M:%S",
                                                 time.gmtime(runtime))
    save_log(out_dir, **eval_metrics, **(noise_type or {}))
    return eval_metrics


if __name__ == "__main__":
    run()
