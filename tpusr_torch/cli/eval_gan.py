"""SRGAN evaluation CLI on the card — the port of ``tpusr/cli/eval_gan.py``.

Usage (flags mirror the JAX CLI, itself eval_GAN.py:122-134, plus
--device):
    python -m tpusr_torch.cli.eval_gan --data_dir D --out_dir O \
        --model_path G.pth [--save_images True] [--num_images -1] \
        [--noise_type gauss --noise_param 0.05] [--factor 8] \
        [--residual_blocks 16] [--dtype float32|bfloat16] [--device cuda]
        [--generator srgan|rrdb|swinir]

Loads a reference-named generator .pth or the ``params_G`` / ``stats_G``
of an orbax state directory (tpusr's or the port's ``{prefix}_state`` or
``ckpt_epoch{n}``), runs full-image inference at batch
1 on ``DIV2K_valid_LR_x8`` against ``DIV2K_valid_HR`` (the generator's 3x3
convs through kernel A), and writes the same ``out/GANx{f}/<timestamp>``
tree, PNGs and ``*_log.txt`` as the JAX CLI. As there, HR images are in
[-1, 1]; PSNR infers its range from the target and SSIM takes
data_range 1.0; averages divide by the images evaluated; tanh output maps
[-1, 1] -> [0, 255] before the PNG cast. --tiles N runs each image as N
exact overlap-and-discard row tiles in one batched forward
(``tpusr_torch.parallel.spatial``). --spatial_shards N splits each image
into N row slabs, one per rank, with halo rows swapped between
neighbours (``sharded_generator_forward``); every rank ends with the
whole image and rank 0 alone prints and writes the images and the log.
Under torchrun the CLI joins the launched group (of N ranks); launched
plainly it spawns N ranks, one per card (N processes on the CPU).

--generator rrdb runs ESRGAN's RRDBNet instead (usually with --factor 4):
a .pth in ESRGAN's or BasicSR / Real-ESRGAN's names (``params_ema`` /
``params`` unwrapped), its block count read from the file, LR from
``DIV2K_valid_LR_x{factor}/<name>x{factor}.png``. Its output in [0, 1]
is mapped to [-1, 1] (2y - 1) for the metrics and the PNG, and clamped
for the PNG only. --generator swinir runs SwinIR (real-world SR, the
nearest+conv upsampler; --factor 4 for SwinIR-M x4) from a .pth in the
published ``network_swinir.py`` names (``params_ema`` / ``params``
unwrapped), its widths read from the file, LR and output as RRDBNet's.
--tiles and --spatial_shards are SRGAN's alone: their halo covers SRGAN's
receptive field. What the CLI reads of a model (its output range, its LR
set, whether it tiles) are attributes of its class.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from tpusr_torch.cli.common import (check_num_images, join_ranks,
                                    quiet_unless_rank0, require_dir,
                                    str2bool, timestamp, validate_noise)
from tpusr_torch.data.div2k import GANDIV2KDataset
from tpusr_torch.device import resolve_device
from tpusr_torch.engine.gan import (GENERATORS, GANTrainConfig,
                                    generator_class, generator_forward,
                                    torch_dtype)
from tpusr_torch.engine.metrics import psnr as psnr_fn
from tpusr_torch.engine.metrics import ssim as ssim_fn
from tpusr_torch.io.images import save_image, to_uint8
from tpusr_torch.io.logs import save_log
from tpusr_torch.models.lpips import make_lpips
from tpusr_torch.parallel.mesh import make_mesh
from tpusr_torch.parallel.spatial import (sharded_generator_forward,
                                          tiled_generator_forward)


def load_generator(model_path: str, config: GANTrainConfig, device="cuda"):
    """The checkpoint at ``model_path`` -> (the generator ``config.generator``
    names, on ``device``, with its weights; config as the file corrects
    it): the class's own ``load`` (SRGAN's Generator: a reference-named
    .pth or an orbax state directory, its residual-block count taken from
    the file with a warning; RRDBNet and SwinIR: a published .pth, their
    widths taken from the file). A factor the file does not fit raises."""
    return generator_class(config).load(model_path, config,
                                        torch_dtype(config), device)


def evaluate(generator, dataset, out_dir, config: GANTrainConfig,
             save_images: bool = True, device="cuda", tiles: int = 1,
             spatial_shards: int = 1):
    """GAN_ISR_Batch_eval parity (eval_GAN.py:21-69); returns (metrics, n).
    ``tiles`` > 1 runs each image through ``tiled_generator_forward``;
    ``spatial_shards`` > 1 through ``sharded_generator_forward`` over a
    'spatial' mesh of that many ranks, of which rank 0 writes the
    images."""
    dev = resolve_device(device)
    mesh = None
    if spatial_shards > 1:
        mesh = make_mesh({"spatial": spatial_shards}, dev.type)
    main = mesh is None or mesh.get_rank() == 0
    lpips_fn = make_lpips()
    running = {"psnr": 0.0, "ssim": 0.0, "lpips": 0.0}
    n = 0
    for lr_img, hr_img, name in dataset:
        print(f"Starting on {name}.")
        lr_dev = torch.from_numpy(lr_img[None]).to(dev)
        hr_dev = torch.from_numpy(hr_img[None]).to(dev)
        with torch.inference_mode():
            if mesh is not None:
                resolved = sharded_generator_forward(generator, lr_dev,
                                                     config, mesh=mesh)
            elif tiles > 1:
                resolved = tiled_generator_forward(generator, lr_dev, config,
                                                   n_tiles=tiles)
            else:
                resolved = generator_forward(generator, lr_dev, config,
                                             train=False)
            if generator.output_range == (0.0, 1.0):  # the metrics' [-1, 1]
                resolved = resolved * 2.0 - 1.0
            running["psnr"] += float(psnr_fn(resolved, hr_dev))
            running["ssim"] += float(ssim_fn(resolved, hr_dev,
                                             data_range=1.0))
            running["lpips"] += (float(lpips_fn(resolved, hr_dev))
                                 if lpips_fn else float("nan"))
        n += 1
        print(f"Done evaluating over {name}.")
        if save_images and main:
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
                        help="split each image into this many row slabs, "
                             "one rank (card) each, with halo exchange "
                             "(SRGAN only)")
    parser.add_argument("--tiles", type=int, default=1,
                        help="exact overlap-discard tiling of each image "
                             "into this many row tiles, one batched forward "
                             "(SRGAN only)")
    parser.add_argument("--generator", type=str, default="srgan",
                        choices=tuple(GENERATORS),
                        help="srgan (default), rrdb (ESRGAN's RRDBNet from "
                             "a .pth in ESRGAN's or BasicSR's names) or "
                             "swinir (SwinIR, real-world SR, from a .pth in "
                             "the published names); the last two read LR "
                             "from DIV2K_valid_LR_x{factor}")
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
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if not GENERATORS[args.generator].tiles and (args.tiles > 1
                                                 or args.spatial_shards > 1):
        parser.error("--tiles and --spatial_shards take --generator srgan "
                     "only: their halo covers SRGAN's receptive field")
    n = args.spatial_shards
    if n > 1:
        cuda = torch.device(args.device).type == "cuda"
        if cuda and torch.cuda.is_available() and \
                torch.cuda.device_count() < n and \
                not torch.distributed.is_initialized() and \
                "WORLD_SIZE" not in os.environ:
            print(f"--spatial_shards {n} needs {n} cards (one rank each); "
                  f"{torch.cuda.device_count()} visible")
            sys.exit(1)
        if not join_ranks(run, argv, n, args.device):
            return None  # the spawned ranks ran the evaluation
    with quiet_unless_rank0():
        return _evaluate_cli(args)


def _evaluate_cli(args):
    main = not (torch.distributed.is_initialized()
                and torch.distributed.get_rank() != 0)
    require_dir(args.data_dir)
    require_dir(args.out_dir)
    check_num_images(args.num_images)

    factor = args.factor
    if args.downsample:
        factor *= 2
    lr_tag = GENERATORS[args.generator].lr_tag(args.factor)
    LR_dir = os.path.join(args.data_dir, f"DIV2K_valid_LR_{lr_tag}/")
    HR_dir = os.path.join(args.data_dir, "DIV2K_valid_HR/")

    out_dir = os.path.join(args.out_dir, f"out/GANx{factor}/{timestamp()}")
    if main:
        os.makedirs(out_dir, exist_ok=True)

    noise_type = validate_noise(args)

    print("Starting GAN evaluation..")
    config = GANTrainConfig(factor=factor,
                            residual_blocks_count=args.residual_blocks,
                            dtype=None if args.dtype == "float32"
                            else args.dtype, generator=args.generator)
    generator, config = load_generator(args.model_path, config, args.device)

    dataset = GANDIV2KDataset(
        LR_dir=LR_dir, HR_dir=HR_dir, scale_factor=factor,
        num_images=args.num_images, noise_type=noise_type,
        downsample=args.downsample, train=False, seed=args.seed,
        legacy_scale=args.legacy_scale, lr_suffix=lr_tag)

    start_time = time.time()
    eval_metrics, n = evaluate(generator, dataset, out_dir, config,
                               save_images=args.save_images,
                               device=args.device, tiles=args.tiles,
                               spatial_shards=args.spatial_shards)
    runtime = time.time() - start_time

    print(f"Done evaluating for all {n} images.")
    eval_metrics["Number of images evaluated over"] = n
    eval_metrics["Eval runtime"] = time.strftime("%H:%M:%S",
                                                 time.gmtime(runtime))
    if main:
        save_log(out_dir, **eval_metrics, **(noise_type or {}))
    return eval_metrics


if __name__ == "__main__":
    run()
