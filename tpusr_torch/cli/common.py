"""Shared CLI plumbing: flag parsing helpers, noise validation, out dirs.

Flag-surface parity with the reference's argparse blocks (DIP.py:236-248,
train_GAN.py:211-224, eval_GAN.py:122-134) with one documented fix: boolean
flags parse their value ('--save_output False' is False here; the reference's
``type=bool`` treats any non-empty string as True — SURVEY.md §7 catalog).

A copy of tpusr/cli/common.py, so the port parses and validates the same way.
"""

from __future__ import annotations

import argparse
import os
import sys
from datetime import datetime


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("true", "1", "yes", "y"):
        return True
    if str(v).lower() in ("false", "0", "no", "n", ""):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def timestamp() -> str:
    return datetime.now().strftime("%Y_%m_%d_%p%I_%M")


def validate_noise(args) -> dict | None:
    """Noise flag validation parity (DIP.py:282-308, eval_GAN.py:175-201)."""
    noise_type = args.noise_type
    if not noise_type and args.noise_param:
        print("Must provide noise type with --noise_type if providing noise "
              "parameter with --noise_param")
        sys.exit(1)
    if not noise_type:
        return None
    if args.noise_param is None:
        print("Must provide a noise parameter with --noise_param to use noise.")
        sys.exit(1)
    if args.noise_param < 0 or args.noise_param > 1:
        print("Noise parameter must be in range [0,1].")
        sys.exit(1)
    if noise_type == "gauss":
        return {"type": "Gaussian", "std": args.noise_param}
    if noise_type == "saltpepper":
        return {"type": "SaltAndPepper", "s": args.noise_param, "p": args.noise_param}
    print(f"Noise type {noise_type} not supported. Use either "
          f"--noise_type=gauss or --noise_type=saltpepper")
    sys.exit(1)


def require_dir(path: str) -> None:
    if not os.path.isdir(path):
        print(f"{path} not found.")
        sys.exit(1)


def check_num_images(n: int) -> None:
    if n < -1 or n == 0:
        print("Please provide a valid number of images to use with "
              "--num_images=-1 for entire dataset or --num_images > 0")
        sys.exit(1)
