"""Shared CLI plumbing: flag parsing helpers, noise validation, out dirs.

Flag-surface parity with the reference's argparse blocks (DIP.py:236-248,
train_GAN.py:211-224, eval_GAN.py:122-134) with one documented fix: boolean
flags parse their value ('--save_output False' is False here; the reference's
``type=bool`` treats any non-empty string as True — SURVEY.md §7 catalog).

A copy of tpusr/cli/common.py, so the port parses and validates the same way.
"""

from __future__ import annotations

import argparse
import contextlib
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


def planned_ranks(default: int) -> int:
    """The world size a multi-device run will have: the group's when one
    is initialised, torchrun's WORLD_SIZE, else ``default`` (what a plain
    launch spawns)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return default


def join_ranks(entry, argv, n: int, device: str) -> bool:
    """Make this process one of the ``n`` ranks that run ``entry(argv)``.

    In an initialised group (a caller's, or torchrun's environment, which
    is joined here) this process is a rank: True. A plain launch with n > 1
    spawns the n ranks (each calls ``entry(argv)`` in a group of its own)
    and returns False once they have finished; n == 1 runs here, the
    one-rank group set up by ``make_mesh``.
    """
    import torch.distributed as dist

    from tpusr_torch.parallel.mesh import init_distributed, spawn

    if dist.is_initialized():
        return True
    if "WORLD_SIZE" in os.environ:
        init_distributed(device=device)
        return True
    if n == 1:
        return True
    spawn(_rank_entry, n, (entry, argv), device=device)
    return False


def _rank_entry(rank, entry, argv):
    entry(argv)


@contextlib.contextmanager
def quiet_unless_rank0():
    """A block in which ranks other than 0 print nothing."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_rank() != 0:
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            yield
    else:
        yield
