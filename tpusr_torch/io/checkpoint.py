"""Generator checkpoints as torch .pth files in the reference's naming.

Counterpart of the .pth half of ``tpusr/io/checkpoint.py`` (reference
utils/common.py:11-18, 46-60). A .pth written by the reference, by tpusr's
``export_torch_generator`` + ``save_torch_pth`` or by the port's own
export loads here, and the port's export loads in both of the others.

Reference names (models/GAN/generator.py) against the port's modules:
``residual_blocks.{i}.*`` is ``res{i}.*``, ``pixel_shuffle_blocks.{i}.*`` is
``ps{i}.*``, a PReLU's ``weight`` is its ``alpha``; convs keep OIHW and BNs
keep ``weight``/``bias``/``running_mean``/``running_var`` (the reference's
``num_batches_tracked`` is dropped on import and written as 0 on export).

tpusr's orbax checkpoint directories need orbax and JAX, which the port
does not use; tpusr converts them to a .pth.
"""

from __future__ import annotations

import os
import re

import torch

_CONV = ("weight", "bias")
_BN = ("weight", "bias", "running_mean", "running_var")


def _strip_ddp(sd: dict) -> dict:
    """'module.' prefix strip: load_model parity (utils/common.py:50-56)."""
    pattern = re.compile(r"^module\.")
    return {pattern.sub("", k): v for k, v in sd.items()}


def load_torch_state_dict(path: str) -> dict:
    """A .pth state dict on the CPU, tensors only, DDP prefixes stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return _strip_ddp(sd)


def infer_generator_arch(tree: dict) -> tuple[int, int]:
    """(residual_blocks_count, n_shuffles) of a generator checkpoint.

    Takes a reference state dict (``residual_blocks.{i}.*``,
    ``pixel_shuffle_blocks.{i}.*``) or one in tpusr's and the port's naming
    (``res{i}``, ``ps{i}``, at the top of a nested tree or as the first
    part of a dotted name).
    """
    keys = list(tree.keys())
    if any(k.startswith(("residual_blocks.", "pixel_shuffle_blocks."))
           for k in keys):  # reference state dict
        rb = {int(k.split(".")[1]) for k in keys
              if k.startswith("residual_blocks.")}
        ps = {int(k.split(".")[1]) for k in keys
              if k.startswith("pixel_shuffle_blocks.")}
    else:
        heads = {k.split(".")[0] for k in keys}
        rb = {int(h[3:]) for h in heads if h.startswith("res")
              and h[3:].isdigit()}
        ps = {int(h[2:]) for h in heads if h.startswith("ps")
              and h[2:].isdigit()}
    if not rb or not ps:
        raise ValueError(
            f"not a generator checkpoint (no residual/shuffle blocks found "
            f"among {sorted(keys)[:8]}...)")
    return max(rb) + 1, max(ps) + 1


def _name_pairs(residual_blocks_count: int, n_shuffles: int):
    """(reference name, port name) of every generator tensor, in order."""
    pairs = []

    def put(ref, port, leaves):
        pairs.extend((f"{ref}.{leaf}", f"{port}.{leaf}") for leaf in leaves)

    put("conv1", "conv1", _CONV)
    pairs.append(("prelu1.weight", "prelu1.alpha"))
    for i in range(residual_blocks_count):
        ref, port = f"residual_blocks.{i}", f"res{i}"
        put(f"{ref}.conv1", f"{port}.conv1", _CONV)
        put(f"{ref}.bn1", f"{port}.bn1", _BN)
        pairs.append((f"{ref}.prelu1.weight", f"{port}.prelu1.alpha"))
        put(f"{ref}.conv2", f"{port}.conv2", _CONV)
        put(f"{ref}.bn2", f"{port}.bn2", _BN)
    put("conv2", "conv2", _CONV)
    put("bn1", "bn1", _BN)
    for i in range(n_shuffles):
        ref, port = f"pixel_shuffle_blocks.{i}", f"ps{i}"
        put(f"{ref}.conv1", f"{port}.conv1", _CONV)
        pairs.append((f"{ref}.prelu1.weight", f"{port}.prelu1.alpha"))
    put("conv3", "conv3", _CONV)
    return pairs


def import_torch_generator(sd: dict, residual_blocks_count: int = 16,
                           n_shuffles: int = 3) -> dict:
    """Reference Generator state dict -> the port's Generator state dict
    (f32 CPU tensors), for ``Generator.load_state_dict``. Raises KeyError on
    a missing reference key."""
    return {port: torch.as_tensor(sd[ref]).to(torch.float32)
            for ref, port in _name_pairs(residual_blocks_count, n_shuffles)}


def export_torch_generator(state: dict, residual_blocks_count: int = 16,
                           n_shuffles: int = 3) -> dict:
    """The port's Generator state dict -> the reference-named one, f32 CPU
    tensors (``save_torch_pth`` writes it as a .pth the reference's
    load_model accepts)."""
    sd = {ref: state[port].detach().to("cpu", torch.float32)
          for ref, port in _name_pairs(residual_blocks_count, n_shuffles)}
    for key in [k for k in sd if k.endswith(".running_var")]:
        sd[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(
            0, dtype=torch.int64)
    return sd


def save_torch_pth(sd: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: torch.as_tensor(v).contiguous() for k, v in sd.items()},
               path)
    print(f"Model saved to {path}")
