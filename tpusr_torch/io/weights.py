"""Weight bridge: JAX (flax) variables -> the port's SkipNet and RRDBNet.

The JAX package keeps conv kernels HWIO and BatchNorm params as
``scale``/``bias`` with running stats ``mean``/``var`` in a separate
``batch_stats`` collection; the port keeps OIHW ``weight`` tensors and
``running_mean``/``running_var`` buffers under the same module names. The
tests feed both packages the same weights through this bridge; the port
itself never needs JAX (the variables arrive as nested dicts of arrays).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

# (collection, flax leaf) -> (torch name, convert)
_LEAVES = {
    ("params", "kernel"): ("weight", lambda a: a.transpose(3, 2, 0, 1)),
    ("params", "bias"): ("bias", lambda a: a),
    ("params", "scale"): ("weight", lambda a: a),
    ("batch_stats", "mean"): ("running_mean", lambda a: a),
    ("batch_stats", "var"): ("running_var", lambda a: a),
}


def _flatten(collection: str, tree: Mapping) -> dict[str, np.ndarray]:
    flat = {}
    for mod_name, leaves in tree.items():
        for leaf, arr in leaves.items():
            key = (collection, leaf)
            if key not in _LEAVES:
                raise KeyError(f"unexpected {collection} leaf "
                               f"{mod_name}/{leaf}")
            name, convert = _LEAVES[key]
            flat[f"{mod_name}.{name}"] = convert(np.asarray(arr, np.float32))
    return flat


def load_flax_skipnet(module: nn.Module, params: Mapping,
                      batch_stats: Mapping) -> None:
    """Copy flax SkipNet variables into ``module`` in place.

    Conv kernels go HWIO -> OIHW (the 132-input SplitConv kernel keeps its
    [skip, trunk] channel order), BN scale/bias/mean/var go to
    weight/bias/running_mean/running_var. Raises on a missing or extra key
    and on a shape mismatch.
    """
    flat = _flatten("params", params)
    flat.update(_flatten("batch_stats", batch_stats))
    _copy_into(module, flat)


def _flatten_nested(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Flax params of any depth -> {dotted torch name: array}. ``kernel``
    (HWIO) becomes an OIHW ``weight``; every other leaf keeps its name and
    layout (DenseBlock's ``conv{k}_kernel`` stay HWIO, as kernel C reads
    them)."""
    flat = {}
    for name, val in tree.items():
        if isinstance(val, Mapping):
            flat.update(_flatten_nested(val, f"{prefix}{name}."))
        elif name == "kernel":
            flat[f"{prefix}weight"] = np.asarray(val, np.float32).transpose(
                3, 2, 0, 1)
        else:
            flat[f"{prefix}{name}"] = np.asarray(val, np.float32)
    return flat


def _copy_into(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(f"weight bridge mismatch: missing {missing}, "
                       f"extra {extra}")
    for name, arr in flat.items():
        if tuple(state[name].shape) != arr.shape:
            raise ValueError(f"{name}: shape {arr.shape} does not fit "
                             f"{tuple(state[name].shape)}")
    with torch.no_grad():
        for name, arr in flat.items():
            state[name].copy_(torch.from_numpy(np.array(arr)))


def load_flax_rrdbnet(module: nn.Module, params: Mapping) -> None:
    """Copy flax RRDBNet params (``rrdb{i}/rdb{j}/conv{k}_kernel``,
    ``conv_first/kernel``, ...) into ``module`` in place. Conv kernels go
    HWIO -> OIHW; the dense blocks' own kernels stay HWIO. Raises on a
    missing or extra key and on a shape mismatch."""
    _copy_into(module, _flatten_nested(params))
