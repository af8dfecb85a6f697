"""tpusr's orbax checkpoint directories, read and written without orbax:
the counterparts of ``tpusr/io/checkpoint.py``'s ``load_checkpoint`` and
``save_checkpoint``.

A checkpoint directory holds ``_METADATA`` (JSON): under
``tree_metadata``, each leaf's key path (``key_type`` 1 a sequence index,
2 a dict key or attribute) and its value type, plus ``use_ocdbt`` and
``use_zarr3``. Leaf ``a.b.0`` is the zarr v2 array ``a.b.0`` (io/zarr.py):
inside one OCDBT store when ``use_ocdbt`` is true (what orbax writes by
default, io/ocdbt.py), else as plain files ``a.b.0/.zarray`` and chunks.

``read_tree`` reads either layout into nested dicts and lists of CPU
tensors (a ``None`` leaf, as optax's ``EmptyState`` is stored, stays
None), as orbax's restore without a target returns them. ``write_tree``
writes the plain layout, uncompressed, with ``_METADATA`` and
``_CHECKPOINT_METADATA``: orbax's ``StandardCheckpointer.restore`` reads it
with and without a target (it needs no ``_sharding``).
``cast_like`` casts a restored tree to a target's dtypes, as tpusr's
``load_checkpoint`` does when it is given a target.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import torch

from tpusr_torch.io.ocdbt import OcdbtStore
from tpusr_torch.io.zarr import DirStore, read_array, write_array

_SEQ, _DICT = 1, 2  # orbax key types
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def is_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "_METADATA"))


def _metadata(path: str) -> dict:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no such checkpoint directory")
    if not is_checkpoint(path):
        raise ValueError(f"{path} is not an orbax checkpoint (no _METADATA)")
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: a zarr3 checkpoint (use_zarr3: true); "
                         f"the port reads orbax's zarr v2 layout only")
    return meta


def _nest(items: list[tuple[list[tuple[str, int]], Any]], where: str):
    """Leaves at key paths -> nested dicts (key type 2) and lists (1)."""
    root: dict = {}
    kinds: dict[int, int] = {}
    for keys, value in items:
        node = root
        for depth, (k, kind) in enumerate(keys):
            if kinds.setdefault(id(node), kind) != kind:
                raise ValueError(f"{where}: mixed key types under "
                                 f"{keys[:depth]}")
            if depth == len(keys) - 1:
                node[k] = value
            else:
                node = node.setdefault(k, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        if kinds.get(id(node)) == _SEQ:
            idx = sorted(int(k) for k in node)
            if idx != list(range(len(idx))):
                raise ValueError(f"{where}: sequence indices {idx}")
            return [build(node[str(i)]) for i in idx]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def read_tree(path: str) -> Any:
    """The tree of the orbax checkpoint at ``path`` (written by tpusr's
    ``save_checkpoint`` or by ``write_tree``), leaves as CPU tensors.
    Raises on a directory without ``_METADATA``, a zarr3 checkpoint and any
    leaf type or zarr feature the reader does not know."""
    path = os.path.abspath(path)
    meta = _metadata(path)
    store = OcdbtStore(path) if meta.get("use_ocdbt", True) \
        else DirStore(path)
    items = []
    for entry in meta["tree_metadata"].values():
        keys = [(str(k["key"]), int(k["key_type"]))
                for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if kind == "None":
            value = None
        elif kind in ("jax.Array", "np.ndarray"):
            value = read_array(store, ".".join(k for k, _ in keys))
        else:
            raise ValueError(f"{path}: leaf {[k for k, _ in keys]} has "
                             f"value type {kind!r}; arrays and None are read")
        items.append((keys, value))
    return _nest(items, path)


def _flatten(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, keys + ((str(k), _DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + ((str(i), _SEQ),))
    else:
        yield keys, tree


def write_tree(path: str, tree: Any) -> None:
    """``tree`` (nested dicts, lists and tuples of tensors or arrays, and
    None) as an orbax checkpoint directory at ``path``, replacing what is
    there: plain zarr v2 files, uncompressed. Written into a sibling
    directory first and renamed into place."""
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    start = time.time_ns()
    tree_meta = {}
    for keys, leaf in _flatten(tree):
        if not keys:
            raise ValueError("write_tree: the tree is a single leaf")
        entry = {"key_metadata": [{"key": k, "key_type": t}
                                  for k, t in keys]}
        if leaf is None:
            entry["value_metadata"] = {"value_type": "None",
                                       "skip_deserialize": True}
        else:
            leaf = torch.as_tensor(leaf)
            write_array(os.path.join(tmp, ".".join(k for k, _ in keys)),
                        leaf)
            entry["value_metadata"] = {"value_type": "jax.Array",
                                       "skip_deserialize": False,
                                       "write_shape": list(leaf.shape)}
        tree_meta[str(tuple(k for k, _ in keys))] = entry
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": start,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)
    os.replace(tmp, path)


def cast_like(tree: Any, target: Any, where: str = "") -> Any:
    """``tree`` with each leaf cast to the dtype of ``target``'s leaf at the
    same place (tpusr/io/checkpoint.py:49-58); raises where the two trees'
    structures or shapes differ."""
    if isinstance(target, dict):
        if not isinstance(tree, dict) or set(tree) != set(target):
            got = sorted(tree) if isinstance(tree, dict) else \
                type(tree).__name__
            raise ValueError(f"checkpoint does not fit at {where or '/'}: "
                             f"{got}, expected keys {sorted(target)}")
        return {k: cast_like(tree[k], v, f"{where}/{k}")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(target):
            raise ValueError(f"checkpoint does not fit at {where}: expected "
                             f"a sequence of {len(target)}")
        return [cast_like(a, b, f"{where}/{i}")
                for i, (a, b) in enumerate(zip(tree, target))]
    if target is None:
        if tree is not None:
            raise ValueError(f"checkpoint does not fit at {where}: expected "
                             f"None")
        return None
    target = torch.as_tensor(target)
    if not isinstance(tree, torch.Tensor) or tree.shape != target.shape:
        raise ValueError(f"checkpoint does not fit at {where}: "
                         f"{getattr(tree, 'shape', type(tree).__name__)}, "
                         f"expected {tuple(target.shape)}")
    return tree.to(target.dtype)
