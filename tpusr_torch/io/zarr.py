"""zarr v2 arrays over a key-value store: how orbax lays out each leaf.

A leaf ``name`` is the JSON metadata ``name/.zarray`` plus chunks
``name/<i>.<j>...`` (``name/0`` for a 0-d array), each the C-order bytes
of one full chunk, compressed as ``.zarray``'s ``compressor`` says. The
store is an ``OcdbtStore`` (io/ocdbt.py) or a ``DirStore`` over plain
files, both with ``get(key) -> bytes | None``.

Reading takes the dtypes tpusr writes (``<f4``, ``<i4``, ``<u4``,
``bfloat16`` as its uint16 bits into ``torch.bfloat16``, ``|b1``),
several chunks with the edge chunks cut to the array, missing chunks as
a numeric or null (0) ``fill_value``, and the compressors ``zstd`` (the
port's own decoder, native/zstd.py) and ``null``. Writing stores one
uncompressed chunk. Anything else (filters, Fortran order, another
compressor or dtype) raises with the reason.
"""

from __future__ import annotations

import itertools
import json
import math
import os

import numpy as np
import torch

from tpusr_torch.native import zstd

# zarr dtype string -> (numpy dtype of the stored bytes, torch dtype)
_DTYPES = {"<f4": (np.dtype("<f4"), torch.float32),
           "<i4": (np.dtype("<i4"), torch.int32),
           "<u4": (np.dtype("<i4"), torch.uint32),  # through the int32 bits
           "bfloat16": (np.dtype("<i2"), torch.bfloat16),  # through int16
           "|b1": (np.dtype("bool"), torch.bool)}
_WRITE = {t: code for code, (_, t) in _DTYPES.items()}
_BITS = {torch.bfloat16: torch.int16, torch.uint32: torch.int32}


class DirStore:
    """Keys as files under ``root`` (orbax's layout without OCDBT)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def get(self, key: str | bytes) -> bytes | None:
        key = key.decode() if isinstance(key, bytes) else key
        path = os.path.join(self.root, key)
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


def _fill(value, torch_dtype):
    """A missing chunk's value as the stored dtype: null is 0."""
    if value is None:
        return 0
    if not isinstance(value, (int, float)):
        raise ValueError(f"zarr: fill_value {value!r} not read")
    t = torch.tensor(value, dtype=torch_dtype)
    return t.view(_BITS.get(torch_dtype, torch_dtype)).item()


def read_array(store, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store`` as a CPU tensor."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"zarr: no {name}/.zarray")
    meta = json.loads(raw)
    where = f"zarr array {name!r}"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')}, "
                         f"only 2 is read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{where}: order {meta['order']!r}, only 'C' is "
                         f"read")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {meta['filters']} not read")
    if meta["dtype"] not in _DTYPES:
        raise ValueError(f"{where}: dtype {meta['dtype']!r} not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {comp.get('id')!r}; only "
                         f"zstd and null are read")
    np_dtype, torch_dtype = _DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape):
        raise ValueError(f"{where}: chunks {chunks} do not fit shape {shape}")
    fill = _fill(meta.get("fill_value"), torch_dtype)
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, np_dtype)
    grid = [range(math.ceil(s / c)) if c else range(0)
            for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/" + (sep.join(map(str, idx)) if shape else "0")
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        data = store.get(key)
        if data is None:
            out[region] = fill
            continue
        buf = zstd.decompress(data) if comp is not None else \
            np.frombuffer(data, np.uint8)
        want = math.prod(chunks) * np_dtype.itemsize
        if buf.size != want:
            raise ValueError(f"{where}: chunk {key} holds {buf.size} bytes, "
                             f"a chunk of {chunks} {meta['dtype']} is {want}")
        block = buf.view(np_dtype).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    t = torch.from_numpy(out)
    return t.view(torch_dtype) if t.dtype != torch_dtype else t


def write_array(directory: str, array: torch.Tensor) -> None:
    """``array`` as a zarr v2 array at ``directory``: ``.zarray`` and one
    uncompressed chunk."""
    t = torch.as_tensor(array).detach().to("cpu").contiguous()
    if t.dtype not in _WRITE:
        raise ValueError(f"zarr: no zarr dtype for {t.dtype}")
    shape = list(t.shape)
    meta = {"chunks": [max(s, 1) for s in shape], "compressor": None,
            "dimension_separator": ".", "dtype": _WRITE[t.dtype],
            "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, ".zarray"), "w") as f:
        json.dump(meta, f)
    if t.numel() == 0:
        return
    t = t.view(_BITS.get(t.dtype, t.dtype))  # numpy has no bf16 / uint32
    chunk = ".".join("0" for _ in shape) or "0"
    with open(os.path.join(directory, chunk), "wb") as f:
        f.write(t.numpy().data)
