"""ctypes bindings for the port's own zstd decoder and CRC32C, on the host.

``zstd.cc`` (beside this file) decodes zstd frames to RFC 8878 without
libzstd, for the orbax checkpoints tpusr writes (``io/ocdbt.py``,
``io/zarr.py``). It is compiled on first use with

    g++ -O2 -std=c++17 -shared -fPIC -o tpusr_torch/_build/zstd-<hash>.so zstd.cc

(the hash over the source and the flags, as the native loader is keyed);
nothing is built at import. There is no other decoder: without g++ the
first call raises with the reason, and a malformed frame raises with the
field at fault.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tpusr_torch.native import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zstd.cc")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_ERR = 512

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library(_SRC, "zstd", FLAGS))
        u8p, sz, err = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
        lib.tpusr_zstd_content_size.restype = ctypes.c_int64
        lib.tpusr_zstd_content_size.argtypes = [u8p, sz, err, sz]
        lib.tpusr_zstd_decompress.restype = ctypes.c_int64
        lib.tpusr_zstd_decompress.argtypes = [u8p, sz, u8p, sz, ctypes.c_int,
                                              err, sz]
        lib.tpusr_zstd_decompress_alloc.restype = ctypes.c_int64
        lib.tpusr_zstd_decompress_alloc.argtypes = [
            u8p, sz, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, err, sz]
        lib.tpusr_zstd_free.restype = None
        lib.tpusr_zstd_free.argtypes = [u8p]
        lib.tpusr_crc32c.restype = ctypes.c_uint32
        lib.tpusr_crc32c.argtypes = [u8p, sz]
        _lib = lib
    return _lib


def _view(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data).view(np.uint8)


def decompress(data, verify_checksum: bool = True) -> np.ndarray:
    """Every frame of ``data`` (bytes-like) decoded, as a uint8 array.
    Frames that declare their content size decode straight into the
    result; a stream with one that does not goes through a growing
    buffer. Raises ValueError on malformed input."""
    lib = _load()
    src = _view(data)
    ptr, n = src.ctypes.data, src.size
    err = ctypes.create_string_buffer(_ERR)
    size = lib.tpusr_zstd_content_size(ptr, n, err, _ERR)
    if size == -2:
        raise ValueError(f"zstd: {err.value.decode()}")
    if size >= 0:
        out = np.empty(size, np.uint8)
        got = lib.tpusr_zstd_decompress(ptr, n, out.ctypes.data, size,
                                        int(verify_checksum), err, _ERR)
        if got < 0:
            raise ValueError(f"zstd: {err.value.decode()}")
        return out
    buf = ctypes.c_void_p()
    got = lib.tpusr_zstd_decompress_alloc(ptr, n, ctypes.byref(buf),
                                          int(verify_checksum), err, _ERR)
    if got < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return np.ctypeslib.as_array(
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)),
            shape=(got,)).copy() if got else np.empty(0, np.uint8)
    finally:
        lib.tpusr_zstd_free(buf)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``, as OCDBT's file footers hold."""
    src = _view(data)
    return int(_load().tpusr_crc32c(src.ctypes.data, src.size))
