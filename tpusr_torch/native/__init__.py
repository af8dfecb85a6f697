"""ctypes bindings for the native (C++/libpng) data loader, on the host.

The port's counterpart of ``tpusr/native``. ``loader.cc`` (beside this
file) is compiled on first use with

    g++ -O3 -shared -fPIC -o tpusr_torch/_build/loader-<hash>.so loader.cc -lpng -lz

where the hash covers the source text and the flags, as
``ops/_build.py`` keys the CUDA kernels; nothing is built at import. The
C calls run without the GIL (ctypes releases it), so a thread pool
parallelises dataset prep.

``build_library`` is that build for any source of this directory
(``zstd.py`` builds the port's zstd decoder with it).

``available()`` gates its use: without g++ or libpng, or with
``TPUSR_NATIVE_LOADER=off``, ``data/div2k.py`` keeps the PIL path, whose
bytes are identical (tests/test_torch_native_loader.py). ``status()``
says which, and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lpng", "-lz")

_lib = None
_status: str | None = None
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path(src: str, stem: str, flags=FLAGS, libs=()) -> str:
    """``_build/<stem>-<hash>.so``, the hash over the source and flags."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            tuple(flags) + tuple(libs)).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build_library(src: str, stem: str, flags=FLAGS, libs=()) -> str:
    """``src`` compiled by g++ at ``library_path``, unless it is there;
    raises with g++'s message when the build fails."""
    out = library_path(src, stem, flags, libs)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *flags, "-o", tmp, src, *libs],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            lines = proc.stderr.strip().splitlines() or ["g++ failed"]
            raise RuntimeError(next((ln for ln in lines if "error" in ln),
                                    lines[-1]))
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _lib_path() -> str:
    return library_path(_SRC, "loader", FLAGS, LIBS)


def _build() -> str:
    return build_library(_SRC, "loader", FLAGS, LIBS)


def _load():
    global _lib, _status
    if _status is not None:
        return _lib
    if os.environ.get("TPUSR_NATIVE_LOADER", "auto") == "off":
        _status = "unavailable: TPUSR_NATIVE_LOADER=off"
        return None
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _status = f"unavailable: {str(e) or type(e).__name__}"
        return None
    lib.tpusr_decode_png.restype = ctypes.c_int
    lib.tpusr_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_U8P),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.tpusr_resize_bicubic_u8.restype = None
    lib.tpusr_resize_bicubic_u8.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _U8P, ctypes.c_int, ctypes.c_int]
    lib.tpusr_load_pair.restype = ctypes.c_int
    lib.tpusr_load_pair.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(_U8P),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.tpusr_free.restype = None
    lib.tpusr_free.argtypes = [_U8P]
    _lib, _status = lib, "built"
    return _lib


def available() -> bool:
    return _load() is not None


def status() -> str:
    """'built', or 'unavailable: <reason>'."""
    _load()
    return _status


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader {status()}")
    return lib


def _take(lib, ptr, h, w) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=(h.value, w.value, 3)).copy()
    lib.tpusr_free(ptr)
    return arr


def decode_png(path: str) -> np.ndarray:
    """RGB8 (H, W, 3) as np.array(PIL.Image.open(path).convert('RGB'))."""
    lib = _need()
    data, h, w = _U8P(), ctypes.c_int(), ctypes.c_int()
    rc = lib.tpusr_decode_png(path.encode(), ctypes.byref(data),
                              ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"tpusr_decode_png({path}) failed: rc={rc}")
    return _take(lib, data, h, w)


def resize_bicubic_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Byte-exact PIL BICUBIC resize of an (H, W, C) uint8 array."""
    lib = _need()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, ch = img.shape
    out = np.empty((out_h, out_w, ch), np.uint8)
    lib.tpusr_resize_bicubic_u8(img.ctypes.data_as(_U8P), h, w, ch,
                                out.ctypes.data_as(_U8P), out_h, out_w)
    return out


def load_pair(hr_path: str, lr_path: str, scale_factor: int,
              downsample: bool) -> tuple[np.ndarray, np.ndarray]:
    """The reference's get_image_pair resize chain (dataset.py:9-46),
    native: (lr_u8, hr_u8) HWC, before noise and scaling (those stay in
    data/div2k.py)."""
    lib = _need()
    lrp, hrp = _U8P(), _U8P()
    lh, lw, hh, hw = (ctypes.c_int() for _ in range(4))
    rc = lib.tpusr_load_pair(
        hr_path.encode(), lr_path.encode(), scale_factor, int(downsample),
        ctypes.byref(lrp), ctypes.byref(lh), ctypes.byref(lw),
        ctypes.byref(hrp), ctypes.byref(hh), ctypes.byref(hw))
    if rc != 0:
        raise IOError(f"tpusr_load_pair({hr_path}) failed: rc={rc}")
    return _take(lib, lrp, lh, lw), _take(lib, hrp, hh, hw)
