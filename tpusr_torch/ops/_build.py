"""Build and load the port's CUDA kernels (nvcc into a shared library, ctypes).

Each source in ``tpusr_torch/csrc`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``tpusr_torch/_build/<name>-<hash>.so``, where the hash covers the
source text and the flags, so an edited source is rebuilt and an unchanged
one is reused. The sources have a plain C interface (no PyTorch headers), so
a build takes seconds. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fused_conv3x3.cu", "dense_block.cu", "degrade.cu", "bn_act.cu",
           "window_attention.cu")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: building the tpusr_torch kernels "
                       "needs the CUDA toolkit (PATH or CUDA_HOME)")


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def _compile(source: str) -> tuple[str, str]:
    """Compile one source unless its library exists; returns (path, log)."""
    out = _lib_path(source)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stderr


def build_all(verbose: bool = False) -> float:
    """Compile every source in parallel (one nvcc each); returns seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        results = list(pool.map(_compile, SOURCES))
    if verbose:
        for (path, log) in results:
            print(f"built {os.path.basename(path)}")
            if log:
                print(log.strip())
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The ctypes library of one source, built on first use."""
    lib = _loaded.get(source)
    if lib is None:
        path, _ = _compile(source)
        lib = ctypes.CDLL(path)
        _loaded[source] = lib
    return lib
