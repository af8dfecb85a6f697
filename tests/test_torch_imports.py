"""tpusr_torch and chip_smoke.py stand alone: no JAX, no tpusr.

A fresh interpreter imports every module of the port and checks that no
jax/flax/optax/tpusr module came along; an AST scan finds no such import
anywhere in the port's sources or in chip_smoke.py.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import tpusr_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpusr")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tpusr_torch.__path__, "tpusr_torch."))


def test_importing_the_port_loads_no_jax_or_tpusr():
    mods = ["tpusr_torch"] + _port_modules()
    for m in ("tpusr_torch.cli.dip", "tpusr_torch.ops.fused_conv",
              "tpusr_torch.models.rrdb", "tpusr_torch.ops.dense_block",
              "tpusr_torch.ops.fused_degrade", "tpusr_torch.ops.bicubic",
              "tpusr_torch.ops.degrade", "tpusr_torch.models.srgan",
              "tpusr_torch.models.lpips", "tpusr_torch.io.checkpoint",
              "tpusr_torch.engine.gan", "tpusr_torch.cli.eval_gan",
              "tpusr_torch.models.vgg19", "tpusr_torch.engine.losses",
              "tpusr_torch.engine.gan_epochs", "tpusr_torch.cli.train_gan",
              "tpusr_torch.engine.lbfgs", "tpusr_torch.utils.profiling",
              "tpusr_torch.parallel.spatial"):
        assert m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for dirpath, _, files in os.walk(os.path.join(ROOT, "tpusr_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_tpusr():
    found = []
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert not found
