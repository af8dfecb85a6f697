"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
interpreter imports every srbench module, every metric reader and the
port's modules the drivers use, and no module whose top-level name is
jax, jaxlib, flax, optax, orbax or tpusr is loaded (tpusr_torch is not
tpusr: names are compared whole)."""

import os
import pkgutil
import subprocess
import sys

import srbench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_the_benchmark_loads_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        srbench.__path__, "srbench.") if ".tests" not in m.name)
    mods += ["tpusr_torch.engine.dip", "tpusr_torch.engine.gan",
             "tpusr_torch.engine.gan_epochs", "tpusr_torch.engine.losses"]
    code = (
        "import glob, importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from srbench import run\n"
        "for p in sorted(glob.glob('srbench/metrics/*.py')):\n"
        "    run.load_reader(p.split('/')[-1][:-3])\n"
        "bad = run.forbidden_modules()\n"
        "print(bad, 'tpusr_torch' in sys.modules)\n"
        "sys.exit(1 if bad or 'tpusr_torch' not in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    from srbench import run

    monkeypatch.setitem(sys.modules, "tpusr_torch_lookalike", sys)
    assert "tpusr_torch_lookalike" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpusr.engine", sys)
    assert run.forbidden_modules() == ["tpusr.engine"]
