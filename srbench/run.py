"""Run one cell of the benchmark and print its result line.

    python3 -m srbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``, ``srbench/``
and the program, ``tpusr_torch/``. The cell's file
(``srbench/workloads/<NAME>.json``) names its configuration and driver;
the driver makes the inputs and weights from the seed, warms up the
cell's shapes (set-up), drives the program's entry for the window, and
the comparison with the plain reference decides ``correct``. With
``--trace 1`` part of the window runs under the profiler and the result
holds the cell's per-layer metrics, each read by ``metrics/<name>.py``.
The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error
and the result's last key. Without a card, or with fewer cards than the
cell asks for, it exits with code 3 and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

ROOT = os.getcwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpusr")


def process_start() -> float:
    """The wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


class CellError(RuntimeError):
    """The cell, its files or the machine do not allow a run."""


def _read_json(path: str) -> dict:
    full = os.path.join(ROOT, path)
    if not os.path.isfile(full):
        raise CellError(f"{path} is missing")
    with open(full) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the cell's file, the
    configuration's file)."""
    bench = _read_json("BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell = _read_json(os.path.join("srbench", "workloads", f"{name}.json"))
    return bench, entry, cell, _read_json(config["file"])


def cell_metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones or, traced, the
    per-layer ones that list it (or, listing none, move one of its
    end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in names
                             else [])]


def load_reader(metric: str):
    """``read(ctx)`` of srbench/metrics/<metric>.py."""
    path = os.path.join(ROOT, "srbench", "metrics", f"{metric}.py")
    if not os.path.isfile(path):
        raise CellError(f"no reader srbench/metrics/{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"srbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def make_driver(cell: dict, config: dict, seed: int, device):
    """The cell's driver, ``srbench/drivers/<cell['driver']>.py``."""
    mod = importlib.import_module(f"srbench.drivers.{cell['driver']}")
    return mod.Driver(config, cell, seed, device)


def judge(readings: dict, limits: dict) -> tuple[dict, bool]:
    """Each compared reading beside its limit, and whether all hold."""
    spare = {k: v for k, v in readings.items() if k not in limits}
    if spare:
        print(f"srbench: read, not compared: {spare}", file=sys.stderr)
    compared = {k: {"value": readings[k], "limit": limits[k]}
                for k in limits}
    return compared, all(c["value"] <= c["limit"]
                         for c in compared.values())


def run(workload: str, seed: int, seconds: float, trace: bool) -> dict:
    """One run of a cell on the card; returns the result object."""
    bench, entry, cell, config = load_cell(workload)
    import torch

    chips = int(entry["chips"])
    if not torch.cuda.is_available():
        raise CellError("CUDA is not available: the benchmark runs only on "
                        "a card")
    if torch.cuda.device_count() < chips:
        raise CellError(f"the cell asks for {chips} cards, "
                        f"{torch.cuda.device_count()} present")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    metrics = cell_metrics(bench, workload, trace)
    readers = {m["name"]: load_reader(m["name"]) for m in metrics} \
        if trace else {}
    driver = make_driver(cell, config, seed, dev)
    ready_s = time.time() - T_START
    driver.setup()
    torch.cuda.synchronize(dev)
    setup_s = time.time() - T_START
    print(f"srbench: {workload}: set-up {setup_s:.3f} s, of which "
          f"{ready_s:.3f} s to the driver (interpreter, torch, CUDA)",
          file=sys.stderr)
    if trace:
        from srbench.tracing import Tracer

        driver.tracer = Tracer(driver.expected_launches(),
                               **cell.get("trace", {}))
    driver.run_window(seconds)
    info = device_info(torch, chips)
    values = {}
    if trace:
        tw = driver.tracer.window
        if tw is None:
            raise CellError("no complete profiled window: recorded "
                            f"{driver.tracer.incomplete}")
        ctx = {**driver.layer_context(), "trace": tw}
        for name, read in readers.items():
            v = read(ctx)
            if v is not None:
                values[name] = v
        info["busy_s"], info["window_s"] = tw.busy_s, tw.window_s
    else:
        values = {**driver.end_to_end(), "setup_s": setup_s}
    print(f"srbench: {workload}: {driver.describe()}", file=sys.stderr)
    driver.release()
    compared, correct = judge(driver.check(), cell["checks"])
    units = {m["name"]: m["unit"] for m in metrics}
    result = {"correct": correct, "attempted": driver.attempted,
              "failed": driver.failed,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in values.items() if k in units},
              "device": info}
    if trace:
        result["breakdown"] = tw.breakdown()
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # PyTorch's own kernel cache lives in the checkout, at a fixed path
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                          os.path.join(ROOT, ".srbench_cache",
                                       "torch_kernels"))
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    except CellError as e:
        print(f"srbench: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"srbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
