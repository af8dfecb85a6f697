"""Profiling hooks — the port of ``tpusr/utils/profiling.py``.

``maybe_trace`` wraps a block in ``torch.profiler.profile`` (CPU and, with
a card, CUDA activities) and writes a Chrome trace into the directory the
CLI's ``--profile_dir`` names; ``device_fence`` waits for the card;
``Stopwatch`` laps the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """Profile the block into ``<trace_dir>/trace_<pid>_<ns>.json`` when
    a directory is given; do nothing otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_fence(x: torch.Tensor) -> float:
    """Wait for everything queued on x's device; returns x's sum."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.sum())


class Stopwatch:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
