"""Profiler windows over the timed path, and what is read from them.

A ``Tracer`` steps a ``torch.profiler`` schedule once per unit of work (a
DIP iteration, an eval image) and keeps the first active window that
recorded every launch the unit is known to make of the port's kernels.
The profiler can lose records, so an incomplete window counts for nothing
and the next one is taken (``chip_smoke.py::profile_window``'s rule).
``TraceWindow`` reduces a window to device operations, busy and window
seconds, time by kernel and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

# Profiler names of the port's kernels (anonymous namespace in the CUDA
# sources): A fwd_*_kernel, B wgrad_*_kernel, C dense_block_kernel_*,
# D gauss_kernel, E salt_pepper_kernel
PORT_KERNELS = {"A": "namespace)::fwd_", "B": "namespace)::wgrad_",
                "C": "namespace)::dense_block_kernel_",
                "D": "namespace)::gauss_kernel",
                "E": "namespace)::salt_pepper_kernel"}
# cuDNN and cuBLAS convolutions and matrix products, by name
LIBRARY_MARKS = ("cudnn", "xmma", "cutlass", "gemm", "nvjet",
                 "implicit_convolve", "convolve_", "winograd", "fft2d",
                 "fprop", "dgrad", "wgrad", "conv2d_c1_k1")


def port_kernel(name: str) -> str | None:
    for kernel, mark in PORT_KERNELS.items():
        if mark in name:
            return kernel
    return None


def is_glue(name: str) -> bool:
    """Neither one of the port's kernels nor a library conv or GEMM."""
    low = name.lower()
    return port_kernel(name) is None and not any(m in low
                                                 for m in LIBRARY_MARKS)


@dataclasses.dataclass
class TraceWindow:
    units: int
    ops: int
    busy_s: float
    window_s: float
    by_name: dict  # kernel name -> [launches, device seconds]
    gaps: dict  # host operation -> idle device seconds

    def kernel_s(self, kernels: str) -> float:
        """Device seconds of the port's kernels named in ``kernels``."""
        return sum(s for name, (_, s) in self.by_name.items()
                   if (port_kernel(name) or "-") in kernels)

    def launches(self, kernel: str) -> int:
        return sum(n for name, (n, _) in self.by_name.items()
                   if port_kernel(name) == kernel)

    def glue_s(self) -> float:
        return sum(s for name, (_, s) in self.by_name.items()
                   if is_glue(name))

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:200], v[1]] for k, v in ops],
                "idle_gaps": [[k[:200], v] for k, v in gaps]}

    @classmethod
    def from_events(cls, events, units: int) -> "TraceWindow":
        """From the profiler's events: each has ``name``, ``device_type``,
        ``time_range`` (start, end in microseconds) and
        ``is_user_annotation``."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in events:
            if getattr(e, "is_user_annotation", False):
                continue
            span = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type == DeviceType.CUDA:
                dev.append(span)
            elif e.device_type == DeviceType.CPU:
                host.append(span)
        if not dev:
            raise RuntimeError("the profiled window holds no device "
                               "operation")
        dev.sort()
        host.sort()
        by_name = collections.defaultdict(lambda: [0, 0.0])
        busy, gaps = 0.0, collections.defaultdict(float)
        cur_s, cur_e = dev[0][0], dev[0][1]
        starts = [h[0] for h in host]
        for start, end, name in dev:
            by_name[name][0] += 1
            by_name[name][1] += (end - start) * 1e-6
            if start > cur_e:
                busy += cur_e - cur_s
                gaps[_host_at(host, starts, (cur_e + start) / 2)] += (
                    start - cur_e) * 1e-6
                cur_s = start
            cur_e = max(cur_e, end)
        busy += cur_e - cur_s
        window = max(e for _, e, _ in dev) - dev[0][0]
        return cls(units, len(dev), busy * 1e-6, window * 1e-6,
                   dict(by_name), dict(gaps))


def _host_at(host, starts, t: float, look_back: int = 4000) -> str:
    """The innermost host operation running at time t."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 1 - look_back), -1):
        s, e, name = host[j]
        if e >= t and not name.startswith("ProfilerStep"):
            best = name  # latest start that still covers t: innermost
            break
    return best or "host: Python between operations"


class Tracer:
    """Profiles ``active`` units at a time, after ``wait`` units and one of
    warm-up, up to ``tries`` windows; ``step()`` closes a unit. ``expect``
    maps a port kernel ('A', 'B', ...) to its launches per unit."""

    def __init__(self, expect: dict[str, int], wait: int = 2,
                 active: int = 3, tries: int = 4):
        self.expect, self.active = expect, active
        self.window: TraceWindow | None = None
        self.incomplete: list[dict] = []
        self.wait, self.tries = wait, tries
        self.steps = 0
        self._prof = None

    @property
    def span(self) -> int:
        """Units from the start to the end of the last window."""
        return (self.wait + 1 + self.active) * self.tries

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=self.wait, warmup=1, active=self.active,
                              repeat=self.tries),
            on_trace_ready=self._ready)
        self._prof.start()

    @property
    def running(self) -> bool:
        return self._prof is not None

    def step(self) -> None:
        """Close one unit: a no-op once the tracer is done."""
        if self._prof is None:
            return
        torch.cuda.synchronize()
        self._prof.step()
        self.steps += 1
        if self.window is not None or self.steps >= self.span:
            self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()

    def _ready(self, prof) -> None:
        if self.window is None:
            self._ready_window(TraceWindow.from_events(prof.events(),
                                                       self.active))

    def _ready_window(self, tw: TraceWindow) -> None:
        """Keep ``tw`` if it holds every expected launch."""
        seen = {k: tw.launches(k) for k in self.expect}
        want = {k: n * self.active for k, n in self.expect.items()}
        if seen == want:
            self.window = tw
        else:
            self.incomplete.append(seen)
