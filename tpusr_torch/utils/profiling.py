"""Profiling hooks — the port of ``tpusr/utils/profiling.py`` — and the
engine's spans.

``maybe_trace`` wraps a block in ``torch.profiler.profile`` (CPU and, with
a card, CUDA activities) and writes a Chrome trace into the directory the
CLI's ``--profile_dir`` names.

``span(name, **fields)`` marks one unit of the engine's work: a DIP call,
iteration or head, a training step or its parts (the names are listed in
PERF.md). It is off unless an observer is registered (``observe``) or a
``torch.profiler`` is recording: then it is one shared no-op context, with
no device operation and no host sync. On, it keeps a ``SpanRecord`` and
hands it to every observer when it opens and when it closes; while a
profiler records, it also opens ``record_function(name)``, so the span lies
on the profiler's clock beside the kernels it launches and lands in the
profiler's Chrome trace. The unit spans sit in the loops that launch the
units, so whatever replaces a unit's body keeps its span.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
from torch.autograd.profiler import record_function

_profiling = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_observers: tuple = ()  # (on_enter, on_exit) pairs; replaced, never mutated
_observers_lock = threading.Lock()  # serialises observe and remove
_ids = itertools.count(1)
_local = threading.local()


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


class SpanRecord:
    """One span. ``parent`` is the id of the span open around it on its
    thread (None at the top); ``call`` the id of the outermost one, which
    every span of one engine call shares; ``start_ns`` and ``end_ns`` are
    ``time.perf_counter_ns()`` (``end_ns`` None while open); ``fields`` as
    given to ``span``; ``profiled`` whether a profiler recorded at any time
    while it was open."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns",
                 "fields", "profiled")

    def __init__(self, name: str, fields: dict):
        self.name, self.fields, self.id = name, fields, next(_ids)
        self.parent = self.call = self.start_ns = self.end_ns = None
        self.profiled = False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _mark_profiled(stack: list) -> None:
    for rec in stack:
        rec.profiled = True


class _Span:
    __slots__ = ("record", "_range")

    def __init__(self, record: SpanRecord):
        self.record, self._range = record, None

    def __enter__(self) -> SpanRecord:
        rec, stack = self.record, _stack()
        if stack:
            rec.parent, rec.call = stack[-1].id, stack[-1].call
        else:
            rec.call = rec.id
        for on_enter, _ in _observers:
            if on_enter is not None:
                on_enter(rec)
        stack.append(rec)
        if _profiling():
            _mark_profiled(stack)
            self._range = record_function(rec.name)
            self._range.__enter__()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stack()
        if _profiling():
            _mark_profiled(stack)
        stack.pop()
        for _, on_exit in _observers:
            if on_exit is not None:
                on_exit(rec)
        return False


def span(name: str, **fields):
    """A context for one unit of work named ``name``; yields its
    ``SpanRecord`` when spans are on, None when off."""
    if not _observers and not _profiling():
        return _OFF
    return _Span(SpanRecord(name, fields))


class _Observer:
    def __init__(self, pair: tuple):
        self._pair = pair

    def remove(self) -> None:
        global _observers
        with _observers_lock:
            _observers = tuple(o for o in _observers if o is not self._pair)


def observe(on_enter=None, on_exit=None) -> _Observer:
    """Register ``on_enter(record)`` and ``on_exit(record)`` (either may be
    None), called on the span's thread as each span opens and closes, an
    exception inside the span included; ``.remove()`` on the returned
    handle unregisters them."""
    global _observers
    pair = (on_enter, on_exit)
    with _observers_lock:
        _observers = _observers + (pair,)
    return _Observer(pair)
