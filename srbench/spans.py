"""The program's spans, kept for the per-layer metrics of traced runs.

Importing this module registers an observer with the program
(``tpusr_torch.utils.profiling.observe``) that keeps every finished span
as a ``Unit`` in ``records``. ``srbench.run`` loads the metric readers,
which import this module, only under ``--trace 1`` and before the driver's
set-up, so spans are on in traced runs alone and the timed runs never see
them.

A unit counts when it ran with the profiler off and began after the first
profiled span of the run ended: that leaves out the set-up's and warm-up's
calls, which come before the profiled window, and the profiled units,
which the profiler slows. A program without spans (before they were added)
keeps nothing, and every reader then returns None.
"""

from __future__ import annotations

from typing import NamedTuple


class Unit(NamedTuple):
    """A finished span: what the readers need of the program's record,
    its scalar fields alone (no tensor or optimizer is kept alive)."""

    name: str
    id: int
    parent: int | None
    call: int
    start_ns: int
    end_ns: int
    profiled: bool
    fields: dict

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


records: list[Unit] = []


def _keep(rec) -> None:
    records.append(Unit(
        rec.name, rec.id, rec.parent, rec.call, rec.start_ns, rec.end_ns,
        rec.profiled, {k: v for k, v in rec.fields.items()
                       if isinstance(v, (bool, int, float, str))}))


try:
    from tpusr_torch.utils.profiling import observe
except ImportError:  # a program without spans
    observe = None
handle = observe(None, _keep) if observe is not None else None


def counted(name: str) -> list[Unit]:
    """The units named ``name`` that count (see the module's docstring)."""
    first = next((u for u in records if u.profiled), None)
    if first is None:
        return []
    return [u for u in records if u.name == name and not u.profiled
            and u.start_ns >= first.end_ns]


def within(calls: list[Unit], name: str) -> list[Unit]:
    """The units named ``name`` of the engine calls ``calls``."""
    ids = {c.call for c in calls}
    return [u for u in records if u.name == name and u.call in ids]


def mean_ms(units: list[Unit]) -> float | None:
    if not units:
        return None
    return sum(u.ms for u in units) / len(units)
