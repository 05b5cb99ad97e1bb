"""Minimal telemetry for the port: spans, counters, and the ``newton_iter``,
``level_start``, ``level``, ``solve``, ``job``, ``serve_step``, ``fault``
and ``recovery`` records of ``repro.telemetry``'s schema v1 (same field
names, so ``repro.analysis.trace_report`` reads the port's traces), with
the schema's check, ``validate_record``.  ``annotate`` names a region in
``torch.profiler`` traces.

Off by default: with no sink installed a span reads no clock and does not
synchronise, and ``emit`` builds no record.  A sink is any object with a
``write(record: dict)`` method; ``ListSink`` keeps records in memory and
``JsonlSink`` appends them to a file.
"""
from __future__ import annotations

import dataclasses
import json
import numbers
import time
from typing import Any, ClassVar

import torch

SCHEMA_VERSION = 1

_SINKS: list[Any] = []
_COUNTERS: dict[str, float] = {}


class ListSink:
    """Keeps every record; a context manager installs and removes it."""

    def __init__(self):
        self.records: list[dict] = []

    def write(self, record: dict) -> None:
        self.records.append(record)

    def __enter__(self) -> "ListSink":
        add_sink(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        remove_sink(self)


class JsonlSink(ListSink):
    """Appends every record as one JSON line to ``path`` (the format
    ``python -m repro.analysis.trace_report`` reads); a context manager
    installs it, and removes and closes it."""

    def __init__(self, path):
        super().__init__()
        self._file = open(path, "a")

    def write(self, record: dict) -> None:
        self._file.write(json.dumps(record) + "\n")

    def __exit__(self, exc_type, exc, tb) -> None:
        remove_sink(self)
        self._file.close()


def add_sink(sink: Any) -> Any:
    _SINKS.append(sink)
    return sink


def remove_sink(sink: Any) -> None:
    if sink in _SINKS:
        _SINKS.remove(sink)


def _clean(x):
    """JSON-ready copy: tensors and numpy scalars become Python numbers."""
    if isinstance(x, dict):
        return {str(k): _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    if isinstance(x, bool) or x is None or isinstance(x, (str, int, float)):
        return x
    if isinstance(x, numbers.Integral):
        return int(x)
    if isinstance(x, numbers.Real):
        return float(x)
    if hasattr(x, "tolist"):
        return _clean(x.tolist())
    return str(x)


@dataclasses.dataclass
class Event:
    kind: ClassVar[str] = ""

    def to_record(self) -> dict:
        rec = {"v": SCHEMA_VERSION, "ts": time.time(), "kind": self.kind}
        for f in dataclasses.fields(self):
            rec[f.name] = _clean(getattr(self, f.name))
        return rec


@dataclasses.dataclass
class SpanEvent(Event):
    kind: ClassVar[str] = "span"
    name: str
    wall_s: float
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class NewtonIterEvent(Event):
    """One Newton iteration of ``gn.solve`` (scalars) or ``gn.solve_cohort``
    (per-subject lists in the same fields; ``subjects`` > 0, ``active`` the
    cohort's live mask)."""

    kind: ClassVar[str] = "newton_iter"
    source: str
    beta: float
    iter: int
    j_val: Any
    misfit: Any
    reg: Any
    gnorm: Any
    rel_gnorm: Any
    cg_iters: Any
    step_len: Any
    armijo_trials: int = 0
    wall_s: float | None = None
    level: int | None = None
    subjects: int = 0
    active: Any = None


@dataclasses.dataclass
class LevelEvent(Event):
    """One completed ladder level of ``multilevel.solve``."""

    kind: ClassVar[str] = "level"
    level: int
    shape: list
    betas: list
    warm_start: bool
    newton_iters: int
    hessian_matvecs: int
    fine_equiv_matvecs: float
    precond_fine_equiv_matvecs: float
    wall_s: float
    rel_gnorm: float | None = None


@dataclasses.dataclass
class LevelStartEvent(Event):
    kind: ClassVar[str] = "level_start"
    level: int
    n_levels: int
    shape: list
    betas: list
    warm_start: bool


@dataclasses.dataclass
class JobEvent(Event):
    """One retired job of ``launch.reg_serve``: its billing (the Hessian
    matvecs its own masked PCG took) and its retirement reason."""

    kind: ClassVar[str] = "job"
    job_id: str
    newton_iters: int
    hessian_matvecs: int
    fine_equiv_matvecs: float
    rel_gnorm: float
    converged: bool
    slot: int = -1
    queue_wait_steps: int = 0  # cohort iterations spent queued before a slot
    admitted_step: int = 0  # server iterations when the job entered its slot
    retired_step: int = 0
    block: list | None = None
    status: str = ""
    attempts: int = 1


@dataclasses.dataclass
class ServeStepEvent(Event):
    """One cohort iteration of a ``CohortServer``: the occupancy meter."""

    kind: ClassVar[str] = "serve_step"
    iteration: int
    slots: int
    occupancy: int  # live subjects this step
    queue_len: int
    refills: int  # slot fills after the initial ones, so far


@dataclasses.dataclass
class FaultEvent(Event):
    """One injected fault (``repro_torch.resilience.faults``)."""

    kind: ClassVar[str] = "fault"
    fault: str  # "nan_injection" | "kill" | "halo_overflow" | "guard_trip"
    target: str = ""  # job id, field or loop the fault hit
    iteration: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RecoveryEvent(Event):
    """One recovery action: "retry_degraded" | "resume_from_checkpoint" |
    "ckpt_fallback"."""

    kind: ClassVar[str] = "recovery"
    action: str
    job_id: str | None = None
    attempts: int | None = None  # the attempt the action admits or bills
    step: int | None = None  # checkpoint step or serve round involved
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CounterEvent(Event):
    kind: ClassVar[str] = "counter"
    name: str
    value: float
    total: float
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SolveEvent(Event):
    """End-of-solve summary: the meters ``gn.solve`` returns."""

    kind: ClassVar[str] = "solve"
    source: str
    newton_iters: Any
    hessian_matvecs: Any
    fine_equiv_matvecs: Any = None
    precond_fine_equiv_matvecs: Any = None
    compiled_executables: int | None = None
    wall_s: float | None = None


EVENT_KINDS = {
    cls.kind: cls
    for cls in (SpanEvent, NewtonIterEvent, LevelEvent, LevelStartEvent, JobEvent,
                ServeStepEvent, CounterEvent, SolveEvent, FaultEvent, RecoveryEvent)
}
# the fields each kind must carry: those without a default
_REQUIRED = {
    kind: tuple(f.name for f in dataclasses.fields(cls)
                if f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING)  # type: ignore[misc]
    for kind, cls in EVENT_KINDS.items()
}


def validate_record(rec: Any) -> list[str]:
    """Schema violations of one record, as ``repro.telemetry``'s
    ``validate_record`` finds them (empty: valid): the version, a
    timestamp, a known kind and its required fields."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    errs: list[str] = []
    if rec.get("v") != SCHEMA_VERSION:
        errs.append(f"schema version {rec.get('v')!r} != {SCHEMA_VERSION}")
    if not isinstance(rec.get("ts"), (int, float)):
        errs.append(f"ts {rec.get('ts')!r} is not a timestamp")
    kind = rec.get("kind")
    if kind not in _REQUIRED:
        return errs + [f"unknown kind {kind!r}"]
    return errs + [f"{kind}: missing required field {name!r}"
                   for name in _REQUIRED[kind] if name not in rec]


def emit(event: Event, echo: bool = False) -> dict | None:
    """Send ``event`` to every sink; ``echo=True`` also prints the record."""
    if not _SINKS and not echo:
        return None
    rec = event.to_record()
    for s in _SINKS:
        s.write(rec)
    if echo:
        print(rec)
    return rec


def annotate(name: str) -> torch.profiler.record_function:
    """Name a region in ``torch.profiler`` traces; usable as a context
    manager or a decorator.  Changes nothing that is computed."""
    return torch.profiler.record_function(name)


def counters() -> dict[str, float]:
    """A copy of the process-wide counter totals."""
    return dict(_COUNTERS)


def counter(name: str, value: float = 1.0, **attrs) -> float:
    """Add ``value`` to a named process-wide total and emit a CounterEvent."""
    total = _COUNTERS.get(name, 0.0) + float(value)
    _COUNTERS[name] = total
    emit(CounterEvent(name=name, value=float(value), total=total, attrs=attrs))
    return total


class span:
    """Host wall-clock span: ``with telemetry.span("gn.newton_iter") as sp``.

    With a sink installed, the exit synchronises ``device`` (when it is a
    CUDA device) before reading the clock, so the span holds the device
    time of its work; ``sp.wall_s`` then holds the seconds.  Without a sink
    it does nothing and ``wall_s`` stays ``None``.
    """

    __slots__ = ("name", "attrs", "device", "wall_s", "_t0")

    def __init__(self, name: str, device=None, **attrs):
        self.name = name
        self.attrs = attrs
        self.device = None if device is None else torch.device(device)
        self.wall_s: float | None = None
        self._t0: float | None = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "span":
        if not _SINKS:
            return self
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is None or exc_type is not None:
            return False
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        emit(SpanEvent(name=self.name, wall_s=self.wall_s, attrs=self.attrs))
        return False
