"""Deterministic fault injection, the chaos harness of the resilience tests
and ``chip_smoke.py``'s ``resilience_path`` and ``resume_path``;
counterpart of ``repro/resilience/faults.py``.

Faults are host-side server hooks: a ``CohortServer`` calls every entry of
``server.hooks`` at the top of each ``step()``, so an injector can poison
slot state or abort the loop at an exact iteration without touching the
cohort step.  Every firing emits a ``FaultEvent`` and adds to the
``resilience.faults_injected`` counter.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch import telemetry

COUNTER_INJECTED = "resilience.faults_injected"


class SimulatedCrash(RuntimeError):
    """Raised by ``KillAt``: stands in for a killed serve process."""


@dataclasses.dataclass
class NaNInjector:
    """Poison one job's slot state at one server iteration, once.

    ``field``: ``"v"`` (the slot iterate) or ``"rho_R"``/``"rho_T"`` (an
    input image).  ``element=None`` poisons the whole slot; an index tuple
    one entry of it.  The NaN is written in place into the server's slot
    tensor, on the server's device.
    """

    job_id: Any
    field: str = "v"
    at_iteration: int = 1
    element: tuple | None = None
    fired: bool = dataclasses.field(default=False, init=False)

    def __call__(self, server) -> None:
        if self.fired or server.iterations != self.at_iteration:
            return
        slot = next((s for s, job in enumerate(server._jobs)
                     if job is not None and job.job_id == self.job_id), None)
        if slot is None:
            return
        slab = getattr(server, {"v": "_v", "rho_R": "_rho_R", "rho_T": "_rho_T"}[self.field])
        if self.element is None:
            slab[slot] = float("nan")
        else:
            slab[(slot,) + tuple(self.element)] = float("nan")
        self.fired = True
        telemetry.emit(
            telemetry.FaultEvent(
                fault="nan_injection",
                target=str(self.job_id),
                iteration=int(server.iterations),
                attrs={"field": self.field, "slot": slot,
                       "element": list(self.element) if self.element else None},
            )
        )
        telemetry.counter(COUNTER_INJECTED, fault="nan_injection")


@dataclasses.dataclass
class KillAt:
    """Abort the serve loop at an exact server iteration (after the
    snapshot of the round before it, if one was due) by raising
    ``SimulatedCrash``: the stand-in for ``kill -9`` mid-stream."""

    at_iteration: int
    fired: bool = dataclasses.field(default=False, init=False)

    def __call__(self, server) -> None:
        if self.fired or server.iterations < self.at_iteration:
            return
        self.fired = True
        telemetry.emit(
            telemetry.FaultEvent(fault="kill", target="serve_loop",
                                 iteration=int(server.iterations))
        )
        telemetry.counter(COUNTER_INJECTED, fault="kill")
        raise SimulatedCrash(f"simulated kill at serve iteration {server.iterations}")


def overflow_displacement(shape, halo: int, excess: float = 2.5, dtype=np.float32):
    """A constant displacement ``halo + excess`` voxels on every axis: it
    exceeds a halo budget of ``halo`` and is exact under periodic wrap.
    (The port's kernels wrap and need no halo; the distributed slice,
    ROADMAP Queue A item 13, will.)"""
    mag = float(halo) + float(excess)
    d = np.full((3,) + tuple(shape), mag, dtype=dtype)
    telemetry.emit(
        telemetry.FaultEvent(fault="halo_overflow", target=f"halo={halo}",
                             attrs={"magnitude": mag, "shape": list(shape)})
    )
    telemetry.counter(COUNTER_INJECTED, fault="halo_overflow")
    return d
