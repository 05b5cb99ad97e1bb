"""``repro_torch.resilience``: fault-tolerant solve and serve; counterpart
of ``repro/resilience``.

* ``health``: per-subject status codes of a Newton step (NaN/Inf,
  divergence, stagnation, PCG breakdown) and the freeze of a sick iterate.
* ``policy``: the retry ladder of degraded configs (``RetryPolicy``).
* ``faults``: deterministic NaN injection and kill-at-iteration hooks.
* ``atomic``: the crash-safe JSON writer.

``launch.reg_serve.serve_jobs`` threads them together with
``ckpt.manager.CheckpointManager`` (retry, snapshot, resume).
"""
from repro_torch.resilience import health
from repro_torch.resilience.atomic import atomic_write_json
from repro_torch.resilience.faults import (
    KillAt,
    NaNInjector,
    SimulatedCrash,
    overflow_displacement,
)
from repro_torch.resilience.policy import DEFAULT_LADDER, DegradeRung, RetryPolicy, static_key

__all__ = [
    "health",
    "atomic_write_json",
    "KillAt",
    "NaNInjector",
    "SimulatedCrash",
    "overflow_displacement",
    "DEFAULT_LADDER",
    "DegradeRung",
    "RetryPolicy",
    "static_key",
]
