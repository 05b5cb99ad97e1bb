"""Retry with graceful degradation: the backoff ladder for failed solves;
counterpart of ``repro/resilience/policy.py``, with the same defaults and
the same rungs but one knob (below).

A failed job (``JobResult.status`` in ``retry_on``) is re-admitted up to
``max_attempts`` times, each attempt under the next rung of a ladder of
safer knobs relative to the job's base config:

* ``beta_scale``: a larger regularization weight.  ``beta`` is a per-call
  argument of the cohort step (``gn.CohortStep``), so a beta-only rung
  rides the failing bucket's step: ``static_key`` is unchanged.
* ``field_dtype="float32"``: full-f32 fields; the port's fields are f32
  already, so this is the identity here.
* ``max_line_search``: a deeper Armijo budget.

The reference's last rung also sets ``interp_method="ref"``, its global
gather, to escape the halo budget of its distributed interpolation.  The
port's kernels wrap and have no halo budget, and they equal the plain
versions bit for bit, so that knob would change no arithmetic here: it
would only move a retry off the kernels.  The port's rung leaves
``interp_method`` as the job's config has it (``DegradeRung`` keeps the
field).

Rungs are relative to the base config, not cumulative, so
``degraded(cfg, attempt)`` is pure: resume re-derives a retry bucket's
config from ``(base cfg, attempt)`` alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.resilience import health


@dataclasses.dataclass(frozen=True)
class DegradeRung:
    """One ladder step: overrides of the base ``GNConfig``; ``None`` leaves
    the base value.  ``beta_scale`` multiplies the base beta and each entry
    of ``beta_continuation``."""

    beta_scale: float = 10.0
    field_dtype: str | None = None
    interp_method: str | None = None
    max_line_search: int | None = None
    max_cg: int | None = None


#: attempt 2: a safer beta only, on the primary bucket's step.
#: attempt 3+: f32 fields and a deeper line search (a step of its own).
DEFAULT_LADDER = (
    DegradeRung(beta_scale=10.0),
    DegradeRung(beta_scale=100.0, field_dtype="float32", max_line_search=20),
)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How failed jobs are re-admitted.

    ``retry_on`` are the ``JobResult.status`` strings that trigger a retry.
    ``warm_start=True`` seeds the retry from the failed attempt's last
    iterate when it is finite, else from the job's ``v0``.
    """

    max_attempts: int = 2
    retry_on: tuple[str, ...] = health.FAILED_NAMES + ("max_newton",)
    ladder: tuple[DegradeRung, ...] = DEFAULT_LADDER
    warm_start: bool = True

    def rung(self, attempt: int) -> DegradeRung:
        """Ladder rung for ``attempt`` (attempt 1 is the undegraded solve)."""
        if attempt < 2:
            raise ValueError(f"attempt {attempt} is not a retry")
        return self.ladder[min(attempt - 2, len(self.ladder) - 1)]

    def degraded(self, cfg: Any, attempt: int) -> Any:
        """The ``GNConfig`` of retry ``attempt`` of a job served under
        ``cfg``; pure in ``(cfg, attempt)``."""
        if attempt <= 1:
            return cfg
        rung = self.rung(attempt)
        updates: dict[str, Any] = {
            "beta": cfg.beta * rung.beta_scale,
            "beta_continuation": tuple(b * rung.beta_scale for b in cfg.beta_continuation),
        }
        if rung.field_dtype is not None:
            updates["field_dtype"] = rung.field_dtype
        if rung.interp_method is not None:
            updates["interp_method"] = rung.interp_method
        if rung.max_line_search is not None:
            updates["max_line_search"] = max(cfg.max_line_search, rung.max_line_search)
        if rung.max_cg is not None:
            updates["max_cg"] = rung.max_cg
        return dataclasses.replace(cfg, **updates)


def static_key(cfg: Any) -> Any:
    """Step identity of a ``GNConfig``: everything but the per-call
    ``beta``.  The server keeps one cohort step per (shape, static key), so
    a beta-only rung retries through the primary bucket's step."""
    return dataclasses.replace(cfg, beta=0.0, beta_continuation=())
