"""Health guards: status codes for one Gauss-Newton iteration; counterpart
of ``repro/resilience/health.py``, for one subject or per subject of a
cohort.

``classify`` turns values the Newton step already computed into one status
code (NaN/Inf, divergence, PCG breakdown, stagnation), and ``freeze``
reverts a non-finite iterate to the last good one.  The codes and names are
the reference's, so telemetry and retry policies read both packages alike.
"""
from __future__ import annotations

import torch

# ---- status codes (stable contract for telemetry) --------------------------
OK = 0  # still iterating
CONVERGED = 1  # rel gradient norm under gtol (host-side test)
STAGNATED = 2  # zero-step exit: Armijo exhausted without a decrease
MAX_NEWTON = 3  # iteration cap reached without convergence (host-side)
NONFINITE = 4  # NaN/Inf in gradient/objective/iterate
DIVERGED = 5  # Armijo exhausted AND the objective increased
PCG_BREAKDOWN = 6  # non-finite Newton direction / PCG residual

STATUS_NAMES = {
    OK: "in_progress",
    CONVERGED: "converged",
    STAGNATED: "stagnated",
    MAX_NEWTON: "max_newton",
    NONFINITE: "nonfinite",
    DIVERGED: "diverged",
    PCG_BREAKDOWN: "pcg_breakdown",
}

# statuses that mean "this solve went wrong", not "this solve finished"
FAILED_NAMES = ("nonfinite", "diverged", "pcg_breakdown")
FAILED_CODES = (NONFINITE, DIVERGED, PCG_BREAKDOWN)

# relative objective increase at the last Armijo trial above which an
# exhausted line search counts as divergence rather than stagnation
DIVERGE_RTOL = 1e-3


def status_name(code) -> str:
    return STATUS_NAMES.get(int(code), f"status{int(code)}")


def is_failure(code) -> bool:
    return int(code) in FAILED_CODES


def _all_finite(x, axes) -> torch.Tensor:
    """All-finite over every axis (``axes=None``) or over ``axes``, keeping
    the others (the cohort's subject axis)."""
    f = torch.isfinite(torch.as_tensor(x))
    return torch.all(f) if axes is None else torch.all(f, dim=tuple(axes))


def classify(*, v_in, v_out, j_val, j_new, gnorm, pcg_x, pcg_rel, accepted, active=True,
             axes=None) -> torch.Tensor:
    """Status of one Newton step, as an int32 tensor.

    With ``axes=None`` every reduction is global and the status a scalar
    (the single solve); with ``axes=(1, 2, 3, 4)`` the reductions keep the
    leading subject axis and the status is per subject, (S,) (the cohort,
    whose inactive subjects, ``active`` False, stay OK).

    Precedence (strongest wins): NONFINITE > PCG_BREAKDOWN > DIVERGED >
    STAGNATED > OK.  Convergence and the iteration cap are decided by
    the drivers, which map them onto CONVERGED / MAX_NEWTON.
    """
    j_val = torch.as_tensor(j_val)
    accepted = torch.as_tensor(accepted, device=j_val.device)
    active = torch.as_tensor(active, dtype=torch.bool, device=j_val.device)
    state_finite = torch.isfinite(j_val) & torch.isfinite(gnorm) & _all_finite(v_in, axes)
    pcg_finite = _all_finite(pcg_x, axes) & torch.isfinite(pcg_rel)
    out_finite = _all_finite(v_out, axes) & torch.isfinite(j_new)
    scale = torch.clamp(torch.abs(j_val), min=1e-30)
    increased = (j_new - j_val) > DIVERGE_RTOL * scale

    status = torch.where(
        active & ~accepted,
        torch.where(increased, DIVERGED, STAGNATED),
        torch.tensor(OK, device=increased.device),
    )
    status = torch.where(active & state_finite & ~pcg_finite, PCG_BREAKDOWN, status)
    status = torch.where(active & ~(state_finite & out_finite), NONFINITE, status)
    return status.to(torch.int32)


def freeze(v_new: torch.Tensor, v_old: torch.Tensor, status) -> torch.Tensor:
    """Revert a NONFINITE iterate to the last good one (no-op otherwise); a
    per-subject status (S,) reverts those subjects of a cohort."""
    sick = torch.as_tensor(status) == NONFINITE
    return torch.where(sick.reshape(sick.shape + (1,) * (v_new.ndim - sick.ndim)), v_old, v_new)
