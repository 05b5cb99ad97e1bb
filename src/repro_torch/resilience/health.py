"""Health guards: status codes for one Gauss-Newton iteration; counterpart
of ``repro/resilience/health.py`` (single subject).

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

FAILED_CODES = (NONFINITE, DIVERGED, PCG_BREAKDOWN)

# relative objective increase at the last Armijo trial above which an
# exhausted line search counts as divergence rather than stagnation
DIVERGE_RTOL = 1e-3


def status_name(code) -> str:
    return STATUS_NAMES.get(int(code), f"status{int(code)}")


def is_failure(code) -> bool:
    return int(code) in FAILED_CODES


def _finite(x) -> torch.Tensor:
    return torch.all(torch.isfinite(torch.as_tensor(x)))


def classify(*, v_in, v_out, j_val, j_new, gnorm, pcg_x, pcg_rel, accepted) -> torch.Tensor:
    """Status of one Newton step, as an int32 scalar tensor.

    Precedence (strongest wins): NONFINITE > PCG_BREAKDOWN > DIVERGED >
    STAGNATED > OK.  Convergence and the iteration cap are decided by
    ``gn.solve``, which maps them onto CONVERGED / MAX_NEWTON.
    """
    accepted = torch.as_tensor(accepted)
    state_finite = _finite(j_val) & _finite(gnorm) & _finite(v_in)
    pcg_finite = _finite(pcg_x) & _finite(pcg_rel)
    out_finite = _finite(v_out) & _finite(j_new)
    scale = torch.clamp(torch.abs(j_val), min=1e-30)
    increased = (j_new - j_val) > DIVERGE_RTOL * scale

    status = torch.where(
        ~accepted,
        torch.where(increased, DIVERGED, STAGNATED),
        torch.tensor(OK, device=increased.device),
    )
    status = torch.where(state_finite & ~pcg_finite, PCG_BREAKDOWN, status)
    status = torch.where(~(state_finite & out_finite), NONFINITE, status)
    return status.to(torch.int32)


def freeze(v_new: torch.Tensor, v_old: torch.Tensor, status) -> torch.Tensor:
    """Revert a NONFINITE iterate to the last good one (no-op otherwise)."""
    return torch.where(torch.as_tensor(status) == NONFINITE, v_old, v_new)
