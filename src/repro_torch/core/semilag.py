"""Semi-Lagrangian transport solvers (paper §III-B2, eq. (6)-(7), Alg. 2);
counterpart of ``repro/core/semilag.py``.

Unconditionally stable RK2 along characteristics, so ``n_t = 4`` time steps
suffice.  Every solver takes an ``SLPlan`` (departure points plus the
precomputed ``InterpPlan`` operators) and an ``Interp`` executor; each
interpolation is one planned apply, ``tricubic_apply_cuda`` on the card.
The fields of one RK2 stage ride one batched call (e.g. ``lam`` with
``lam * div v`` in the compressible adjoint, C = 2).  ``lax.scan`` becomes
a Python loop.  A cohort of S subjects runs the same solvers on (S, N..)
scalars and (S, 3, N..) vectors with a cohort plan: the stacks of a stage
are then (C, S, N..), the subject axis at -4.

General scheme for  d_t nu + v . grad nu = f  (paper eq. (7)):

    nu0X  = nu(X, t)            (interpolated at departure points)
    f0X   = f(., t) at X        (f formed on the grid, then interpolated)
    nu*   = nu0X + dt f0X
    f*    = f(., t+dt) at x     (on the grid)
    nu(x, t+dt) = nu0X + dt/2 (f0X + f*)
"""
from __future__ import annotations

import torch

from repro_torch.core.planner import SLPlan
from repro_torch.kernels import ops as kops


def _bind(interp, iplan):
    """Resolve one cached ``InterpPlan`` to a batched applier ``fields -> out``."""
    interp = interp or kops.make_interp()
    return lambda fields: interp.apply_plan(fields, iplan)


def _bind_fwd(plan: SLPlan, interp):
    return _bind(interp, plan.iplan_fwd)


def _bind_adj(plan: SLPlan, interp):
    if plan.iplan_adj is None:
        raise ValueError(
            "forward-only SLPlan (make_plan(adjoint=False)) has no adjoint "
            "departure field; rebuild with adjoint=True for backward transports"
        )
    return _bind(interp, plan.iplan_adj)


# --------------------------------------------------------------------------- #
# state equation (2b): pure advection, forward in time
# --------------------------------------------------------------------------- #
def transport_state(rho0: torch.Tensor, plan: SLPlan, interp=None) -> torch.Tensor:
    """Solve d_t rho + v.grad rho = 0; returns all slices (n_t+1, ...)."""
    at_fwd = _bind_fwd(plan, interp)
    series = [rho0]
    for _ in range(plan.n_t):
        series.append(at_fwd(series[-1]))
    return torch.stack(series)


# --------------------------------------------------------------------------- #
# adjoint equation (3): -d_t lam - div(v lam) = 0, backward in time.
# In tau = 1-t:  d_tau lam + (-v).grad lam = lam div v.
# --------------------------------------------------------------------------- #
def transport_adjoint(lam1: torch.Tensor, plan: SLPlan, interp=None) -> torch.Tensor:
    """Returns lam at all t-slices, index k = t_k (so [-1] is t=1)."""
    at_adj = _bind_adj(plan, interp)
    dt = plan.dt
    divv = plan.divv
    series_tau = [lam1]
    for _ in range(plan.n_t):
        lam = series_tau[-1]
        if divv is None:
            series_tau.append(at_adj(lam))
        else:
            # lam and lam*divv share one batched interpolation (C=2)
            lam0X, f0X = at_adj(torch.stack([lam, lam * divv]))
            lam_star = lam0X + dt * f0X
            f_star = lam_star * divv
            series_tau.append(lam0X + 0.5 * dt * (f0X + f_star))
    return torch.stack(series_tau[::-1])  # tau-order -> t-order


# --------------------------------------------------------------------------- #
# incremental state equation (5a) (Alg. 2):
#   d_t rho~ + v.grad rho~ = -v~ . grad rho(t),  rho~(0) = 0
# --------------------------------------------------------------------------- #
def _inc_state_slices(vtilde, grad_rho_series, plan: SLPlan, interp):
    """rho~(t_0), rho~(t_1), ..., rho~(t_{n_t}), one slice at a time."""
    at_fwd = _bind_fwd(plan, interp)
    dt = plan.dt

    def source(k):
        return -torch.sum(vtilde * grad_rho_series[k], dim=-4)

    rt = torch.zeros_like(grad_rho_series[0][..., 0, :, :, :])
    yield rt
    for k in range(plan.n_t):
        rt0X, f0X = at_fwd(torch.stack([rt, source(k)]))  # C=2 batched
        rt = rt0X + 0.5 * dt * (f0X + source(k + 1))
        yield rt


def transport_inc_state(
    vtilde: torch.Tensor, grad_rho_series: torch.Tensor, plan: SLPlan, interp=None
) -> torch.Tensor:
    """Returns rho~(1) (only the final slice is needed for Gauss-Newton);
    the earlier slices are dropped as the next one is formed."""
    for rho1 in _inc_state_slices(vtilde, grad_rho_series, plan, interp):
        pass
    return rho1


# --------------------------------------------------------------------------- #
# incremental adjoint (5c), Gauss-Newton form: the adjoint operator
# --------------------------------------------------------------------------- #
def transport_inc_adjoint(lam1: torch.Tensor, plan: SLPlan, interp=None) -> torch.Tensor:
    return transport_adjoint(lam1, plan, interp)


# --------------------------------------------------------------------------- #
# incremental adjoint, full Newton form (paper eq. (5c) with every term):
#   -d_t lam~ - div(lam~ v + lam vt) = 0,  lam~(1) = -rho~(1)
# In tau: d_tau lam~ + (-v).grad lam~ = lam~ div v + div(lam(t) vt).
# --------------------------------------------------------------------------- #
def transport_inc_adjoint_newton(
    lam1: torch.Tensor,
    lam_series: torch.Tensor,
    vtilde: torch.Tensor,
    plan: SLPlan,
    spectral_ops,
    interp=None,
    div_lam_vt: torch.Tensor | None = None,
) -> torch.Tensor:
    """Returns lam~ at all t-slices (n_t+1, N..), t-order.  ``lam_series``
    is lam(t_k) in t-order; ``div_lam_vt`` supplies div(lam(t_k) vt) for
    every k (``objective.full_hessian_matvec`` coalesces its transform
    with another), else it costs one batched transform pair here."""
    at_adj = _bind_adj(plan, interp)
    dt = plan.dt
    n_t = plan.n_t
    divv = plan.divv
    if div_lam_vt is None:
        div_lam_vt = spectral_ops.div(lam_series[:, None] * vtilde[None])

    def source(lam_t, k):
        f = div_lam_vt[k]
        if divv is not None:
            f = f + lam_t * divv
        return f

    series_tau = [lam1]
    for j in range(n_t):
        lamt = series_tau[-1]
        k = n_t - j  # current t-index (tau_j = 1 - t)
        lam0X, f0X = at_adj(torch.stack([lamt, source(lamt, k)]))  # C=2 batched
        lam_star = lam0X + dt * f0X
        f_star = source(lam_star, k - 1)
        series_tau.append(lam0X + 0.5 * dt * (f0X + f_star))
    return torch.stack(series_tau[::-1])  # tau-order -> t-order


def transport_inc_state_series(
    vtilde: torch.Tensor, grad_rho_series: torch.Tensor, plan: SLPlan, interp=None
) -> torch.Tensor:
    """``transport_inc_state`` returning every slice (n_t+1, N..): full
    Newton needs grad rho~(t_k) for the second b~ term."""
    return torch.stack(list(_inc_state_slices(vtilde, grad_rho_series, plan, interp)))


# --------------------------------------------------------------------------- #
# time quadrature:  b = int_0^1 lam(t) grad rho(t) dt   (trapezoidal)
# --------------------------------------------------------------------------- #
def time_integral_b(
    lam_series: torch.Tensor, grad_rho_series: torch.Tensor, dt: float
) -> torch.Tensor:
    """lam_series (n_t+1, N..), grad_rho_series (n_t+1, 3, N..) -> (3, N..);
    for a cohort, lam (n_t+1, S, N..) and grad (n_t+1, S, 3, N..) ->
    (S, 3, N..).

    A broadcast product and a sum over t.  ``torch.einsum`` lowers this
    contraction to a cuBLAS gemv that took 15.6 ms per call at 256^3 on an
    H100 (``chip_smoke.py``'s profile phase); this form adds about 0.5 ms.
    """
    n = lam_series.shape[0]
    w = torch.full((n,), dt, dtype=torch.float32, device=lam_series.device)
    w[0] *= 0.5
    w[-1] *= 0.5
    wlam = w.reshape((n,) + (1,) * (lam_series.ndim - 1)) * lam_series
    return torch.sum(wlam.unsqueeze(-4) * grad_rho_series, dim=0)


# --------------------------------------------------------------------------- #
# deformation map (1): d_t y + v.grad y = 0, y(x,0) = x, solved for the
# periodic displacement u = y - x:  d_t u + v.grad u = -v,  u(0) = 0.
# --------------------------------------------------------------------------- #
def deformation_displacement(v: torch.Tensor, plan: SLPlan, interp=None) -> torch.Tensor:
    """Returns u(1) (3, N1,N2,N3) in physical units; y1 = x + u.  A cohort
    velocity (S, 3, N..) returns per-subject displacements (S, 3, N..): the
    component axis is swapped into the channel slot around each batched
    interpolation, whose subject axis is -4."""
    at = _bind_fwd(plan, interp)
    if v.ndim == 5:
        def at_fwd(x):
            return torch.swapaxes(at(torch.swapaxes(x, 0, 1)), 0, 1)
    else:
        at_fwd = at
    dt = plan.dt
    f = -v
    # f is time-independent, so f(X) is the same every step (C=3, once)
    f0X = at_fwd(f)
    u = torch.zeros_like(v)
    for _ in range(plan.n_t):
        u = at_fwd(u) + 0.5 * dt * (f0X + f)
    return u
