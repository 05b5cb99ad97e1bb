"""Objective, reduced gradient, and the Gauss-Newton and full Newton Hessian
matvecs (paper §II-B);
counterpart of ``repro/core/objective.py``.

    J[v]   = 1/2 ||rho(1) - rho_R||^2_L2 + beta/2 ||Lap v||^2_L2          (2a)
    g(v)   = beta Lap^2 v + P b,    b = int_0^1 lam grad rho dt           (4)
    H vt   = beta Lap^2 vt + P bt,  bt = int_0^1 lamt grad rho dt (GN)    (5e)

The full Newton Hessian (``full_hessian_matvec``) keeps every term of
eq. (5): the div(lam vt) source of the incremental adjoint and
int lam grad rho~ dt in bt.

``P`` is the Leray projection in incompressible mode, identity otherwise.
A ``NewtonState`` caches what the PCG matvecs of one Newton iteration
reuse: the SL plan (departure points and their ``InterpPlan`` operators),
the state series rho(t) and the spectral gradients grad rho(t_k).  The
spectral work rides the same coalesced transforms as the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import semilag
from repro_torch.core.grid import Grid
from repro_torch.core.planner import SLPlan, make_plan
from repro_torch.core.spectral import SpectralOps


class Problem(NamedTuple):
    grid: Grid
    rho_R: torch.Tensor  # (N1, N2, N3); a cohort's (S, N1, N2, N3)
    rho_T: torch.Tensor
    beta: float
    n_t: int
    incompressible: bool


class NewtonState(NamedTuple):
    """Per-Newton-iteration cache shared by gradient and all Hessian matvecs."""

    v: torch.Tensor
    plan: SLPlan
    rho_series: torch.Tensor  # (n_t+1, N1,N2,N3)
    grad_rho_series: torch.Tensor  # (n_t+1, 3, N1,N2,N3)
    lam_series: torch.Tensor  # (n_t+1, N1,N2,N3)
    g: torch.Tensor  # reduced gradient (3, N1,N2,N3)
    misfit: torch.Tensor  # 1/2 ||rho(1)-rho_R||^2
    reg: torch.Tensor  # beta/2 ||Lap v||^2
    j_val: torch.Tensor


def _project(ops: SpectralOps, field: torch.Tensor, incompressible: bool) -> torch.Tensor:
    return ops.leray(field) if incompressible else field


def _norm_sq(grid: Grid, x: torch.Tensor, cohort: bool) -> torch.Tensor:
    return grid.norm_sq_per(x) if cohort else grid.norm_sq(x)


def evaluate_objective(
    v: torch.Tensor, prob: Problem, ops: SpectralOps, interp=None, plan: SLPlan | None = None
):
    """J(v): one forward transport + the Parseval regularization energy.

    Returns ``(J, (misfit, reg, rho_series, plan))``.  Without ``plan`` a
    forward-only plan is built (an Armijo trial never transports backward),
    and in compressible mode ``div v`` shares the energy's forward transform.
    A cohort velocity (S, 3, N..) with images (S, N..) gives per-subject
    (S,) values.
    """
    cohort = v.ndim == 5
    with ops.batch() as sb:
        h_reg = sb.reg_energy(v, prob.beta)
        h_div = sb.div(v) if (plan is None and not prob.incompressible) else None
    if plan is None:
        plan = make_plan(
            v, prob.grid, ops, prob.n_t, prob.incompressible, interp, adjoint=False,
            divv=None if h_div is None else h_div.get(),
        )
    rho_series = semilag.transport_state(prob.rho_T, plan, interp)
    misfit = 0.5 * _norm_sq(prob.grid, rho_series[-1] - prob.rho_R, cohort)
    reg = h_reg.get()
    return misfit + reg, (misfit, reg, rho_series, plan)


def newton_state(v: torch.Tensor, prob: Problem, ops: SpectralOps, interp=None) -> NewtonState:
    """Forward + adjoint solves, reduced gradient, and the matvec cache.

    Every v-only spectral op (``div v``, ``beta Lap^2 v``, the energy) rides
    one coalesced transform pair; the gradient series is one batched
    transform over all time slices; in incompressible mode ``P b`` costs one
    more.  A cohort (``v`` (S, 3, N..)) shares every one of them across its
    subjects, and its misfit, energy and J are per subject, (S,).
    """
    cohort = v.ndim == 5
    with ops.batch() as sb:
        h_divv = None if prob.incompressible else sb.div(v)
        h_regv = sb.reg_apply(v, prob.beta)
        h_reg_e = sb.reg_energy(v, prob.beta)
    plan = make_plan(
        v, prob.grid, ops, prob.n_t, prob.incompressible, interp,
        divv=None if h_divv is None else h_divv.get(),
    )
    rho_series = semilag.transport_state(prob.rho_T, plan, interp)
    rho1 = rho_series[-1]
    # adjoint terminal condition lam(1) = rho_R - rho(1)   (eq. 3)
    lam_series = semilag.transport_adjoint(prob.rho_R - rho1, plan, interp)
    # grad rho(t_k) for all k in one batched transform, the component axis
    # at -4: (n_t+1, 3, N..), a cohort's (n_t+1, S, 3, N..)
    grad_rho_series = torch.movedim(ops.grad(rho_series), 0, -4)
    b = semilag.time_integral_b(lam_series, grad_rho_series, plan.dt)
    g = h_regv.get() + _project(ops, b, prob.incompressible)
    misfit = 0.5 * _norm_sq(prob.grid, rho1 - prob.rho_R, cohort)
    reg = h_reg_e.get()
    return NewtonState(
        v=v,
        plan=plan,
        rho_series=rho_series,
        grad_rho_series=grad_rho_series,
        lam_series=lam_series,
        g=g,
        misfit=misfit,
        reg=reg,
        j_val=misfit + reg,
    )


def gn_hessian_matvec(
    vtilde: torch.Tensor, state: NewtonState, prob: Problem, ops: SpectralOps, interp=None
) -> torch.Tensor:
    """Gauss-Newton Hessian action, eq. (5) with the lambda terms dropped.

    Two transport solves (incremental state forward, incremental adjoint
    backward), both interpolation-only thanks to the grad-rho cache, plus
    ``beta Lap^2 vt + P bt`` in one transform pair.
    """
    rho1_t = semilag.transport_inc_state(vtilde, state.grad_rho_series, state.plan, interp)
    lamt_series = semilag.transport_inc_adjoint(-rho1_t, state.plan, interp)
    bt = semilag.time_integral_b(lamt_series, state.grad_rho_series, state.plan.dt)
    if prob.incompressible:
        return ops.reg_plus_project(vtilde, bt, prob.beta, True)
    return ops.reg_apply(vtilde, prob.beta) + bt


def full_hessian_matvec(
    vtilde: torch.Tensor, state: NewtonState, prob: Problem, ops: SpectralOps, interp=None
) -> torch.Tensor:
    """Full Newton Hessian action, eq. (5) with every term.

    Beside the Gauss-Newton matvec it keeps the div(lam vt) source of the
    incremental adjoint (5c) and the int lam grad rho~ dt term of bt, for
    one stored rho~(t) series and one more coalesced transform pair: the
    batched ``div(lam vt)`` and ``grad rho~(t)`` series share it.  At a
    perfect match (lam = 0) it is the Gauss-Newton matvec; away from the
    solution it may be indefinite (paper §IV-A3).  Single subject only.
    """
    if vtilde.ndim == 5:
        raise NotImplementedError(
            "full Newton Hessian has no cohort path; use gauss_newton=True"
        )
    rho_t_series = semilag.transport_inc_state_series(
        vtilde, state.grad_rho_series, state.plan, interp
    )
    lam_vt = state.lam_series[:, None] * vtilde[None]  # (n_t+1, 3, N..)
    with ops.batch() as sb:
        h_div = sb.div(lam_vt)  # (n_t+1, N..)
        h_grad = sb.grad(rho_t_series)  # (3, n_t+1, N..)
    lamt_series = semilag.transport_inc_adjoint_newton(
        -rho_t_series[-1], state.lam_series, vtilde, state.plan, ops, interp,
        div_lam_vt=h_div.get(),
    )
    bt = semilag.time_integral_b(lamt_series, state.grad_rho_series, state.plan.dt)
    # the second term of bt: int lam(t) grad rho~(t) dt
    grad_rho_t = torch.swapaxes(h_grad.get(), 0, 1)  # (n_t+1, 3, N..)
    bt = bt + semilag.time_integral_b(state.lam_series, grad_rho_t, state.plan.dt)
    if prob.incompressible:
        return ops.reg_plus_project(vtilde, bt, prob.beta, True)
    return ops.reg_apply(vtilde, prob.beta) + bt
