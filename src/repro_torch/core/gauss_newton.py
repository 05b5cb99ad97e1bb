"""Inexact, preconditioned (Gauss-)Newton-Krylov solver (paper §III-A);
counterpart of ``repro/core/gauss_newton.py``, for one subject (``solve``)
or a cohort of S subjects at once (``solve_cohort``).

* Newton step from PCG on ``H(v) vt = -g(v)`` with the spectral
  preconditioner ``(beta Lap^2)^{-1}``; ``H`` is the Gauss-Newton Hessian,
  or the full one with ``GNConfig(gauss_newton=False)``.
* Inexact solves: Eisenstat-Walker forcing
  ``eta_k = min(eta_max, sqrt(||g_k|| / ||g_0||))``.
* Globalization: Armijo backtracking line search, with a steepest-descent
  safeguard.
* Optional parameter continuation on beta.

``lax.while_loop`` becomes a Python loop: PCG's residual test and the
Armijo test are read on the host (one ``.item()`` each per iteration), on
float32 values computed as the reference computes them.

The cohort solver runs S registrations through one batched Newton step
(velocities (S, 3, N..), images (S, N..)): every transform and every
interpolation serves all S subjects (on a card, one launch of the planned
apply or the batched displace over the cohort), while each subject keeps
its own masked PCG, Eisenstat-Walker forcing, Armijo schedule and
termination test.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import objective as obj
from repro_torch.core.grid import Grid
from repro_torch.core.spectral import SpectralOps, check_field_dtype
from repro_torch.kernels import ops as kops
from repro_torch.resilience import health


@dataclasses.dataclass(frozen=True)
class GNConfig:
    """Solver settings; the fields and defaults are the reference's, except:

    * ``interp_method`` defaults to ``"auto"`` (the reference's is
      ``"ref"``), so the default solve on a CUDA device runs every
      interpolation through the CUDA kernels; ``"ref"`` selects the plain
      PyTorch versions and ``"cuda"`` insists on the kernels.
    * ``plan_dtype`` is accepted only as ``None``, ``field_dtype`` only as
      ``None`` or float32 (the port's field dtype, so the identity; the
      retry ladder's last rung sets it), and ``autotune`` only as ``"off"``
      or ``"cache"`` (both mean off here): the other values are ROADMAP
      Queue A item 12 and raise ``NotImplementedError``.

    ``gauss_newton=False`` solves with the full Newton Hessian
    (``objective.full_hessian_matvec``); a cohort solve refuses it, as the
    reference does.
    """

    beta: float = 1e-2
    n_t: int = 4
    incompressible: bool = False
    max_newton: int = 20
    gtol: float = 1e-2  # relative gradient tolerance (paper: 1e-2)
    max_cg: int = 100
    eta_max: float = 0.5  # forcing-term cap
    armijo_c1: float = 1e-4
    max_line_search: int = 10
    beta_continuation: tuple[float, ...] = ()  # e.g. (1e-1, 1e-2): warm starts
    interp_method: str = "auto"  # "auto" | "cuda" | "ref"
    plan_dtype: str | None = None
    field_dtype: str | None = None
    autotune: str = "cache"
    gauss_newton: bool = True

    def __post_init__(self):
        if self.interp_method not in kops.METHODS:
            raise ValueError(
                f"interp_method {self.interp_method!r} not in {kops.METHODS}"
            )
        item12 = "is not ported (ROADMAP Queue A item 12)"
        if self.plan_dtype is not None:
            raise NotImplementedError(f"GNConfig.plan_dtype={self.plan_dtype!r} {item12}")
        check_field_dtype(self.field_dtype, "GNConfig")
        if self.autotune not in ("off", "cache"):
            raise NotImplementedError(f"GNConfig.autotune={self.autotune!r} {item12}")


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_res: torch.Tensor


class NewtonLog(NamedTuple):
    """One Newton iteration's record.  A cohort step's holds (S,) tensors
    in every field but ``ls_iters``, the Armijo halvings its subjects
    shared."""

    j_val: torch.Tensor
    misfit: torch.Tensor
    reg: torch.Tensor
    gnorm: torch.Tensor
    cg_iters: int
    step_len: torch.Tensor
    ls_iters: int
    status: int


def pcg(
    matvec: Callable,
    b: torch.Tensor,
    precond: Callable,
    inner: Callable,
    rtol: torch.Tensor,
    max_iter: int,
) -> PCGResult:
    """Matrix-free preconditioned conjugate gradients.

    ``iters`` counts every Hessian matvec (the paper's Table V metric).
    """
    bnorm = torch.sqrt(inner(b, b))
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = inner(r, p)
    it = 0
    while it < max_iter and bool(torch.sqrt(inner(r, r)) > rtol * bnorm):
        hp = matvec(p)
        alpha = rz / torch.clamp(inner(p, hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = inner(r, z)
        p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new
        it += 1
    rel = torch.sqrt(inner(r, r)) / torch.clamp(bnorm, min=1e-30)
    return PCGResult(x=x, iters=it, rel_res=rel)


def pcg_masked(
    matvec: Callable,
    b: torch.Tensor,
    precond: Callable,
    inner_per: Callable,
    rtol: torch.Tensor,
    max_iter: int,
    active: torch.Tensor,
) -> PCGResult:
    """Per-subject masked PCG over a cohort stack ``b`` (S, 3, N..).

    The subjects advance in lockstep through one batched matvec, but each
    runs its own ``pcg`` recursion: ``rtol`` and ``active`` are (S,), a
    subject whose residual test or iteration cap trips is frozen (its
    ``x``, ``r``, ``p`` and ``rz`` keep their values), and the loop ends
    when no subject is live; whether one is, is read on the host once per
    iteration.  ``iters`` is (S,): the Hessian matvecs each subject took,
    none for a retired or never-active one.
    """
    def bc(t):  # (S,) -> (S, 1, 1, 1, 1)
        return t.reshape(t.shape + (1,) * (b.ndim - 1))

    bnorm = torch.sqrt(inner_per(b, b))
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = inner_per(r, p)
    iters = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)

    def live(r, iters):
        return active & (torch.sqrt(inner_per(r, r)) > rtol * bnorm) & (iters < max_iter)

    lv = live(r, iters)
    while bool(torch.any(lv)):
        hp = matvec(p)
        alpha = torch.where(lv, rz / torch.clamp(inner_per(p, hp), min=1e-30), 0.0)
        x = x + bc(alpha) * p
        r = r - bc(alpha) * hp
        z = precond(r)
        rz_new = inner_per(r, z)
        beta_cg = torch.where(lv, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        p = torch.where(bc(lv), z + bc(beta_cg) * p, p)
        rz = torch.where(lv, rz_new, rz)
        iters = iters + lv.to(torch.int32)
        lv = live(r, iters)
    rel = torch.sqrt(inner_per(r, r)) / torch.clamp(bnorm, min=1e-30)
    return PCGResult(x=x, iters=iters, rel_res=rel)


def _interp_fn(cfg: GNConfig) -> kops.Interp:
    return kops.make_interp(method=cfg.interp_method)


def newton_iteration(
    v: torch.Tensor,
    g0_forcing: torch.Tensor,
    prob: obj.Problem,
    ops: SpectralOps,
    cfg: GNConfig,
    interp=None,
    precond=None,
):
    """One globalized inexact Newton step, on the Gauss-Newton Hessian or,
    with ``cfg.gauss_newton`` False, the full one.  Returns (v_new,
    NewtonLog).

    ``g0_forcing`` is the Eisenstat-Walker forcing reference only; pass a
    tiny sentinel (``1e-30``) on a stage's first call to get
    ``eta = eta_max``.  ``precond`` is an optional factory
    ``(state, prob) -> (r -> z)`` replacing the spectral preconditioner;
    the steepest-descent safeguard always uses the spectral one.
    """
    interp = interp or _interp_fn(cfg)
    grid = prob.grid
    state = obj.newton_state(v, prob, ops, interp)
    gnorm = torch.sqrt(grid.norm_sq(state.g))

    hessian = obj.gn_hessian_matvec if cfg.gauss_newton else obj.full_hessian_matvec

    def matvec(p):
        return hessian(p, state, prob, ops, interp)

    def spectral_precond(r):
        return ops.precond_project(r, prob.beta, prob.incompressible)

    precond = spectral_precond if precond is None else precond(state, prob)

    eta = torch.clamp(
        torch.sqrt(gnorm / torch.clamp(g0_forcing, min=1e-30)), max=cfg.eta_max
    )
    rhs = -state.g
    if prob.incompressible:
        rhs = ops.leray(rhs)
    sol = pcg(matvec, rhs, precond, grid.inner, eta, cfg.max_cg)
    dv = sol.x
    if prob.incompressible:
        dv = ops.leray(dv)

    # ---- Armijo backtracking on J, after the steepest-descent safeguard
    gdv = grid.inner(state.g, dv)
    if not bool(gdv < 0):
        dv = -spectral_precond(state.g)
    gdv = torch.minimum(gdv, grid.inner(state.g, dv))

    def j_of(vv):
        jval, _ = obj.evaluate_objective(vv, prob, ops, interp)
        return jval

    def armijo(alpha, jnew):
        return bool(jnew <= state.j_val + cfg.armijo_c1 * alpha * gdv)

    alpha = torch.tensor(1.0, dtype=torch.float32, device=v.device)
    j_new = j_of(v + alpha * dv)
    ls_it = 0
    while not armijo(alpha, j_new) and ls_it < cfg.max_line_search:
        alpha = alpha * 0.5
        j_new = j_of(v + alpha * dv)
        ls_it += 1
    accepted = j_new < state.j_val
    v_new = v + alpha * dv if bool(accepted) else v

    status = health.classify(
        v_in=v,
        v_out=v_new,
        j_val=state.j_val,
        j_new=j_new,
        gnorm=gnorm,
        pcg_x=sol.x,
        pcg_rel=sol.rel_res,
        accepted=accepted,
    )
    v_new = health.freeze(v_new, v, status)

    log = NewtonLog(
        j_val=state.j_val,
        misfit=state.misfit,
        reg=state.reg,
        gnorm=gnorm,
        cg_iters=sol.iters,
        step_len=torch.where(accepted, alpha, 0.0),
        ls_iters=ls_it,
        status=int(status),
    )
    return v_new, log


def solve(
    rho_R: torch.Tensor,
    rho_T: torch.Tensor,
    grid: Grid,
    cfg: GNConfig,
    ops: SpectralOps | None = None,
    v0: torch.Tensor | None = None,
    verbose: bool = False,
    callback: Callable[[int, dict], None] | None = None,
    interp=None,
    precond=None,
    g0_ref: float | None = None,
    device="cuda",
):
    """Full registration drive: (optional) beta continuation + Newton loop.

    ``device`` is used when ``ops`` is not given; the images (and ``v0``)
    are moved to the ops' device.  ``g0_ref`` overrides the reference
    gradient norm of the convergence test only; the Eisenstat-Walker
    forcing reference of each beta stage is that stage's first gradient
    norm.
    """
    ops = ops or SpectralOps(grid, device=device)
    dev = ops.device
    rho_R = torch.as_tensor(rho_R, dtype=grid.dtype, device=dev)
    rho_T = torch.as_tensor(rho_T, dtype=grid.dtype, device=dev)
    if v0 is None:
        v = torch.zeros((3,) + grid.shape, dtype=grid.dtype, device=dev)
    else:
        v = torch.as_tensor(v0, dtype=grid.dtype, device=dev)
    interp = interp or _interp_fn(cfg)

    betas = tuple(cfg.beta_continuation) + (cfg.beta,)
    history: list[dict] = []
    total_matvecs = 0
    total_newton = 0
    pc_cost = float(getattr(precond, "fine_equiv_cost", 0.0))
    total_precond_fe = 0.0
    status_code = health.OK

    for beta in betas:
        prob = obj.Problem(
            grid=grid,
            rho_R=rho_R,
            rho_T=rho_T,
            beta=float(beta),
            n_t=cfg.n_t,
            incompressible=cfg.incompressible,
        )
        g0 = None if g0_ref is None else torch.tensor(g0_ref, dtype=torch.float32)
        g_forcing = None
        sentinel = torch.tensor(1e-30, dtype=torch.float32, device=dev)
        for it in range(cfg.max_newton):
            with telemetry.span("gn.newton_iter", device=dev, beta=float(beta), iter=it) as sp:
                v, log = newton_iteration(
                    v, sentinel if g_forcing is None else g_forcing, prob, ops, cfg,
                    interp=interp, precond=precond,
                )
            if g_forcing is None:
                g_forcing = log.gnorm
            if g0 is None:
                g0 = log.gnorm
            total_matvecs += log.cg_iters
            total_newton += 1
            total_precond_fe += (log.cg_iters + 1) * pc_cost
            status_code = log.status
            rec = {
                "beta": float(beta),
                "iter": it,
                "J": float(log.j_val),
                "misfit": float(log.misfit),
                "reg": float(log.reg),
                "gnorm": float(log.gnorm),
                "rel_gnorm": float(log.gnorm / max(float(g0), 1e-30)),
                "cg_iters": log.cg_iters,
                "step": float(log.step_len),
                "armijo_trials": log.ls_iters,
                "status": health.status_name(status_code),
            }
            history.append(rec)
            if callback:
                callback(it, rec)
            telemetry.emit(
                telemetry.NewtonIterEvent(
                    source="gn.solve",
                    beta=rec["beta"],
                    iter=it,
                    j_val=rec["J"],
                    misfit=rec["misfit"],
                    reg=rec["reg"],
                    gnorm=rec["gnorm"],
                    rel_gnorm=rec["rel_gnorm"],
                    cg_iters=rec["cg_iters"],
                    step_len=rec["step"],
                    armijo_trials=rec["armijo_trials"],
                    wall_s=sp.wall_s,
                ),
                echo=verbose,
            )
            if health.is_failure(status_code):
                # a NaN-poisoned / diverging / broken-down solve will not heal
                # by iterating further: stop and surface the reason
                telemetry.counter(
                    "resilience.guard_tripped", status=rec["status"], source="gn.solve"
                )
                break
            if rec["rel_gnorm"] <= cfg.gtol or rec["step"] == 0.0:
                break
        if health.is_failure(status_code):
            break

    if history and health.is_failure(status_code):
        final_status = history[-1]["status"]
    elif history and history[-1]["rel_gnorm"] <= cfg.gtol:
        final_status = health.status_name(health.CONVERGED)
    elif history and history[-1]["step"] == 0.0:
        final_status = health.status_name(health.STAGNATED)
    else:
        final_status = health.status_name(health.MAX_NEWTON)

    telemetry.emit(
        telemetry.SolveEvent(
            source="gn.solve",
            newton_iters=total_newton,
            hessian_matvecs=total_matvecs,
            fine_equiv_matvecs=float(total_matvecs),
            precond_fine_equiv_matvecs=total_precond_fe,
            compiled_executables=None,
        )
    )
    return {
        "v": v,
        "history": history,
        "newton_iters": total_newton,
        "hessian_matvecs": total_matvecs,
        "precond_fine_equiv_matvecs": total_precond_fe,
        "status": final_status,
    }


# --------------------------------------------------------------------------- #
# the cohort solver: a subject axis S through the whole Newton iteration
# --------------------------------------------------------------------------- #
def newton_iteration_cohort(
    v: torch.Tensor,
    g0_forcing: torch.Tensor,
    active: torch.Tensor,
    prob: obj.Problem,
    ops: SpectralOps,
    cfg: GNConfig,
    interp=None,
):
    """One masked Gauss-Newton step for a cohort ``v`` (S, 3, N..).

    ``newton_iteration`` with every scalar recursion made per subject,
    (S,): the Eisenstat-Walker forcing, PCG's termination
    (``pcg_masked``), the steepest-descent safeguard and the Armijo line
    search all mask on ``active``, so a converged or retired subject
    freezes (zero step, velocity unchanged) without changing the others.
    The Armijo halvings run in lockstep: each trial is one objective
    evaluation of the whole cohort, and a subject whose condition holds
    keeps its step.  Returns ``(v_new, NewtonLog)``.
    """
    interp = interp or _interp_fn(cfg)
    grid = prob.grid
    state = obj.newton_state(v, prob, ops, interp)
    gnorm = torch.sqrt(grid.norm_sq_per(state.g))

    def bc(t):  # (S,) -> (S, 1, 1, 1, 1)
        return t.reshape(t.shape + (1,) * (v.ndim - 1))

    def matvec(p):
        return obj.gn_hessian_matvec(p, state, prob, ops, interp)

    def spectral_precond(r):
        return ops.precond_project(r, prob.beta, prob.incompressible)

    eta = torch.clamp(
        torch.sqrt(gnorm / torch.clamp(g0_forcing, min=1e-30)), max=cfg.eta_max
    )
    rhs = -state.g
    if prob.incompressible:
        rhs = ops.leray(rhs)
    sol = pcg_masked(matvec, rhs, spectral_precond, grid.inner_per, eta, cfg.max_cg, active)
    dv = sol.x
    if prob.incompressible:
        dv = ops.leray(dv)

    # per-subject steepest-descent safeguard (its transform only when a
    # subject needs it: the reference computes both and selects)
    gdv = grid.inner_per(state.g, dv)
    if not bool(torch.all(gdv < 0)):
        dv = torch.where(bc(gdv < 0), dv, -spectral_precond(state.g))
    gdv = torch.minimum(gdv, grid.inner_per(state.g, dv))

    def j_of(vv):
        jval, _ = obj.evaluate_objective(vv, prob, ops, interp)
        return jval  # (S,)

    def pending(alpha, jnew):  # active subjects whose Armijo test fails
        return active & ~(jnew <= state.j_val + cfg.armijo_c1 * alpha * gdv)

    alpha = torch.ones(v.shape[0], dtype=torch.float32, device=v.device)
    j_new = j_of(v + bc(alpha) * dv)
    ls_it = 0
    while ls_it < cfg.max_line_search and bool(torch.any(pending(alpha, j_new))):
        halve = pending(alpha, j_new)
        alpha = torch.where(halve, alpha * 0.5, alpha)
        j_new = torch.where(halve, j_of(v + bc(alpha) * dv), j_new)
        ls_it += 1
    accepted = active & (j_new < state.j_val)
    v_new = torch.where(bc(accepted), v + bc(alpha) * dv, v)

    status = health.classify(
        v_in=v,
        v_out=v_new,
        j_val=state.j_val,
        j_new=j_new,
        gnorm=gnorm,
        pcg_x=sol.x,
        pcg_rel=sol.rel_res,
        accepted=accepted,
        active=active,
        axes=tuple(range(1, v.ndim)),
    )
    v_new = health.freeze(v_new, v, status)

    log = NewtonLog(
        j_val=state.j_val,
        misfit=state.misfit,
        reg=state.reg,
        gnorm=gnorm,
        cg_iters=sol.iters,
        step_len=torch.where(accepted, alpha, 0.0),
        ls_iters=ls_it,
        status=status,
    )
    return v_new, log


def _cohort_step(v, g0_forcing, active, beta, rho_R, rho_T, *, grid, cfg, ops, interp):
    """One cohort Newton iteration with everything that varies across a
    serving session passed in: the continuation stage's ``beta``, the image
    stacks (a slot refill swaps subjects), the per-subject forcing
    references and the active mask."""
    prob = obj.Problem(
        grid=grid,
        rho_R=rho_R,
        rho_T=rho_T,
        beta=float(beta),
        n_t=cfg.n_t,
        incompressible=cfg.incompressible,
    )
    return newton_iteration_cohort(v, g0_forcing, active, prob, ops, cfg, interp)


class CohortStep:
    """The cohort step of one (grid, cfg) bucket:
    ``step(v, g0_forcing, active, beta, rho_R, rho_T) -> (v_new, NewtonLog)``.

    The reference ``jax.jit``s this step and counts its compiled
    executables, one per distinct argument signature.  The port traces
    nothing: ``make_cohort_step`` builds this callable once per bucket, and
    ``_cache_size()`` counts the distinct signatures (the shapes, dtypes
    and devices of the tensor arguments) it has been called with, where
    ``jax.jit`` would have compiled one executable each.  Neither CUDA
    graphs nor ``torch.compile`` are involved, and the kernel library is
    built once per process (``kernels/build.py``), whatever the buckets.
    """

    def __init__(self, grid: Grid, cfg: GNConfig, ops: SpectralOps, interp):
        self.grid, self.cfg, self.ops, self.interp = grid, cfg, ops, interp
        self.signatures: set = set()

    def __call__(self, v, g0_forcing, active, beta, rho_R, rho_T):
        self.signatures.add(tuple(
            (tuple(t.shape), t.dtype, t.device) for t in (v, g0_forcing, active, rho_R, rho_T)
        ))
        return _cohort_step(v, g0_forcing, active, beta, rho_R, rho_T, grid=self.grid,
                            cfg=self.cfg, ops=self.ops, interp=self.interp)

    def _cache_size(self) -> int:
        return len(self.signatures)


def _require_gauss_newton(cfg: GNConfig) -> None:
    if not cfg.gauss_newton:
        raise NotImplementedError(
            "cohort solves support the Gauss-Newton Hessian only (cfg.gauss_newton=True)"
        )


def make_cohort_step(grid: Grid, cfg: GNConfig, ops: SpectralOps | None = None, interp=None,
                     device="cuda") -> CohortStep:
    """Build the cohort step of a (grid, cfg) bucket (``CohortStep``): what
    ``solve_cohort`` iterates and what ``launch/reg_serve.py`` keeps for its
    bucket across job admissions.  ``device`` is used when ``ops`` is not
    given."""
    _require_gauss_newton(cfg)
    ops = ops or SpectralOps(grid, device=device)
    return CohortStep(grid, cfg, ops, interp or _interp_fn(cfg))


def solve_cohort(
    rho_R: torch.Tensor,
    rho_T: torch.Tensor,
    grid: Grid,
    cfg: GNConfig,
    ops: SpectralOps | None = None,
    v0: torch.Tensor | None = None,
    verbose: bool = False,
    callback: Callable[[int, dict], None] | None = None,
    interp=None,
    g0_ref: float | None = None,
    active=None,
    step_fn: CohortStep | None = None,
    device="cuda",
):
    """Register S subjects at once: ``rho_R``, ``rho_T`` are (S, N1, N2, N3).

    Each subject follows its own forcing, PCG termination, Armijo schedule
    and termination test; a converged subject retires (frozen velocity, no
    further matvecs) while the others go on.  ``active`` (S,) deactivates
    subjects from the start.  ``step_fn`` supplies a ``make_cohort_step``
    callable of the same (grid, cfg), so that many cohorts share one; else
    one is built, on ``ops``' device or ``device``.

    Returns per-subject lists ``newton_iters``, ``hessian_matvecs``,
    ``fine_equiv_matvecs`` (single level: the matvecs), ``active`` and
    ``status``; the velocities ``v`` (S, 3, N..); the history (one record
    per cohort iteration, with per-subject lists); and
    ``compiled_executables``, the argument signatures the step was called
    with (``CohortStep``), 1 across a whole continuation schedule.
    """
    _require_gauss_newton(cfg)
    if step_fn is None:
        step_fn = make_cohort_step(grid, cfg, ops=ops, interp=interp, device=device)
    dev = step_fn.ops.device
    rho_R = torch.as_tensor(rho_R, dtype=grid.dtype, device=dev)
    rho_T = torch.as_tensor(rho_T, dtype=grid.dtype, device=dev)
    S = rho_R.shape[0]
    if v0 is None:
        v = torch.zeros((S, 3) + grid.shape, dtype=grid.dtype, device=dev)
    else:
        v = torch.as_tensor(v0, dtype=grid.dtype, device=dev)
    active0 = (np.ones(S, bool) if active is None
               else np.asarray(torch.as_tensor(active).cpu(), bool))

    betas = tuple(cfg.beta_continuation) + (cfg.beta,)
    history: list[dict] = []
    newton_counts = np.zeros(S, np.int64)
    cg_counts = np.zeros(S, np.int64)
    status_codes = np.zeros(S, np.int64)

    for beta in betas:
        act = active0.copy()
        # every stage re-activates its subjects; the final statuses are the
        # last stage's retirement reasons
        status_codes[active0] = health.OK
        g0 = None if g0_ref is None else np.full(S, g0_ref, np.float32)
        g_forcing = torch.full((S,), 1e-30, dtype=torch.float32, device=dev)
        have_forcing = False
        for it in range(cfg.max_newton):
            if not act.any():
                break
            with telemetry.span("gn.cohort_iter", device=dev, beta=float(beta), iter=it) as sp:
                v, log = step_fn(v, g_forcing, torch.as_tensor(act, device=dev), beta,
                                 rho_R, rho_T)
            if not have_forcing:
                g_forcing = log.gnorm
                have_forcing = True
            gnorm = log.gnorm.cpu().numpy()
            if g0 is None:
                g0 = gnorm
            cg = log.cg_iters.cpu().numpy().astype(np.int64)
            newton_counts += act
            cg_counts += cg
            rel = gnorm / np.maximum(g0, 1e-30)
            step = log.step_len.cpu().numpy()
            code = log.status.cpu().numpy().astype(np.int64)
            failed = act & np.isin(code, health.FAILED_CODES)
            done = act & ((rel <= cfg.gtol) | (step == 0.0) | failed)
            # retirement reasons: the guard decides the failures, the host
            # convergence and stagnation
            status_codes[failed] = code[failed]
            conv = done & ~failed & (rel <= cfg.gtol)
            status_codes[conv] = health.CONVERGED
            stag = done & ~failed & ~conv
            status_codes[stag] = np.where(code[stag] == health.OK, health.STAGNATED, code[stag])
            if failed.any():
                telemetry.counter("resilience.guard_tripped", value=int(failed.sum()),
                                  source="gn.solve_cohort")
            rec = {
                "beta": float(beta),
                "iter": it,
                "J": [float(x) for x in log.j_val.cpu().numpy()],
                "misfit": [float(x) for x in log.misfit.cpu().numpy()],
                "reg": [float(x) for x in log.reg.cpu().numpy()],
                "gnorm": [float(x) for x in gnorm],
                "rel_gnorm": [float(x) for x in rel],
                "cg_iters": [int(x) for x in cg],
                "step": [float(x) for x in step],
                "active": [bool(x) for x in act],
                "armijo_trials": log.ls_iters,
                "status": [int(x) for x in code],
            }
            act = act & ~done
            history.append(rec)
            if callback:
                callback(it, rec)
            telemetry.emit(
                telemetry.NewtonIterEvent(
                    source="gn.solve_cohort",
                    beta=rec["beta"],
                    iter=it,
                    j_val=rec["J"],
                    misfit=rec["misfit"],
                    reg=rec["reg"],
                    gnorm=rec["gnorm"],
                    rel_gnorm=rec["rel_gnorm"],
                    cg_iters=rec["cg_iters"],
                    step_len=rec["step"],
                    armijo_trials=rec["armijo_trials"],
                    wall_s=sp.wall_s,
                    subjects=S,
                    active=rec["active"],
                ),
                echo=verbose,
            )

    # subjects still live after the last stage ran out of Newton iterations
    status_codes[active0 & (status_codes == health.OK)] = health.MAX_NEWTON
    out = {
        "v": v,
        "history": history,
        "newton_iters": [int(x) for x in newton_counts],
        "hessian_matvecs": [int(x) for x in cg_counts],
        "fine_equiv_matvecs": [float(x) for x in cg_counts],
        "active": [bool(x) for x in active0],
        "compiled_executables": step_fn._cache_size(),
        "status": [health.status_name(c) for c in status_codes],
    }
    telemetry.emit(
        telemetry.SolveEvent(
            source="gn.solve_cohort",
            newton_iters=out["newton_iters"],
            hessian_matvecs=out["hessian_matvecs"],
            fine_equiv_matvecs=out["fine_equiv_matvecs"],
            compiled_executables=out["compiled_executables"],
        )
    )
    return out
