"""Inexact, preconditioned Gauss-Newton-Krylov solver (paper §III-A);
counterpart of ``repro/core/gauss_newton.py`` (single subject).

* Newton step from PCG on ``H(v) vt = -g(v)`` with the spectral
  preconditioner ``(beta Lap^2)^{-1}``.
* Inexact solves: Eisenstat-Walker forcing
  ``eta_k = min(eta_max, sqrt(||g_k|| / ||g_0||))``.
* Globalization: Armijo backtracking line search, with a steepest-descent
  safeguard.
* Optional parameter continuation on beta.

``lax.while_loop`` becomes a Python loop: PCG's residual test and the
Armijo test are read on the host (one ``.item()`` each per iteration), on
float32 values computed as the reference computes them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch import telemetry
from repro_torch.core import objective as obj
from repro_torch.core.grid import Grid
from repro_torch.core.spectral import SpectralOps
from repro_torch.kernels import ops as kops
from repro_torch.resilience import health


@dataclasses.dataclass(frozen=True)
class GNConfig:
    """Solver settings; the fields and defaults are the reference's, except:

    * ``interp_method`` defaults to ``"auto"`` (the reference's is
      ``"ref"``), so the default solve on a CUDA device runs every
      interpolation through the CUDA kernels; ``"ref"`` selects the plain
      PyTorch versions and ``"cuda"`` insists on the kernels.
    * ``plan_dtype`` and ``field_dtype`` are accepted only as ``None``, and
      ``autotune`` only as ``"off"`` or ``"cache"`` (both mean off here):
      those knobs are ROADMAP Queue A item 12.  ``gauss_newton=False`` (the
      full Newton Hessian) is not ported either.  Other values raise
      ``NotImplementedError``.
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
        if self.field_dtype is not None:
            raise NotImplementedError(f"GNConfig.field_dtype={self.field_dtype!r} {item12}")
        if self.autotune not in ("off", "cache"):
            raise NotImplementedError(f"GNConfig.autotune={self.autotune!r} {item12}")
        if not self.gauss_newton:
            raise NotImplementedError(
                "GNConfig.gauss_newton=False (full Newton Hessian) is not ported"
            )


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_res: torch.Tensor


class NewtonLog(NamedTuple):
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
    """One globalized inexact Gauss-Newton step.  Returns (v_new, NewtonLog).

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

    def matvec(p):
        return obj.gn_hessian_matvec(p, state, prob, ops, interp)

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
