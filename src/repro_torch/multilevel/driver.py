"""Coarse-to-fine grid continuation driver; counterpart of
``repro/multilevel/driver.py`` on one device.

``multilevel.solve`` restricts the image pair down the ladder, runs the
Gauss-Newton-Krylov solver per level (coarsest first), and prolongs each
level's velocity as the warm start of the next, with the beta-continuation
schedule spread across the levels.  A warm-started level measures
convergence against the cold-start gradient norm of that level, so the
finest level stops at the tolerance a single-level solve would.  With
``MultilevelConfig(precond=...)`` every warm-started level's PCG is
preconditioned through the coarser part of the ladder (two-level or
V-cycle, ``multilevel.precond``), and the coarse matvecs spent inside the
preconditioner are charged into ``precond_fine_equiv_matvecs``.

Interpolation: each level gets one executor,
``kops.make_interp(level_config.interp_method)``, passed explicitly to that
level's ``gn.solve``, its cold-gradient reference and the preconditioner
(the coarse states and matvecs of the V-cycle).  So ``interp_method`` alone
decides whether a level's interpolations run in the CUDA kernels.  The
reference's local path passes no executor (``level_interp = [None] *
n_levels``): its cold gradient and V-cycle always take the plain oracle,
whatever ``interp_method`` says.  In the port the values are the same
either way: the kernels agree with the plain versions bit for bit (built
with -fmad=false; the rounding contract at the head of
``kernels/csrc/tricubic.cu``).  A run with ``interp_method="ref"``
launches no kernel, and a run with ``"auto"`` on the card interpolates
everywhere in the kernels.
"""
from __future__ import annotations

import time

import torch

from repro_torch import telemetry
from repro_torch.core import gauss_newton as gn
from repro_torch.core import objective as obj
from repro_torch.core.grid import Grid
from repro_torch.core.spectral import SpectralOps
from repro_torch.kernels import ops as kops
from repro_torch.multilevel import transfer
from repro_torch.multilevel.hierarchy import GridHierarchy, MultilevelConfig
from repro_torch.multilevel.precond import make_two_level_precond, make_vcycle_precond


def _cold_gradient_norm(rho_R, rho_T, grid, lcfg, ops, interp) -> float:
    """|g(v=0)|, independent of beta (the regularization term vanishes at v=0)."""
    prob = obj.Problem(
        grid=grid, rho_R=rho_R, rho_T=rho_T, beta=lcfg.beta, n_t=lcfg.n_t,
        incompressible=lcfg.incompressible,
    )
    v0 = torch.zeros((3,) + grid.shape, dtype=grid.dtype, device=ops.device)
    state = obj.newton_state(v0, prob, ops, interp)
    return float(torch.sqrt(grid.norm_sq(state.g)))


def solve(
    rho_R,
    rho_T,
    grid: Grid,
    cfg: MultilevelConfig,
    *,
    ops: SpectralOps | None = None,
    ctx=None,
    v0=None,
    verbose: bool = False,
    callback=None,
    device="cuda",
):
    """Coarse-to-fine registration solve; returns the ``gn.solve`` dict plus
    per-level statistics (``levels``, ``fine_matvecs``, ``fine_equiv_matvecs``,
    ``precond_fine_equiv_matvecs``, ``total_fine_equiv_matvecs``, ``grids``).

    ``device`` is used when ``ops`` is not given.  ``ctx`` (a mesh context)
    is not ported.
    """
    if ctx is not None:
        raise NotImplementedError(
            "multilevel.solve(ctx=...) on a mesh is not ported (ROADMAP Queue A item 13)"
        )
    hier = GridHierarchy(grid, cfg)
    n_levels = len(hier)
    fine_ops = ops or SpectralOps(grid, device=device)
    dev = fine_ops.device
    level_ops = [
        fine_ops if g.shape == grid.shape else SpectralOps(g, device=dev) for g in hier.grids
    ]
    level_cfgs = [hier.level_config(lv) for lv in range(n_levels)]
    level_interp = [kops.make_interp(c.interp_method) for c in level_cfgs]
    rho_R = torch.as_tensor(rho_R, dtype=grid.dtype, device=dev)
    rho_T = torch.as_tensor(rho_T, dtype=grid.dtype, device=dev)
    restrict_images = transfer.smooth_restrict if cfg.presmooth else transfer.restrict

    history: list[dict] = []
    levels: list[dict] = []
    v = None if v0 is None else torch.as_tensor(v0, dtype=grid.dtype, device=dev)
    for lv in range(n_levels):
        lgrid, lops, linterp, lcfg = hier.grids[lv], level_ops[lv], level_interp[lv], level_cfgs[lv]
        if lgrid.shape == grid.shape:
            rho_R_l, rho_T_l = rho_R, rho_T
        else:
            rho_R_l = restrict_images(rho_R, fine_ops, lops)
            rho_T_l = restrict_images(rho_T, fine_ops, lops)

        warm = v is not None
        if warm and lv > 0:
            v = transfer.prolong(v, level_ops[lv - 1], lops)
        elif warm and lgrid.shape != grid.shape:
            v = transfer.restrict(v, fine_ops, lops)  # a fine-grid v0 from the caller
        g0_ref = (
            _cold_gradient_norm(rho_R_l, rho_T_l, lgrid, lcfg, lops, linterp) if warm else None
        )

        precond = None
        if cfg.precond_kind != "none" and lv > 0:
            prob_l = obj.Problem(
                grid=lgrid, rho_R=rho_R_l, rho_T=rho_T_l, beta=lcfg.beta,
                n_t=lcfg.n_t, incompressible=lcfg.incompressible,
            )
            if cfg.precond_kind == "two_level":
                precond = make_two_level_precond(
                    prob_l, lops, level_ops[lv - 1],
                    n_cg=cfg.precond_cg_iters,
                    interp_coarse=level_interp[lv - 1],
                    galerkin=cfg.galerkin_resolved,
                )
            else:  # the V-cycle through every coarser ladder level
                precond = make_vcycle_precond(
                    prob_l, level_ops[: lv + 1],
                    level_interp=level_interp[: lv + 1],
                    n_cg=cfg.precond_cg_iters,
                    n_cg_coarse=cfg.precond_coarse_cg_iters,
                    galerkin=cfg.galerkin_resolved,
                    min_size=cfg.precond_min_size,
                )

        def level_cb(it, rec, _lv=lv, _shape=lgrid.shape):
            rec["level"] = _lv
            rec["shape"] = list(_shape)
            if callback:
                callback(it, rec)

        telemetry.emit(
            telemetry.LevelStartEvent(
                level=lv, n_levels=n_levels, shape=list(lgrid.shape),
                betas=[float(b) for b in hier.betas[lv]], warm_start=warm,
            ),
            echo=verbose,
        )
        t0 = time.perf_counter()
        with telemetry.span("multilevel.level", device=dev, level=lv, shape=list(lgrid.shape)):
            out = gn.solve(
                rho_R_l, rho_T_l, lgrid, lcfg,
                ops=lops, v0=v, verbose=verbose, callback=level_cb, interp=linterp,
                precond=precond, g0_ref=g0_ref,
            )
        # gn.solve reads every iteration's scalars on the host, so its work
        # has ended when it returns
        wall = time.perf_counter() - t0
        v = out["v"]
        history.extend(out["history"])
        # preconditioner-internal coarse matvecs in ladder-fine units
        # (gn.solve reports them relative to the level's own grid)
        pc_fe = out["precond_fine_equiv_matvecs"] * hier.fine_equiv_weight(lv)
        level_rec = {
            "level": lv,
            "shape": list(lgrid.shape),
            "betas": [float(b) for b in hier.betas[lv]],
            "warm_start": warm,
            "newton_iters": out["newton_iters"],
            "hessian_matvecs": out["hessian_matvecs"],
            "fine_equiv_matvecs": out["hessian_matvecs"] * hier.fine_equiv_weight(lv),
            "precond_fine_equiv_matvecs": pc_fe,
            "wall_s": wall,
            "rel_gnorm": out["history"][-1]["rel_gnorm"] if out["history"] else None,
        }
        levels.append(level_rec)
        telemetry.emit(telemetry.LevelEvent(**level_rec))

    fine_equiv = sum(l["fine_equiv_matvecs"] for l in levels)
    precond_fe = sum(l["precond_fine_equiv_matvecs"] for l in levels)
    telemetry.emit(
        telemetry.SolveEvent(
            source="multilevel.solve",
            newton_iters=sum(l["newton_iters"] for l in levels),
            hessian_matvecs=sum(l["hessian_matvecs"] for l in levels),
            fine_equiv_matvecs=fine_equiv,
            precond_fine_equiv_matvecs=precond_fe,
            wall_s=sum(l["wall_s"] for l in levels),
        )
    )
    return {
        "v": v,
        "history": history,
        "newton_iters": sum(l["newton_iters"] for l in levels),
        "hessian_matvecs": sum(l["hessian_matvecs"] for l in levels),
        "fine_matvecs": levels[-1]["hessian_matvecs"],
        "fine_equiv_matvecs": fine_equiv,
        "precond_fine_equiv_matvecs": precond_fe,
        "total_fine_equiv_matvecs": fine_equiv + precond_fe,
        "levels": levels,
        "grids": [list(g.shape) for g in hier.grids],
    }
