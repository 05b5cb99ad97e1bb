"""Multigrid preconditioners for the Gauss-Newton PCG: the recursive V-cycle
(Galerkin-consistent coarse operators) and the two-level scheme;
counterpart of ``repro/multilevel/precond.py``.

Every level applies the same exact spectral splitting

    M_l^{-1} r  =  P_l (coarse solve on R_l r)  +  (beta Lap^2)^{-1} r_high,
    r_high      =  r - P_l R_l r,

with sharp Fourier ``restrict``/``prolong``, so the two halves act on
L2-orthogonal subspaces: a few CG iterations on the coarse Hessian take the
data-dominated low modes, the spectral inverse the regularization-dominated
high modes at no matvec cost.  In the V-cycle the coarse CG is itself
preconditioned by the same splitting one level down; the coarsest level is
solved by ``n_cg_coarse`` spectral-preconditioned CG iterations.

The coarse Hessians are Galerkin-consistent (``restrict_state``): they
restrict the fields the GN matvec closes over (``grad rho(t_k)``, the
departure displacements, ``div v``) rather than re-running transports, so
the coarse operator is the restriction of the fine one up to the coarse
grid's interpolation error.  ``galerkin=False`` keeps the re-linearized
construction (restricted images, coarse transports) as an A/B baseline.

Coarse matvecs run inside the preconditioner, invisible to the outer PCG
counter: each factory carries ``fine_equiv_cost``, the fine-grid-equivalent
matvec cost of one application, which ``gn.solve`` charges into
``precond_fine_equiv_matvecs``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import telemetry
from repro_torch.core import gauss_newton as gn
from repro_torch.core import objective as obj
from repro_torch.core.planner import SLPlan
from repro_torch.core.spectral import SpectralOps
from repro_torch.kernels import ref
from repro_torch.multilevel import transfer


def restrict_state(
    state: obj.NewtonState,
    prob: obj.Problem,
    fine_ops: SpectralOps,
    coarse_ops: SpectralOps,
    interp_coarse=None,
):
    """Galerkin-consistent coarse ``(NewtonState, Problem)`` pair.

    Restricts exactly what ``obj.gn_hessian_matvec`` reads: the spectral
    gradients ``grad rho(t_k)`` (one batched truncation over all time
    slices), the departure displacements (rescaled into coarse grid units,
    with their ``InterpPlan`` operators rebuilt by ``interp_coarse``), and
    ``div v``.  Fields the matvec never reads are left ``None``.  Restricting
    a restricted state walks the ladder down exactly.
    """
    fine, coarse = fine_ops.grid.shape, coarse_ops.grid.shape

    def R(f):
        return transfer.restrict(f, fine_ops, coarse_ops)

    def R_disp(d):
        # grid-unit displacements scale by the per-axis point ratio
        out = R(d)
        for i, (c, f) in enumerate(zip(coarse, fine)):
            out[i].mul_(c / f)
        return out

    disp_fwd = R_disp(state.plan.disp_fwd)
    disp_adj = None if state.plan.disp_adj is None else R_disp(state.plan.disp_adj)
    divv = None if state.plan.divv is None else R(state.plan.divv)
    make_plan = ref.make_interp_plan if interp_coarse is None else interp_coarse.make_plan
    plan_c = SLPlan(
        disp_fwd=disp_fwd,
        disp_adj=disp_adj,
        divv=divv,
        dt=state.plan.dt,
        n_t=state.plan.n_t,
        iplan_fwd=make_plan(disp_fwd),
        iplan_adj=None if disp_adj is None else make_plan(disp_adj),
    )
    state_c = obj.NewtonState(
        v=None,
        plan=plan_c,
        rho_series=None,
        grad_rho_series=R(state.grad_rho_series),
        lam_series=None,
        g=None,
        misfit=None,
        reg=None,
        j_val=None,
    )
    prob_c = obj.Problem(
        grid=coarse_ops.grid,
        rho_R=None,  # never read by the Hessian matvec
        rho_T=None,
        beta=prob.beta,
        n_t=prob.n_t,
        incompressible=prob.incompressible,
    )
    return state_c, prob_c


def _precond_fine_equiv_cost(level_ops, n_cg: int, n_cg_coarse: int) -> float:
    """Static fine-equivalent matvec cost of ONE preconditioner application.

    An application at level ``l`` runs ``iters`` inner CG iterations on
    ``H_{l-1}`` (charged at the level's point-count ratio) with ``iters + 1``
    applications of the level-(l-1) preconditioner (free at the coarsest
    level, the recursion otherwise).
    """
    n_fine = level_ops[-1].grid.num_points
    w = [ops.grid.num_points / n_fine for ops in level_ops]

    def apply_cost(l: int) -> float:
        iters = n_cg_coarse if l - 1 == 0 else n_cg
        below = 0.0 if l - 1 == 0 else apply_cost(l - 1)
        return iters * w[l - 1] + (iters + 1) * below

    return apply_cost(len(level_ops) - 1)


def _split_apply(ops_f, ops_c, inner_pc, mv_c, iters: int, prob: obj.Problem, l: int):
    """M_l^{-1} on spectra: one fine forward of ``r``, one coarse inverse of
    the coarse residual, ``iters`` CG iterations on the coarse Hessian
    ``mv_c`` preconditioned by ``inner_pc``, one coarse forward of the coarse
    solution, one fine inverse of the combined correction, with the Leray
    projection and the high-mode inverse as k-space multipliers between."""

    @telemetry.annotate(f"precond.vcycle_l{l}")
    def apply(r: torch.Tensor) -> torch.Tensor:
        spec = ops_f.fwd_real(r)
        spec_c = transfer.restrict_spec(spec, ops_f, ops_c)
        # exact split before any projection of the coarse half
        spec_high = spec - transfer.pad_spec(spec_c, ops_c, ops_f)
        if prob.incompressible:
            spec_c = ops_c._leray_spec(spec_c)
        r_c = ops_c.inv_real(spec_c)
        sol = gn.pcg(mv_c, r_c, inner_pc, ops_c.grid.inner, 0.0, iters)
        zspec = transfer.pad_spec(ops_c.fwd_real(sol.x), ops_c, ops_f)
        zspec = zspec + ops_f._precond_scale(prob.beta) * spec_high
        if prob.incompressible:
            zspec = ops_f._leray_spec(zspec)
        return ops_f.inv_real(zspec)

    return apply


def make_vcycle_precond(
    prob: obj.Problem,
    level_ops,
    *,
    level_interp=None,
    n_cg: int = 4,
    n_cg_coarse: int = 10,
    galerkin: bool = True,
    min_size: int = 8,
):
    """Build the V-cycle ``precond`` factory for ``gn.newton_iteration``.

    ``level_ops`` is the coarse-to-fine ``SpectralOps`` ladder whose last
    entry is the level being preconditioned (>= 2 entries; exactly 2 gives
    the two-level scheme).  ``level_interp`` gives each level's interp
    executor (a ``None`` entry is ``kops.make_interp()``, which launches
    the kernels on CUDA tensors; ``multilevel.solve`` passes every level's
    executor explicitly).  With ``galerkin=True``
    only ``prob``'s scalars matter; with ``galerkin=False`` its images are
    smooth-restricted once per ladder level here and every coarse Hessian
    is re-linearized from the restricted velocity per Newton iteration.

    ``min_size`` floors the recursion: ladder levels with fewer points per
    axis are dropped (the immediate coarse level is always kept).  The
    factory carries ``fine_equiv_cost`` and ``n_levels``.
    """
    level_ops = list(level_ops)
    if len(level_ops) < 2:
        raise ValueError("V-cycle needs at least 2 levels (coarse + fine)")
    level_interp = list(level_interp) if level_interp is not None else [None] * len(level_ops)
    keep = [
        i for i, ops in enumerate(level_ops)
        if min(ops.grid.shape) >= min_size or i >= len(level_ops) - 2
    ]
    level_ops = [level_ops[i] for i in keep]
    level_interp = [level_interp[i] for i in keep]
    n_levels = len(level_ops)

    images = None
    if not galerkin:
        # smooth-restrict the images once, down the ladder
        images, rR, rT = [], prob.rho_R, prob.rho_T
        for lo, hi in zip(reversed(level_ops[:-1]), reversed(level_ops[1:])):
            rR = transfer.smooth_restrict(rR, hi, lo)
            rT = transfer.smooth_restrict(rT, hi, lo)
            images.append((rR, rT))
        images = list(reversed(images))  # coarse -> fine-1

    def factory(state: obj.NewtonState, prob_rt: obj.Problem):
        # per-Newton-iteration coarse operator ladder (fine -> coarse)
        states: list = [None] * n_levels
        probs: list = [None] * n_levels
        states[-1], probs[-1] = state, prob_rt
        for l in range(n_levels - 2, -1, -1):
            if galerkin:
                states[l], probs[l] = restrict_state(
                    states[l + 1], probs[l + 1], level_ops[l + 1], level_ops[l],
                    level_interp[l],
                )
            else:
                rR, rT = images[l]
                probs[l] = obj.Problem(
                    grid=level_ops[l].grid, rho_R=rR, rho_T=rT, beta=prob_rt.beta,
                    n_t=prob_rt.n_t, incompressible=prob_rt.incompressible,
                )
                v_c = transfer.restrict(states[l + 1].v, level_ops[l + 1], level_ops[l])
                states[l] = obj.newton_state(v_c, probs[l], level_ops[l], level_interp[l])

        def matvec(l):
            return lambda p: obj.gn_hessian_matvec(
                p, states[l], probs[l], level_ops[l], level_interp[l]
            )

        # M_l^{-1} built bottom-up, each level closing over the one below:
        # no closure refers to itself, so this iteration's states are freed
        # when the Newton iteration drops its preconditioner, not when the
        # cyclic garbage collector next runs
        pc = functools.partial(level_ops[0].precond_project, beta=prob_rt.beta,
                               incompressible=prob_rt.incompressible)
        for l in range(1, n_levels):
            iters = n_cg_coarse if l == 1 else n_cg
            pc = _split_apply(level_ops[l], level_ops[l - 1], pc, matvec(l - 1), iters,
                              prob_rt, l)
        return pc

    factory.fine_equiv_cost = _precond_fine_equiv_cost(level_ops, n_cg, n_cg_coarse)
    factory.n_levels = n_levels
    return factory


def make_two_level_precond(
    prob: obj.Problem,
    fine_ops: SpectralOps,
    coarse_ops: SpectralOps,
    *,
    n_cg: int = 4,
    interp_coarse=None,
    galerkin: bool = False,
):
    """The two-level scheme as a V-cycle special case: one coarse level,
    ``n_cg`` inner CG iterations, and by default the re-linearized coarse
    Hessian (``galerkin=True`` restricts the state fields instead)."""
    return make_vcycle_precond(
        prob,
        [coarse_ops, fine_ops],
        level_interp=[interp_coarse, None],
        n_cg=n_cg,
        n_cg_coarse=n_cg,
        galerkin=galerkin,
    )
