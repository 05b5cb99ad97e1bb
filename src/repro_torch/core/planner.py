"""Semi-Lagrangian interpolation planner (paper §III-C2); counterpart of
``repro/core/planner.py``.

Once per velocity field (per Newton iteration) the planner computes the RK2
departure displacements for +v and -v and one precomputed ``InterpPlan``
per displacement; ``core.semilag`` reuses them in every transport solve of
that iteration (state, adjoint, all PCG Hessian matvecs).  The departure
solve interpolates the three velocity components in one batched call:
``tricubic_displace_many_cuda`` on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.grid import Grid
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


class SLPlan(NamedTuple):
    """Everything reusable across transport solves for a fixed velocity."""

    disp_fwd: torch.Tensor  # (3,N..) departure displacement for +v, grid units
    disp_adj: torch.Tensor | None  # same for -v (None in forward-only plans)
    divv: torch.Tensor | None  # div v on the grid (None in incompressible mode)
    dt: float
    n_t: int
    iplan_fwd: ref.InterpPlan | None = None
    iplan_adj: ref.InterpPlan | None = None


def departure_displacement(v: torch.Tensor, grid: Grid, dt: float, interp=None) -> torch.Tensor:
    """RK2 departure points, paper eq. (6), as a grid-unit displacement.

        X* = x - dt * v(x);   X = x - dt/2 * (v(x) + v(X*))

    ``v`` (3, N..) is in physical units on [0, 2pi)^3; the result is
    ``(X - x)/h`` per dimension.  ``interp=None`` uses the default
    ``kops.make_interp()`` (the kernel on CUDA tensors).

    A cohort velocity (S, 3, N..) yields per-subject displacements
    (S, 3, N..).  The interpolation puts the subject axis at -4 of the
    fields, so the component axis is swapped into the channel slot for the
    one batched self-interpolation, fields (3, S, N..) against the
    displacement (S, 3, N..), and swapped back.
    """
    interp = interp or kops.make_interp()
    ct = torch.promote_types(v.dtype, torch.float32)
    h = torch.tensor(grid.spacing, dtype=ct, device=v.device).reshape(3, 1, 1, 1)
    vg = v.to(ct) / h  # velocity in grid cells per unit time
    d_star = -dt * vg
    if v.ndim == 5:
        v_star = torch.swapaxes(interp(torch.swapaxes(vg, 0, 1), d_star), 0, 1)
    else:
        v_star = interp(vg, d_star)
    return (-0.5 * dt) * (vg + v_star)


def make_plan(
    v: torch.Tensor,
    grid: Grid,
    spectral_ops,
    n_t: int,
    incompressible: bool,
    interp=None,
    adjoint: bool = True,
    divv: torch.Tensor | None = None,
) -> SLPlan:
    """Build the per-Newton-iteration plan.

    ``adjoint=False`` builds a forward-only plan (``disp_adj``/``iplan_adj``
    left ``None``), which is all an Armijo trial needs.  ``divv`` supplies a
    precomputed ``div v`` so the caller can coalesce its transform with
    others; when omitted (and compressible) it costs one transform pair.
    """
    interp = interp or kops.make_interp()
    dt = 1.0 / n_t
    disp_fwd = departure_displacement(v, grid, dt, interp)
    disp_adj = departure_displacement(-v, grid, dt, interp) if adjoint else None
    if incompressible:
        divv = None
    elif divv is None:
        divv = spectral_ops.div(v)
    return SLPlan(
        disp_fwd=disp_fwd,
        disp_adj=disp_adj,
        divv=divv,
        dt=dt,
        n_t=n_t,
        iplan_fwd=interp.make_plan(disp_fwd),
        iplan_adj=interp.make_plan(disp_adj) if adjoint else None,
    )


def required_halo(plan: SLPlan) -> torch.Tensor:
    """ceil(max |displacement|) over the plan's departure fields.

    The CUDA kernels wrap periodically and need no halo; the bound is kept
    for the distributed slice, whose ghost exchange will need it.
    """
    fwd = plan.iplan_fwd.halo_need
    if plan.iplan_adj is None:
        return fwd
    return torch.maximum(fwd, plan.iplan_adj.halo_need)
