"""High-level registration API (the paper's end-to-end pipeline); counterpart
of ``repro/core/registration.py`` for one subject, on one grid level or on
a coarse-to-fine ladder (``RegistrationConfig(multilevel=...)``).

    result = register(rho_R, rho_T, RegistrationConfig(...), device="cuda")

Pipeline (paper §III): spectral Gaussian smoothing of the input images ->
Gauss-Newton-Krylov solve for the stationary velocity v -> deformation map
y1 = x + u from eq. (1) -> diagnostics (raw and smoothed residuals, the
det(grad y1) range).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch.core import gauss_newton as gn
from repro_torch.core import semilag
from repro_torch.core.grid import Grid, make_grid
from repro_torch.core.planner import make_plan
from repro_torch.core.spectral import SpectralOps

if TYPE_CHECKING:  # imported inside register(): core does not depend on multilevel
    from repro_torch.multilevel.hierarchy import MultilevelConfig


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """``multilevel`` is a ``repro_torch.multilevel.MultilevelConfig`` (its
    ``solver`` then supersedes ``solver``); ``blocks`` exists for the
    reference's field name, and anything but ``None`` raises (ROADMAP Queue
    A item 11).  The two together raise ``ValueError``, as in the reference.
    """

    solver: gn.GNConfig = dataclasses.field(default_factory=gn.GNConfig)
    presmooth: bool = True  # spectral Gaussian at grid bandwidth (paper §III-B1)
    multilevel: "MultilevelConfig | None" = None
    blocks: object = None

    def __post_init__(self):
        if self.blocks is not None:
            if self.multilevel is not None:
                raise ValueError(
                    "RegistrationConfig: blocks and multilevel are mutually exclusive"
                )
            raise NotImplementedError(
                "RegistrationConfig.blocks is not ported (ROADMAP Queue A item 11)"
            )


def register(
    rho_R,
    rho_T,
    config: RegistrationConfig | None = None,
    grid: Grid | None = None,
    verbose: bool = False,
    v0=None,
    ops: SpectralOps | None = None,
    interp=None,
    device="cuda",
):
    """End-to-end registration of ``rho_T`` onto ``rho_R`` (N1, N2, N3).

    The images may be tensors or numpy arrays; they are moved to ``device``
    (the ops' device when ``ops`` is given).  ``residual_rel`` measures the
    registration on the raw inputs, ``residual_rel_smoothed`` on the
    presmoothed pair the solver optimized; both transports ride one stacked
    semi-Lagrangian solve.  With ``multilevel`` the ladder's driver builds
    each level's interp from that level's config; ``interp`` then serves
    the final diagnostics only, as in the reference.
    """
    config = config or RegistrationConfig()
    if config.multilevel is not None:
        config = dataclasses.replace(config, solver=config.multilevel.solver)
    grid = grid or make_grid(tuple(rho_R.shape))
    ops = ops or SpectralOps(grid, device=device)
    interp = interp or gn._interp_fn(config.solver)
    rho_R_raw = torch.as_tensor(rho_R, dtype=grid.dtype, device=ops.device)
    rho_T_raw = torch.as_tensor(rho_T, dtype=grid.dtype, device=ops.device)
    rho_R, rho_T = rho_R_raw, rho_T_raw
    if config.presmooth:
        rho_R = ops.smooth(rho_R)
        rho_T = ops.smooth(rho_T)

    if config.multilevel is not None:
        from repro_torch import multilevel

        out = multilevel.solve(rho_R, rho_T, grid, config.multilevel, ops=ops, v0=v0,
                               verbose=verbose)
    else:
        out = gn.solve(
            rho_R, rho_T, grid, config.solver, ops=ops, interp=interp, verbose=verbose, v0=v0
        )
    v = out["v"]

    # deformation map + diagnostics, on the same backend as the solve
    cfg = config.solver
    plan = make_plan(v, grid, ops, cfg.n_t, cfg.incompressible, interp)
    u = semilag.deformation_displacement(v, plan, interp)
    det = ops.jacobian_det(u)
    if config.presmooth:
        rho1_pair = semilag.transport_state(torch.stack([rho_T, rho_T_raw]), plan, interp)[-1]
        rho1, rho1_raw = rho1_pair[0], rho1_pair[1]
    else:
        rho1 = rho1_raw = semilag.transport_state(rho_T, plan, interp)[-1]

    def rel(r1, r0_img, rT_img):
        num = float(torch.linalg.norm((r1 - r0_img).ravel()))
        den = float(torch.linalg.norm((rT_img - r0_img).ravel()))
        return num / max(den, 1e-30)

    out.update(
        {
            "displacement": u,
            "det_grad_y": det,
            "det_min": float(torch.min(det)),
            "det_max": float(torch.max(det)),
            "rho_deformed": rho1,
            "residual_rel": rel(rho1_raw, rho_R_raw, rho_T_raw),
            "residual_rel_smoothed": rel(rho1, rho_R, rho_T),
            "grid": grid,
        }
    )
    return out
