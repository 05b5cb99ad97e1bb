"""Coarse-to-fine registration (``repro_torch.multilevel``, CLAIRE-style
continuation).

    PYTHONPATH=src python -m repro_torch.examples.multilevel_registration \\
        [--device cpu] [--n 32] [--out slices.npz]

Solves the brain-like phantom pair through a 3-level ladder (n/4 -> n/2 ->
n) with the beta-continuation schedule spread across the levels and the
V-cycle preconditioner at every warm level, then solves again at the fine
resolution alone for the cost comparison: most of the Newton progress is
bought at coarse resolution.  ``config()`` is the ladder's configuration,
which ``chip_smoke.py``'s ``multilevel_path`` runs at 256^3.
"""
import time

from repro_torch.core import gauss_newton as gn
from repro_torch.core.registration import RegistrationConfig, register
from repro_torch.data import synthetic
from repro_torch.examples.common import parser, save_slices
from repro_torch.multilevel import MultilevelConfig

SOLVER = dict(beta=1e-3, beta_continuation=(1e-1, 1e-2), n_t=4, max_newton=8, gtol=1e-2,
              max_cg=40)
N_LEVELS = 3


def config(interp_method: str = "auto") -> RegistrationConfig:
    """The 3-level ladder with the V-cycle preconditioner."""
    solver = gn.GNConfig(**SOLVER, interp_method=interp_method)
    return RegistrationConfig(
        multilevel=MultilevelConfig(solver=solver, n_levels=N_LEVELS, precond="vcycle")
    )


def main(argv=None) -> dict:
    ap = parser(__doc__, 32)
    ap.add_argument("--out", default=None, help="write axial slices to this .npz")
    args = ap.parse_args(argv)
    rho_R, rho_T, grid = synthetic.brain_like(args.n, seed=3, device=args.device)
    t0 = time.time()
    out = register(rho_R, rho_T, config(), grid=grid, verbose=True, device=args.device)
    print(f"\nmultilevel: {time.time() - t0:.1f}s residual_rel={out['residual_rel']:.4f} "
          f"det in [{out['det_min']:.3f}, {out['det_max']:.3f}]")
    for lv in out["levels"]:
        print(f"  level {lv['shape']} betas={lv['betas']} newton={lv['newton_iters']} "
              f"matvecs={lv['hessian_matvecs']} (fine-equiv {lv['fine_equiv_matvecs']:.1f}) "
              f"{lv['wall_s']:.1f}s")
    print(f"  fine-grid matvecs: {out['fine_matvecs']}  "
          f"fine-equivalent total: {out['fine_equiv_matvecs']:.1f}  "
          f"(+{out['precond_fine_equiv_matvecs']:.1f} inside the V-cycle)")
    t0 = time.time()
    single = register(rho_R, rho_T, RegistrationConfig(solver=gn.GNConfig(**SOLVER)),
                      grid=grid, device=args.device)
    print(f"single-level: {time.time() - t0:.1f}s residual_rel={single['residual_rel']:.4f} "
          f"matvecs={single['hessian_matvecs']}")
    if args.out:
        save_slices(args.out, out, rho_R, rho_T)
    out["single"] = single
    return out


if __name__ == "__main__":
    main()
