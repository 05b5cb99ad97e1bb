"""Quickstart: the paper's synthetic registration problem (Fig. 5) end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--n 32]

Builds rho_T = (sin^2 x1 + sin^2 x2 + sin^2 x3)/3, transports it with the
paper's analytic velocity to make rho_R, recovers a velocity with the
Gauss-Newton-Krylov solver and reports convergence and the diffeomorphism
diagnostic det(grad y) > 0.
"""
import time

from repro_torch.core import gauss_newton as gn
from repro_torch.core.registration import RegistrationConfig, register
from repro_torch.data import synthetic
from repro_torch.examples.common import parser


def main(argv=None) -> dict:
    args = parser(__doc__, 32).parse_args(argv)
    rho_R, rho_T, _, grid = synthetic.synthetic_problem(args.n, device=args.device)
    print(f"grid {args.n}^3  |  beta=1e-2  n_t=4  gtol=1e-2  (paper defaults)")
    cfg = RegistrationConfig(
        solver=gn.GNConfig(beta=1e-2, n_t=4, max_newton=20, gtol=1e-2, max_cg=50)
    )
    t0 = time.time()
    out = register(rho_R, rho_T, cfg, grid=grid, verbose=True, device=args.device)
    print(f"\nsolved in {time.time() - t0:.1f}s")
    print(f"Newton iters: {out['newton_iters']}  Hessian matvecs: {out['hessian_matvecs']}")
    print(f"relative residual |rho_T(y1)-rho_R| / |rho_T-rho_R|: {out['residual_rel']:.4f}")
    print(f"det(grad y1) in [{out['det_min']:.3f}, {out['det_max']:.3f}]  (diffeomorphic: >0)")
    return out


if __name__ == "__main__":
    main()
