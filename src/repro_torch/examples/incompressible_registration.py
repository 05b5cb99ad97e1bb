"""Volume-preserving (incompressible) registration, the paper's hardest mode.

    PYTHONPATH=src python -m repro_torch.examples.incompressible_registration \\
        [--device cpu] [--n 24]

Enforces div v = 0 through the spectral Leray projection; the map is then
locally volume preserving: det(grad y1) = 1 up to discretization error.
"""
import time

from repro_torch.core import gauss_newton as gn
from repro_torch.core.registration import RegistrationConfig, register
from repro_torch.data import synthetic
from repro_torch.examples.common import parser


def main(argv=None) -> dict:
    args = parser(__doc__, 24).parse_args(argv)
    rho_R, rho_T, _, grid = synthetic.synthetic_problem(args.n, incompressible=True,
                                                        amplitude=0.5, device=args.device)
    cfg = RegistrationConfig(
        solver=gn.GNConfig(beta=1e-2, n_t=4, incompressible=True, max_newton=10, gtol=1e-2)
    )
    t0 = time.time()
    out = register(rho_R, rho_T, cfg, grid=grid, verbose=True, device=args.device)
    print(f"\nsolved in {time.time() - t0:.1f}s; residual_rel={out['residual_rel']:.4f}")
    print(f"det(grad y1) in [{out['det_min']:.4f}, {out['det_max']:.4f}]"
          "  (volume preserving: ~1)")
    return out


if __name__ == "__main__":
    main()
