"""Brain-like phantom registration (paper §IV-C analogue).

    PYTHONPATH=src python -m repro_torch.examples.brain_registration [--device cpu] \\
        [--n 32] [--out slices.npz]

A NIREP-like phantom pair, solved with beta continuation 1e-1 -> 1e-2 ->
1e-3 as the paper recommends for real-world data; ``--out`` writes
axial-slice arrays for inspection.
"""
import time

from repro_torch.core import gauss_newton as gn
from repro_torch.core.registration import RegistrationConfig, register
from repro_torch.data import synthetic
from repro_torch.examples.common import parser, save_slices


def main(argv=None) -> dict:
    ap = parser(__doc__, 32)
    ap.add_argument("--out", default=None, help="write axial slices to this .npz")
    args = ap.parse_args(argv)
    rho_R, rho_T, grid = synthetic.brain_like(args.n, seed=3, device=args.device)
    cfg = RegistrationConfig(
        solver=gn.GNConfig(beta=1e-3, beta_continuation=(1e-1, 1e-2), n_t=4, max_newton=8,
                           gtol=1e-2, max_cg=40)
    )
    t0 = time.time()
    out = register(rho_R, rho_T, cfg, grid=grid, verbose=True, device=args.device)
    print(f"\nsolved in {time.time() - t0:.1f}s; residual_rel={out['residual_rel']:.4f}")
    print(f"det(grad y1) in [{out['det_min']:.3f}, {out['det_max']:.3f}]")
    if args.out:
        save_slices(args.out, out, rho_R, rho_T)
    return out


if __name__ == "__main__":
    main()
