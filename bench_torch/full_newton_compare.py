"""The full Newton solve of the port against the JAX package's, on the CPU,
for ROADMAP Queue C 8 (where and why the two compressible solves part).

For each ``synthetic_problem(--n, amplitude=a)`` of ``--amplitudes``,
compressible and incompressible, with ``GNConfig(beta=1e-2, n_t=4,
max_newton=10, gtol=1e-2, max_cg=50)``, prints one JSON line per case:

* ``whole``: both packages' whole solves on the full Newton Hessian (and,
  for comparison, on the Gauss-Newton one): per-iteration ``cg_iters``,
  the final statuses, and max|dv| absolute and over the reference's
  largest velocity;
* ``steps``: the port's Newton step from each of the reference's own
  iterates: its ``cg_iters``, Armijo trials and status beside the
  reference's, and max|dv| over the largest value;
* ``sensitivity``: the reference's own step from its iterate moved by
  ``--eps`` of its largest value (seeded noise): the ``cg_iters`` before
  and after, and how far the output moves, over its largest value, for
  the full Newton and the Gauss-Newton Hessian.

    PYTHONPATH=src python bench_torch/full_newton_compare.py [--n 16] [--amplitudes 0.5 1.0]

The port runs its plain versions (``device="cpu"``).  Imports both
packages: it is a measurement script, not part of the port.
"""
from __future__ import annotations

import argparse
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

BASE = dict(beta=1e-2, n_t=4, max_newton=10, gtol=1e-2, max_cg=50)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def compare(n: int, amplitude: float, incompressible: bool, eps: float, seed: int) -> dict:
    import jax.numpy as jnp
    import torch

    from repro.core import gauss_newton as jgn
    from repro.core import objective as jobj
    from repro.core.spectral import SpectralOps as JOps
    from repro.data import synthetic as jsyn
    from repro_torch.core import gauss_newton as gn
    from repro_torch.core import objective as obj
    from repro_torch.core.grid import make_grid
    from repro_torch.core.spectral import SpectralOps

    def t(a):
        return torch.from_numpy(np.array(a))

    rho_R, rho_T, _, jgrid = jsyn.synthetic_problem(n, amplitude=amplitude,
                                                     incompressible=incompressible)
    grid = make_grid(n)
    out = {"n": n, "amplitude": amplitude, "incompressible": incompressible, "whole": {}}
    for name, full in (("full_newton", True), ("gauss_newton", False)):
        kw = dict(BASE, incompressible=incompressible, gauss_newton=not full)
        want = jgn.solve(rho_R, rho_T, jgrid, jgn.GNConfig(**kw))
        got = gn.solve(t(rho_R), t(rho_T), grid, gn.GNConfig(**kw), device="cpu")
        out["whole"][name] = {
            "cg_iters": {"jax": [h["cg_iters"] for h in want["history"]],
                         "port": [h["cg_iters"] for h in got["history"]]},
            "status": {"jax": want["status"], "port": got["status"]},
            "max_abs_dv": float(np.abs(got["v"].numpy() - np.asarray(want["v"])).max()),
            "max_rel_dv": _rel(got["v"].numpy(), want["v"]),
        }
        if full:
            newton_iters = want["newton_iters"]

    jops, ops = JOps(jgrid), SpectralOps(grid, device="cpu")
    jprob = jobj.Problem(jgrid, rho_R, rho_T, BASE["beta"], BASE["n_t"], incompressible)
    prob = obj.Problem(grid, t(rho_R), t(rho_T), BASE["beta"], BASE["n_t"], incompressible)
    rng = np.random.default_rng(seed)
    steps, sens = [], []
    cfgs = {full: (jgn.GNConfig(**BASE, incompressible=incompressible, gauss_newton=not full),
                   gn.GNConfig(**BASE, incompressible=incompressible, gauss_newton=not full))
            for full in (True, False)}
    v = jnp.zeros((3,) + jgrid.shape, jnp.float32)
    g0 = jnp.float32(1e-30)
    for it in range(newton_iters):
        jcfg, cfg = cfgs[True]
        jv, jlog = jgn.newton_iteration(v, g0, jprob, jops, jcfg)
        tv, tlog = gn.newton_iteration(t(v), torch.tensor(float(g0)), prob, ops, cfg)
        steps.append({"iter": it,
                      "jax": [int(jlog.cg_iters), int(jlog.ls_iters), int(jlog.status)],
                      "port": [tlog.cg_iters, tlog.ls_iters, tlog.status],
                      "max_rel_dv": _rel(tv.numpy(), jv)})
        noise = rng.standard_normal(v.shape).astype(np.float32)
        moved = v + jnp.asarray(noise) * (eps * float(jnp.abs(v).max()))
        row = {"iter": it}
        for name, full in (("full_newton", True), ("gauss_newton", False)):
            jc = cfgs[full][0]
            base_v, base_log = jgn.newton_iteration(v, g0, jprob, jops, jc)
            pv, plog = jgn.newton_iteration(moved, g0, jprob, jops, jc)
            row[name] = {"cg_iters": [int(base_log.cg_iters), int(plog.cg_iters)],
                         "max_rel_out_move": _rel(pv, base_v)}
        sens.append(row)
        if it == 0:
            g0 = jlog.gnorm
        v = jv
    out["steps"], out["sensitivity"] = steps, sens
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--amplitudes", type=float, nargs="+", default=[0.5, 1.0])
    ap.add_argument("--eps", type=float, default=3e-5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(1)
    for amp in args.amplitudes:
        for incompressible in (False, True):
            print(json.dumps(compare(args.n, amp, incompressible, args.eps, args.seed)),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
