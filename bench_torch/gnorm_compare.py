"""Per-iteration J, gradient norm and PCG counts of the port against the JAX
package, on the CPU, for ROADMAP Queue C 1 (does the gradient norm rise in
the reference's own solves too?).

Runs, in both packages, on the same ``brain_like(--n, seed=--seed)`` pair,
made by the JAX package and handed to the port as numpy arrays, so that
the two solves start from the same float32 images:

* ``single``: the default single-level ``register()`` cut to
  ``--max-newton`` Newton iterations (the cut of ``chip_smoke.py``'s
  ``main_path``);
* ``ladder``: ``examples/multilevel_registration.py``'s coarse-to-fine
  solver (3 levels, beta 1e-3 with continuation (1e-1, 1e-2), ``n_t=4``,
  ``max_newton=8``, ``gtol=1e-2``, ``max_cg=40``, V-cycle), not cut.

The port runs its plain versions (``device="cpu"``), which round like its
CUDA kernels (the rounding contract of ``csrc/tricubic.cu``).  Prints one
JSON line per package and solve with every Newton iteration's level, beta,
J, gnorm, rel_gnorm and cg_iters, then one line per solve with the first
iteration where the two part (the level, beta, cg_iters or Armijo trials
differ), with the largest relative difference of J and gnorm before it,
and the iterations whose gradient norm rose.

    PYTHONPATH=src python bench_torch/gnorm_compare.py [--n 128] [--what single ladder]

Imports both packages: it is a measurement script, not part of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

LADDER = dict(beta=1e-3, beta_continuation=(1e-1, 1e-2), n_t=4, max_newton=8, gtol=1e-2,
              max_cg=40)
KEYS = ("level", "beta", "iter", "J", "gnorm", "rel_gnorm", "cg_iters", "armijo_trials")


def _history(out) -> list[dict]:
    return [{k: h.get(k) for k in KEYS} for h in out["history"]]


def images(n: int, seed: int):
    from repro.data import synthetic

    rho_R, rho_T, _ = synthetic.brain_like(n, seed=seed)
    return np.asarray(rho_R), np.asarray(rho_T)


def run_jax(rho_R, rho_T, what: str, max_newton: int) -> dict:
    import jax.numpy as jnp

    from repro.core import gauss_newton as gn
    from repro.core.grid import make_grid
    from repro.core.registration import RegistrationConfig, register
    from repro.multilevel.hierarchy import MultilevelConfig

    grid = make_grid(rho_R.shape)
    rho_R, rho_T = jnp.asarray(rho_R), jnp.asarray(rho_T)
    if what == "single":
        cfg = RegistrationConfig(solver=gn.GNConfig(max_newton=max_newton, autotune="off"))
    else:
        cfg = RegistrationConfig(multilevel=MultilevelConfig(
            solver=gn.GNConfig(**LADDER, autotune="off"), n_levels=3, precond="vcycle"))
    t0 = time.perf_counter()
    out = register(rho_R, rho_T, cfg, grid=grid)
    return {"package": "repro (JAX, CPU)", "seconds": time.perf_counter() - t0,
            "history": _history(out), "config": dataclasses.asdict(cfg)["solver"]}


def run_port(rho_R, rho_T, what: str, max_newton: int) -> dict:
    import torch

    from repro_torch.core import gauss_newton as gn
    from repro_torch.core.grid import make_grid
    from repro_torch.core.registration import RegistrationConfig, register
    from repro_torch.multilevel import MultilevelConfig

    grid = make_grid(rho_R.shape)
    rho_R, rho_T = torch.from_numpy(rho_R.copy()), torch.from_numpy(rho_T.copy())
    if what == "single":
        cfg = RegistrationConfig(solver=gn.GNConfig(max_newton=max_newton))
    else:
        cfg = RegistrationConfig(multilevel=MultilevelConfig(
            solver=gn.GNConfig(**LADDER), n_levels=3, precond="vcycle"))
    t0 = time.perf_counter()
    out = register(rho_R, rho_T, cfg, grid=grid, device="cpu")
    return {"package": "repro_torch (plain versions, CPU)", "seconds": time.perf_counter() - t0,
            "history": _history(out)}


def first_parting(a: list[dict], b: list[dict]) -> dict | None:
    """The first iteration whose level, beta, cg_iters or Armijo trials
    differ between the two histories (or the end, if their lengths do),
    with the largest relative difference of J and of gnorm before it."""
    worst = {"J": 0.0, "gnorm": 0.0}
    for ha, hb in zip(a, b):
        for key in ("level", "beta", "cg_iters", "armijo_trials"):
            if ha[key] != hb[key]:
                return {"at": {k: ha[k] for k in ("level", "beta", "iter")}, "key": key,
                        "jax": ha[key], "port": hb[key], "max_rel_diff_before": worst}
        for key in worst:
            worst[key] = max(worst[key], abs(ha[key] - hb[key]) / abs(ha[key]))
    if len(a) != len(b):
        return {"at": "end", "key": "newton_iters", "jax": len(a), "port": len(b),
                "max_rel_diff_before": worst}
    return {"at": None, "max_rel_diff": worst}


def rises(history: list[dict]) -> list[dict]:
    """The iterations whose gradient norm exceeds the previous iteration's
    at the same level and beta."""
    return [{k: b[k] for k in ("level", "beta", "iter")}
            for a, b in zip(history, history[1:])
            if (a["level"], a["beta"]) == (b["level"], b["beta"]) and b["gnorm"] > a["gnorm"]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-newton", type=int, default=3)
    ap.add_argument("--what", nargs="+", default=["single", "ladder"],
                    choices=["single", "ladder"])
    args = ap.parse_args()
    rho_R, rho_T = images(args.n, args.seed)
    for what in args.what:
        runs = {}
        for name, fn in (("jax", run_jax), ("port", run_port)):
            runs[name] = fn(rho_R, rho_T, what, args.max_newton)
            print(json.dumps({"solve": what, "n": args.n, "seed": args.seed, **runs[name]}),
                  flush=True)
        parting = first_parting(runs["jax"]["history"], runs["port"]["history"])
        print(json.dumps({"solve": what, "n": args.n, "first_parting": parting,
                          "gnorm_rises_at": {k: rises(r["history"]) for k, r in runs.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
