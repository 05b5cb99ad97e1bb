"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
kernel against its plain PyTorch version on the card, and drives every path
of the port that runs them, each with the launch counters set to 0 just
before it and read just after:

* ``solve_parity``, ``ml_solve_parity``: the single-level and the
  coarse-to-fine ``register()`` at 64^3 give the same solve through the
  kernels as through the plain versions (and the plain run launches none);
* ``multilevel_path``: the example's coarse-to-fine ``register()`` (ladder
  64^3 -> 128^3 -> 256^3, V-cycle preconditioner) at 256^3;
* ``main_path``: the default single-level ``register()`` at 256^3;
* ``warp``: the template resampled through the returned deformation (the
  single-field displace kernel);
* ``spectral``: the fused biharmonic scaling of a 256^3 spectrum;
* ``cohort_solve_parity``: ``gn.solve_cohort`` of 4 subjects at 64^3
  gives the same solve through the kernels as through the plain versions,
  and the same counts as 4 independent solves;
* ``cohort_path``: ``gn.solve_cohort`` of 4 brain phantom pairs at 256^3,
  beside the 4 independent single-level solves of the same pairs;
* ``serve_path``: ``launch.reg_serve.serve_jobs`` of 6 such pairs through
  4 slots, with its refills and per-job billing;
* ``full_newton_parity``, ``full_newton_path``: the single-level
  ``register()`` on the full Newton Hessian (``gauss_newton=False``),
  kernels against plain versions at 64^3, and at 256^3 beside
  ``main_path``;
* ``resilience_path``: K1/K2 over a cohort with one subject poisoned by
  NaN or +-inf (``poisoned_launches``), then ``serve_path``'s jobs with a
  NaN injected into one of them and retried, the others bit for bit
  ``serve_path``'s;
* ``resume_path``: the same stream killed at its third iteration and
  resumed from its latest snapshot, bit for bit ``serve_path``'s.

The launches of K1 and K2 on the solve and serve paths must equal the
counts derived from the code.  K1-K3 stage a tile's stencil box in shared
memory where it is small enough: on random displacements (``kernel_parity``), on smooth
ones, on the solve's own fields (``kernel_parity_solve``) and, K3, on the
warp's deformation they must equal their plain versions bit for bit and
stage as many tiles as the plain model ``tricubic.staged_tiles`` says; on
``main_path`` and ``multilevel_path`` every launch counts its staged
tiles (``tricubic.count_staged``), and K1 and K2 must each stage at least
``MIN_PATH_STAGED_SHARE`` of their tiles at each grid size.  Then it times
the kernels beside their bounds (K1 and K2 also at 64^3 and 128^3, and
over the cohort's 4 subjects in one launch) and profiles one more Newton
iteration by kernel class, single-level, V-cycle and cohort.  K1 and K2
with their subject axis are also held, on cohorts of 4 random and smooth
displacements (``cohort_kernel_parity``), against the plain cohort
versions and against one launch per subject, bit for bit.  Every phase prints one JSON
line; any failed phase ends the run with a nonzero exit code.  The last
line is ``{"ok": true, "device": {...}}``.

Imports neither JAX nor the JAX package.  Exits nonzero without printing a
result when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "bench_torch"))  # fmad_ab: shared timing helpers

SEED = 0
N_MAIN = 256
N_SOLVE_PARITY = 64
NONCUBIC = (40, 48, 36)  # N3 % 8 != 0: no tile condition
MAX_DISP = 12.0  # voxels, beyond the TPU kernels' halo of 4
# smooth displacements: at most SMOOTH_DISP voxels at 256^3, scaled by n/256
# (a transport step's departure field moves ~2 voxels at 256^3), and a
# rougher one of NONCUBIC_SMOOTH_DISP voxels on the non-cubic grid
SMOOTH_DISP = 2.0
NONCUBIC_SMOOTH_DISP = 16.0
TIME_SIZES = (64, 128, N_MAIN)  # the ladder's grids
# the share of K1's and of K2's tiles a solve path must stage at each grid
# size: with the rest at the unstaged branch's slowest measured cost (random
# displacements; PERF.md section 6, the same-call A/B) the launches
# still take less time than the first design's, at each of TIME_SIZES
MIN_PATH_STAGED_SHARE = 0.96
V_TOL = 1e-4  # solve parity: max |v_kernel - v_ref|
MAX_NEWTON = 3
# the cohort: the reference's cohort width (BENCH_cohort.json subjects 4,
# serve slots 4) on brain_like(n, seed=s), s = 0..S-1; the server streams 6
# such jobs, cut to SERVE_MAX_NEWTON Newton iterations
COHORT_S = 4
COHORT_V_RTOL = 5e-4  # cohort against independent solves (tests/test_cohort.py)
SERVE_JOBS = 6
SERVE_MAX_NEWTON = 2
SPECTRAL_SHAPES = ((N_MAIN,) * 3, (8, 16, 128), (16, 8, 256), NONCUBIC)
SPECTRAL_BETAS = ((1.0,), (1e-2, 1.0))
SPECTRAL_RTOL = 2e-5  # kernel against plain version (tests/test_kernels.py)
REG_APPLY_RTOL = 1e-3  # ifftn of the output against reg_apply, of max|reg_apply|
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, an FMA counted as 2
# the same units without FMA: the kernels build with -fmad=false (rule 1 of
# the rounding contract in csrc/tricubic.cu), so each multiply and each add
# is an instruction of its own
F32_UNFUSED_OPS_PER_S = F32_FLOPS_PER_S / 2
# each kernel: its source, the TPU kernel it replaces, its __global__
# symbols (K1 and K2 have a second one for a cohort of subjects) and the
# phase whose run gives its launches in the kernels line
KERNELS = {
    "tricubic_apply": {
        "source": "src/repro_torch/kernels/csrc/tricubic.cu",
        "replaces": "src/repro/kernels/tricubic.py:243",
        "symbols": ("apply_kernel", "apply_cohort_kernel"), "path": "main_path",
    },
    "tricubic_displace_many": {
        "source": "src/repro_torch/kernels/csrc/tricubic.cu",
        "replaces": "src/repro/kernels/tricubic.py:202",
        "symbols": ("displace_kernel", "displace_cohort_kernel"), "path": "main_path",
    },
    "tricubic_displace": {
        "source": "src/repro_torch/kernels/csrc/tricubic.cu",
        "replaces": "src/repro/kernels/tricubic.py:57",
        "symbols": ("field_warp_kernel",), "path": "warp",
    },
    "biharmonic_scale": {
        "source": "src/repro_torch/kernels/csrc/spectral_diag.cu",
        "replaces": "src/repro/kernels/spectral_diag.py:27",
        "symbols": ("biharmonic_kernel",), "path": "spectral",
    },
}

SYMBOLS = tuple(sym for meta in KERNELS.values() for sym in meta["symbols"])


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **payload) -> None:
    print(json.dumps({"phase": phase, **payload}), flush=True)


def _reset_launches() -> None:
    from repro_torch.kernels import spectral_diag, tricubic

    tricubic.reset_launches()
    spectral_diag.reset_launches()


def _launches() -> dict:
    from repro_torch.kernels import spectral_diag, tricubic

    return {**tricubic.LAUNCHES, **spectral_diag.LAUNCHES}


def _is_symbol(symbol: str, name: str) -> bool:
    """``name`` (a mangled entry or a demangled profiler name) is the kernel
    ``symbol`` itself, not a longer name that contains it."""
    return f"{len(symbol)}{symbol}" in name or re.search(rf"(?<!\w){symbol}\(", name) is not None


# --------------------------------------------------------------------------- #
def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi_line,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit("device", **info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    build.library()
    secs = time.perf_counter() - t0
    log = build.ptxas_log()
    per_kernel, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = next((sym for sym in SYMBOLS if _is_symbol(sym, m.group(1))),
                           m.group(1))
            per_kernel[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            per_kernel[current].update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3))
            )
        m = re.search(r"Used (\d+) registers", line)
        if m:
            per_kernel[current]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            per_kernel[current]["smem_bytes"] = int(s.group(1)) if s else 0
    require(set(per_kernel) >= set(SYMBOLS),
            f"ptxas report lacks a kernel: {log}")
    emit("build", seconds=secs, dir=str(build.build_dir()), ptxas=per_kernel)
    spills = {k: v for k, v in per_kernel.items()
              if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    require(not spills, f"ptxas spilled registers: {spills}")


# --------------------------------------------------------------------------- #
def _inputs(shape, c, gen, dev):
    f = torch.randn((c,) + shape, generator=gen, device=dev)
    d = (torch.rand((3,) + shape, generator=gen, device=dev) * 2 - 1) * MAX_DISP
    return f, d


def _compare(got, want) -> float:
    """The kernels equal their plain versions bit for bit (the rounding
    contract of csrc/tricubic.cu)."""
    err = float((got - want).abs().max())
    require(err == 0.0, f"kernel disagrees with plain version: max abs err {err}")
    return err


def _tile_case(name, f, disp, plan=None) -> dict:
    """One K1 (``plan``, made from ``disp``), K2 (``disp``) or K3 (``f`` of
    one field, ``disp``) launch with the staged-tile counter, against its
    plain version on the same inputs: bit for bit, and as many staged tiles
    as the plain model counts."""
    from fmad_ab import plain
    from repro_torch.kernels import tricubic

    with tricubic.count_staged() as counts:
        if name == "tricubic_apply":
            got = tricubic.tricubic_apply_cuda(f, plan)
        elif name == "tricubic_displace_many":
            got = tricubic.tricubic_displace_many_cuda(f, disp)
        else:
            got = tricubic.tricubic_displace_cuda(f, disp)
    want = plain(name, f, disp, plan)
    torch.cuda.synchronize()
    err = _compare(got, want)
    del got, want
    kernel = counts[(name, tuple(f.shape[1:]))]["staged"]
    base = tricubic.stencil_base(name, disp, plan)
    model = tricubic.staged_tiles(base, tricubic.BOX_ROWS_OF[name])
    tiles = tricubic.n_tiles(f.shape[1:])
    require(kernel == model, f"{name} staged {kernel} tiles, the model {model}")
    extent = tricubic.tile_extents(base)
    return {"kernel": name, "shape": list(f.shape[1:]), "C": int(f.shape[0]),
            "max_disp": float(disp.abs().max()),
            "max_abs_err": err, "staged_tiles": kernel, "tiles": tiles,
            "staged_share": kernel / tiles,
            # the largest box of any tile: (x1, x2) rows and voxels along x3
            "box_rows_max": int((extent[0] * extent[1]).max()),
            "box_width_max": int(extent[2].max())}


def phase_kernel_parity(dev) -> dict:
    """Every kernel against its plain version on the same inputs: K1 (C=1..3)
    and K2 (C=3) and K3 at 256^3 and on a non-cubic grid with random |disp|
    up to 12 voxels (no tile stages there) and on smooth displacements
    (most tiles stage), each with its staged tiles against the model; K4
    on four shapes and two beta sets,
    its output also held against ``SpectralOps.reg_apply`` after an inverse
    FFT."""
    from fmad_ab import smooth_disp
    from repro_torch.core.grid import make_grid
    from repro_torch.core.spectral import SpectralOps
    from repro_torch.kernels import ref, spectral_diag

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {name: 0.0 for name in KERNELS}
    cases = []
    for shape, smooth in (((N_MAIN,) * 3, SMOOTH_DISP), (NONCUBIC, NONCUBIC_SMOOTH_DISP)):
        for field in ("random", "smooth"):
            for name, chans in (("tricubic_apply", (1, 2, 3)), ("tricubic_displace_many", (3,)),
                                ("tricubic_displace", (1,))):
                for c in chans:
                    f, d = _inputs(shape, c, gen, dev)
                    if field == "smooth":
                        d = smooth_disp(shape, smooth, gen, dev)
                    if name == "tricubic_apply":
                        case = _tile_case(name, f, d, ref.make_interp_plan(d))
                    else:
                        case = _tile_case(name, f, d)
                    errs[name] = max(errs[name], case["max_abs_err"])
                    cases.append({"field": field, **case})
                    del f, d
    for shape in SPECTRAL_SHAPES:
        f = torch.randn(shape, generator=gen, device=dev)
        spec = torch.fft.fftn(f)
        re, im = spec.real.contiguous(), spec.imag.contiguous()
        ops = SpectralOps(make_grid(shape), device=dev)
        for betas in SPECTRAL_BETAS:
            got = spectral_diag.biharmonic_scale_cuda(re, im, betas)
            want = spectral_diag.biharmonic_scale_ref(re, im, betas)
            torch.cuda.synchronize()
            err, rel = 0.0, 0.0
            for g, w in zip(got, want):
                e = (g - w).abs()
                require(bool(torch.all(e <= SPECTRAL_RTOL * w.abs())),
                        f"biharmonic_scale disagrees with plain version at {shape}, {betas}: "
                        f"max abs err {float(e.max())}")
                err = max(err, float(e.max()))
            for c, beta in enumerate(betas):
                back = torch.fft.ifftn(torch.complex(got[0][c], got[1][c])).real
                reg = ops.reg_apply(f, beta)
                scale = float(reg.abs().max())
                rel = max(rel, float((back - reg).abs().max()) / scale)
            require(rel < REG_APPLY_RTOL,
                    f"ifftn(biharmonic_scale) != reg_apply at {shape}, {betas}: {rel}")
            errs["biharmonic_scale"] = max(errs["biharmonic_scale"], err)
            cases.append({"kernel": "biharmonic_scale", "shape": list(shape),
                          "betas": list(betas), "max_abs_err": err,
                          "max_rel_err_vs_reg_apply": rel})
            del got, want
        del f, spec, re, im, ops
    emit("kernel_parity", tricubic="bit for bit", spectral_rtol=SPECTRAL_RTOL,
         reg_apply_rtol=REG_APPLY_RTOL, cases=cases)
    return errs


def _solve_fields(out, dev) -> dict:
    """The 256^3 solve's own K1 and K2 inputs at its solved velocity: the
    departure displacement of a transport step (K1's plan) with a C=2 stack
    of deformed images, and the RK2 midpoint displacement -dt v with the
    three velocity components (K2)."""
    from repro_torch.core import gauss_newton as gn
    from repro_torch.core import planner
    from repro_torch.kernels import ref

    grid, v = out["grid"], out["v"]
    dt = 1.0 / gn.GNConfig().n_t
    h = torch.tensor(grid.spacing, dtype=torch.float32, device=dev).reshape(3, 1, 1, 1)
    vg = (v / h).contiguous()
    lam = out["rho_deformed"]
    disp = planner.departure_displacement(v, grid, dt)
    return {"disp": disp, "plan": ref.make_interp_plan(disp),
            "f2": torch.stack([lam, lam * lam]).contiguous(),
            "vg": vg, "d_star": (-dt * vg).contiguous()}


def phase_kernel_parity_solve(solve, errs) -> None:
    """K1 and K2 on the 256^3 solve's own fields (``_solve_fields``): bit
    for bit, the staged-tile counter equal to the model, and some tiles of
    K1's plan staged."""
    cases = [_tile_case("tricubic_apply", solve["f2"], solve["disp"], solve["plan"]),
             _tile_case("tricubic_displace_many", solve["vg"], solve["d_star"])]
    for case in cases:
        errs[case["kernel"]] = max(errs[case["kernel"]], case["max_abs_err"])
    emit("kernel_parity_solve", n=N_MAIN, cases=cases)
    require(cases[0]["staged_tiles"] > 0, "no tile of the solve's K1 plan was staged")


# --------------------------------------------------------------------------- #
def _register(n, method, dev, gauss_newton=True):
    """The default single-level ``register()`` on the brain phantom pair,
    cut to ``MAX_NEWTON`` Newton iterations; with ``gauss_newton=False``
    on the full Newton Hessian.  Returns (result, images)."""
    from repro_torch.core import gauss_newton as gn
    from repro_torch.core.registration import RegistrationConfig, register
    from repro_torch.data import synthetic

    rho_R, rho_T, grid = synthetic.brain_like(n, seed=SEED, device=dev)
    cfg = RegistrationConfig(solver=gn.GNConfig(max_newton=MAX_NEWTON, interp_method=method,
                                                gauss_newton=gauss_newton))
    return register(rho_R, rho_T, cfg, grid=grid, device=dev), (rho_R, rho_T)


def phase_solve_parity(dev) -> None:
    outs = {m: _register(N_SOLVE_PARITY, m, dev)[0] for m in ("auto", "ref")}
    cg = {m: [h["cg_iters"] for h in o["history"]] for m, o in outs.items()}
    dv = float((outs["auto"]["v"] - outs["ref"]["v"]).abs().max())
    emit("solve_parity", n=N_SOLVE_PARITY, cg_iters=cg,
         newton_iters={m: o["newton_iters"] for m, o in outs.items()}, max_abs_dv=dv)
    require(cg["auto"] == cg["ref"], f"cg_iters differ: {cg}")
    require(outs["auto"]["newton_iters"] == outs["ref"]["newton_iters"], "Newton counts differ")
    require(dv < V_TOL, f"max |v_kernel - v_ref| = {dv} >= {V_TOL}")


def phase_full_newton_parity(dev) -> None:
    """The single-level ``register()`` at 64^3 on the full Newton Hessian
    (``GNConfig(gauss_newton=False)``) through the kernels and through the
    plain versions: identical counts, max|dv| 0, and no launch on the plain
    run; the kernel run's launches as counted from the code."""
    outs, launches = {}, {}
    for method in ("auto", "ref"):
        _reset_launches()
        outs[method] = _register(N_SOLVE_PARITY, method, dev, gauss_newton=False)[0]
        torch.cuda.synchronize()
        launches[method] = _launches()
    hist = {m: [{k: h[k] for k in ("cg_iters", "armijo_trials", "status")} for h in o["history"]]
            for m, o in outs.items()}
    dv = float((outs["auto"]["v"] - outs["ref"]["v"]).abs().max())
    expected = _expected_launches(outs["auto"]["history"])
    emit("full_newton_parity", n=N_SOLVE_PARITY, history=hist,
         newton_iters={m: o["newton_iters"] for m, o in outs.items()}, max_abs_dv=dv,
         launches=launches, expected_launches_auto=expected)
    require(hist["auto"] == hist["ref"], f"full Newton counts differ: {hist}")
    require(dv == 0.0, f"full Newton max |v_kernel - v_ref| = {dv} != 0")
    require(all(n == 0 for n in launches["ref"].values()),
            f"the plain full Newton run launched kernels: {launches['ref']}")
    _require_launched(launches["auto"], expected, "full_newton_parity")
    _check_solution(outs["auto"])


def _solve_launches(history) -> tuple[int, int]:
    """(K2, K1) launches of ``gn.solve``'s Newton iterations in ``history``.

    K2 (departure solve): 2 per Newton state (+v and -v), 1 per Armijo
    trial.  K1 (planned apply): 4 for the state and 4 for the adjoint
    transport of each Newton state, 8 per Hessian matvec, 4 per Armijo
    trial.  The full Newton matvec launches as the Gauss-Newton one: its
    incremental state series and its incremental adjoint take one C=2 step
    each per time step, and its extra spectral terms launch nothing.
    """
    newton = len(history)
    trials = sum(1 + h["armijo_trials"] for h in history)
    matvecs = sum(h["cg_iters"] for h in history)
    return 2 * newton + trials, 8 * newton + 8 * matvecs + 4 * trials


def _expected_launches(history) -> dict:
    """Launches of the single-level ``register()``, counted from its history:
    the solve, then the final diagnostics (2 K2 for the plan; 5 K1 for the
    deformation map and 4 for the final stacked transport)."""
    k2, k1 = _solve_launches(history)
    return {"tricubic_apply": k1 + 5 + 4, "tricubic_displace_many": k2 + 2,
            "tricubic_displace": 0, "biharmonic_scale": 0}


def _vcycle_k1_per_apply(n_levels: int, n_cg: int, n_cg_coarse: int) -> int:
    """K1 launches of one V-cycle application over ``n_levels`` ladder levels:
    at level l, ``iters`` coarse GN matvecs (8 K1 each) and ``iters + 1``
    applications one level down (none below the coarsest).  The Galerkin
    coarse states are restricted, not transported: no launches."""
    def apply(l: int) -> int:
        if l == 0:
            return 0
        iters = n_cg_coarse if l == 1 else n_cg
        return 8 * iters + (iters + 1) * apply(l - 1)

    return apply(n_levels - 1)


def _expected_ml_launches(out, mcfg) -> dict:
    """Launches of the coarse-to-fine ``register()`` with the V-cycle,
    counted from its per-level history: each level's solve (as
    ``_solve_launches``), 2 K2 and 8 K1 for each warm level's cold gradient
    (one Newton state at v = 0), ``cg_iters + 1`` preconditioner
    applications per Newton iteration of a warm level (each
    ``_vcycle_k1_per_apply`` over the ladder levels the recursion floor
    keeps), and the final diagnostics."""
    k2 = k1 = 0
    shapes = [lv["shape"] for lv in out["levels"]]
    for lv, rec in enumerate(out["levels"]):
        hist = [h for h in out["history"] if h["level"] == lv]
        a, b = _solve_launches(hist)
        k2, k1 = k2 + a, k1 + b
        if rec["warm_start"]:
            k2, k1 = k2 + 2, k1 + 8
        if lv > 0 and mcfg.precond_kind == "vcycle":
            kept = sum(1 for i in range(lv + 1)
                       if min(shapes[i]) >= mcfg.precond_min_size or i >= lv - 1)
            per = _vcycle_k1_per_apply(kept, mcfg.precond_cg_iters, mcfg.precond_coarse_cg_iters)
            k1 += per * sum(h["cg_iters"] + 1 for h in hist)
    return {"tricubic_apply": k1 + 5 + 4, "tricubic_displace_many": k2 + 2,
            "tricubic_displace": 0, "biharmonic_scale": 0}


def _check_solution(out) -> None:
    scalars = [out["det_min"], out["det_max"], out["residual_rel"]]
    scalars += [x for h in out["history"] for x in (h["J"], h["gnorm"])]
    require(all(np.isfinite(scalars)), f"non-finite diagnostics: {scalars}")
    require(bool(torch.isfinite(out["v"]).all()), "non-finite velocity")
    require(out["det_min"] > 0, f"det_min = {out['det_min']} <= 0")


def _require_launched(launches, expected, path: str) -> None:
    """The kernels of ``path`` ran, and exactly as often as the code says."""
    for name, meta in KERNELS.items():
        if meta["path"] == path or expected[name] > 0:
            require(launches[name] > 0, f"{name} was not launched on {path}")
    require(launches == expected,
            f"{path}: launch counts {launches} != counted from code {expected}")


def _path_staged(counts) -> dict:
    """``tricubic.count_staged()``'s counts as {kernel: {grid: {staged,
    tiles, share}}}, with "all" the kernel's launches at every grid."""
    out = {}
    for (name, shape), c in sorted(counts.items()):
        grids = out.setdefault(name, {})
        grids["x".join(map(str, shape))] = dict(c)
        total = grids.setdefault("all", {"staged": 0, "tiles": 0})
        total["staged"] += c["staged"]
        total["tiles"] += c["tiles"]
    for grids in out.values():
        for c in grids.values():
            c["share"] = c["staged"] / c["tiles"]
    return out


def _require_staged(staged, path: str) -> None:
    """K1 and K2 each staged at least MIN_PATH_STAGED_SHARE of the tiles
    of their launches on ``path``, at every grid size."""
    require(set(staged) == {"tricubic_apply", "tricubic_displace_many"},
            f"{path}: staged tiles counted for {sorted(staged)}")
    low = {f"{name} {grid}": c["share"] for name, grids in staged.items()
           for grid, c in grids.items() if c["share"] < MIN_PATH_STAGED_SHARE}
    require(not low, f"{path}: staged share below {MIN_PATH_STAGED_SHARE}: {low}")


def phase_main(dev) -> tuple[dict, dict, tuple, dict]:
    from repro_torch import telemetry
    from repro_torch.kernels import tricubic

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with telemetry.ListSink() as sink, tricubic.count_staged() as counts:
        out, images = _register(N_MAIN, "auto", dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = _launches()
    staged = _path_staged(counts)
    walls = [r["wall_s"] for r in sink.records if r["kind"] == "newton_iter"]
    iters = [
        {"iter": h["iter"], "J": h["J"], "gnorm": h["gnorm"], "rel_gnorm": h["rel_gnorm"],
         "cg_iters": h["cg_iters"], "armijo_trials": h["armijo_trials"], "wall_s": w}
        for h, w in zip(out["history"], walls)
    ]
    expected = _expected_launches(out["history"])
    emit("main_path", n=N_MAIN, seconds=secs, iterations=iters,
         newton_iters=out["newton_iters"], hessian_matvecs=out["hessian_matvecs"],
         status=out["status"], det_min=out["det_min"], det_max=out["det_max"],
         residual_rel=out["residual_rel"],
         residual_rel_smoothed=out["residual_rel_smoothed"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, expected_launches=expected, staged_tiles=staged)
    _require_launched(launches, expected, "main_path")
    _require_staged(staged, "main_path")
    _check_solution(out)
    out["smoke"] = {"seconds": secs, "iterations": iters,
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return out, launches, images, staged


def phase_full_newton(main_out, dev) -> dict:
    """The single-level ``register()`` at 256^3 on the full Newton Hessian,
    default config otherwise, cut to MAX_NEWTON as ``main_path``: seconds,
    peak memory, per-iteration cg_iters and gnorm beside ``main_path``'s
    (same call), launches against the count from the code, K1/K2's staged
    share, and every status a health status (the full Hessian may be
    indefinite away from the solution, so a ``pcg_breakdown`` is reported,
    not failed)."""
    from repro_torch import telemetry
    from repro_torch.kernels import tricubic
    from repro_torch.resilience import health

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with telemetry.ListSink() as sink, tricubic.count_staged() as counts:
        out, _ = _register(N_MAIN, "auto", dev, gauss_newton=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _launches()
    staged = _path_staged(counts)
    walls = [r["wall_s"] for r in sink.records if r["kind"] == "newton_iter"]

    def iters(o, w):
        return [{k: h[k] for k in ("iter", "J", "gnorm", "rel_gnorm", "cg_iters",
                                   "armijo_trials", "status")} | {"wall_s": x}
                for h, x in zip(o["history"], w)]

    expected = _expected_launches(out["history"])
    emit("full_newton_path", n=N_MAIN, seconds=secs, iterations=iters(out, walls),
         newton_iters=out["newton_iters"], hessian_matvecs=out["hessian_matvecs"],
         status=out["status"], det_min=out["det_min"], det_max=out["det_max"],
         residual_rel=out["residual_rel"], max_memory_allocated=peak, launches=launches,
         expected_launches=expected, staged_tiles=staged,
         main_path={"seconds": main_out["seconds"], "iterations": main_out["iterations"],
                    "max_memory_allocated": main_out["max_memory_allocated"]})
    _require_launched(launches, expected, "full_newton_path")
    _require_staged(staged, "full_newton_path")
    _check_solution(out)
    statuses = [h["status"] for h in out["history"]] + [out["status"]]
    require(all(st in health.STATUS_NAMES.values() for st in statuses),
            f"full_newton_path: statuses {statuses}")
    return {"launches": launches, "staged": staged}


# --------------------------------------------------------------------------- #
def _register_ml(n, method, dev):
    """The coarse-to-fine ``register()`` of
    ``repro_torch.examples.multilevel_registration`` (3 levels, V-cycle
    preconditioner) on the brain phantom pair, with
    ``interp_method=method``.  Returns (result, multilevel config, images)."""
    from repro_torch.core.registration import register
    from repro_torch.data import synthetic
    from repro_torch.examples import multilevel_registration

    rho_R, rho_T, grid = synthetic.brain_like(n, seed=SEED, device=dev)
    cfg = multilevel_registration.config(method)
    out = register(rho_R, rho_T, cfg, grid=grid, device=dev)
    return out, cfg.multilevel, (rho_R, rho_T)


def _level_summary(out) -> list[dict]:
    return [
        {k: lv[k] for k in ("shape", "betas", "newton_iters", "hessian_matvecs",
                            "precond_fine_equiv_matvecs", "wall_s", "rel_gnorm")}
        | {key: [h[key] for h in out["history"] if h["level"] == i]
           for key in ("cg_iters", "J", "gnorm")}
        for i, lv in enumerate(out["levels"])
    ]


def phase_ml_solve_parity(dev) -> None:
    """The coarse-to-fine solve at 64^3 through the kernels and through the
    plain versions: the same per-level Newton counts and per-iteration
    cg_iters, |dv| < V_TOL, and no kernel launch at all on the plain run."""
    outs, launches = {}, {}
    for method in ("auto", "ref"):
        _reset_launches()
        outs[method], mcfg, _ = _register_ml(N_SOLVE_PARITY, method, dev)
        torch.cuda.synchronize()
        launches[method] = _launches()
    levels = {m: _level_summary(o) for m, o in outs.items()}
    dv = float((outs["auto"]["v"] - outs["ref"]["v"]).abs().max())
    expected = _expected_ml_launches(outs["auto"], mcfg)
    emit("ml_solve_parity", n=N_SOLVE_PARITY, grids=outs["auto"]["grids"], levels=levels,
         max_abs_dv=dv, launches=launches, expected_launches_auto=expected)
    for key in ("newton_iters", "hessian_matvecs", "cg_iters"):
        got = {m: [lv[key] for lv in ls] for m, ls in levels.items()}
        require(got["auto"] == got["ref"], f"{key} differ per level: {got}")
    require(dv < V_TOL, f"max |v_kernel - v_ref| = {dv} >= {V_TOL}")
    require(all(n == 0 for n in launches["ref"].values()),
            f"the plain run launched kernels: {launches['ref']}")
    _require_launched(launches["auto"], expected, "ml_solve_parity")
    _check_solution(outs["auto"])


def phase_multilevel(dev) -> dict:
    """The example's coarse-to-fine ``register()`` at 256^3 (64^3 -> 128^3 ->
    256^3, V-cycle at both warm levels), through the kernels: its V-cycle's
    inner solves and Armijo trials included, K1 and K2 stage their tiles."""
    from repro_torch.kernels import tricubic

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with tricubic.count_staged() as counts:
        out, mcfg, images = _register_ml(N_MAIN, "auto", dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = _launches()
    staged = _path_staged(counts)
    expected = _expected_ml_launches(out, mcfg)
    emit("multilevel_path", n=N_MAIN, grids=out["grids"], seconds=secs,
         solver=dataclasses.asdict(mcfg.solver), precond=mcfg.precond, max_newton_cut=False,
         levels=_level_summary(out), newton_iters=out["newton_iters"],
         hessian_matvecs=out["hessian_matvecs"], fine_matvecs=out["fine_matvecs"],
         fine_equiv_matvecs=out["fine_equiv_matvecs"],
         precond_fine_equiv_matvecs=out["precond_fine_equiv_matvecs"],
         total_fine_equiv_matvecs=out["total_fine_equiv_matvecs"],
         det_min=out["det_min"], det_max=out["det_max"], residual_rel=out["residual_rel"],
         residual_rel_smoothed=out["residual_rel_smoothed"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, expected_launches=expected, staged_tiles=staged)
    _require_launched(launches, expected, "multilevel_path")
    _require_staged(staged, "multilevel_path")
    _check_solution(out)
    return {"out": out, "cfg": mcfg, "images": images}


def phase_warp(out, images, dev) -> dict:
    """Resample the raw template through the returned deformation: a 3-D
    field through ``Interp()``, so the single-field displace kernel (K3),
    bit for bit with its plain version and with as many staged tiles as
    the model counts (also reported under K1/K2's box, for information)."""
    from repro_torch.kernels import ops, ref, tricubic

    grid = out["grid"]
    h = torch.tensor(grid.spacing, dtype=torch.float32, device=dev).reshape(3, 1, 1, 1)
    disp = (out["displacement"] / h).contiguous()
    rho_T = images[1].contiguous()
    _reset_launches()
    with tricubic.count_staged() as counts:
        warped = ops.make_interp()(rho_T, disp)
        torch.cuda.synchronize()
    launches = _launches()
    staged = _path_staged(counts)
    want = ref.tricubic_displace(rho_T, disp)
    err = _compare(warped, want)
    base = tricubic.warp_base(disp)
    extent = tricubic.tile_extents(base)
    kernel = staged["tricubic_displace"]["all"]
    model = tricubic.staged_tiles(base, tricubic.WARP_BOX_ROWS)
    expected = {"tricubic_apply": 0, "tricubic_displace_many": 0, "tricubic_displace": 1,
                "biharmonic_scale": 0}
    emit("warp", n=N_MAIN, max_disp=float(disp.abs().max()), launches=launches,
         max_abs_err_vs_plain=err, staged_tiles=staged, staged_model=model,
         box_rows=tricubic.WARP_BOX_ROWS,
         staged_share_at_k1_k2_box=tricubic.staged_tiles(base, tricubic.BOX_ROWS)
         / kernel["tiles"],
         box_rows_max=int((extent[0] * extent[1]).max()), box_width_max=int(extent[2].max()),
         max_abs_warp_minus_rho_deformed=float((warped - out["rho_deformed"]).abs().max()),
         note="rho_deformed transports the presmoothed template; the warp resamples the raw "
              "one, so their difference is for information only")
    _require_launched(launches, expected, "warp")
    require(kernel["staged"] == model, f"warp: K3 staged {kernel['staged']} tiles, the model "
                                       f"{model}")
    return {"field": rho_T, "disp": disp, "launches": launches, "staged": staged}


def phase_spectral(images, dev) -> dict:
    """The fused biharmonic scaling of the 256^3 reference image's spectrum,
    through ``spectral_diag.biharmonic_scale`` (K4), held against its plain
    version on the same spectrum.  Both inverse FFTs of the result and
    ``SpectralOps.reg_apply`` are also compared with a float64 computation
    of ``beta Lap^2 rho_R``, for information: on a smooth image the f32
    roundoff of the large low modes, scaled by |k|^4 up to 2.4e9, dominates
    the small high modes of the result."""
    from repro_torch.core.grid import make_grid
    from repro_torch.core.spectral import SpectralOps
    from repro_torch.kernels import spectral_diag

    rho_R = images[0]
    betas = SPECTRAL_BETAS[-1]
    spec = torch.fft.fftn(rho_R)
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    del spec
    _reset_launches()
    out_re, out_im = spectral_diag.biharmonic_scale(re, im, betas)
    torch.cuda.synchronize()
    launches = _launches()
    want_re, want_im = spectral_diag.biharmonic_scale(re, im, betas, method="ref")
    err = max(float((out_re - want_re).abs().max()), float((out_im - want_im).abs().max()))
    ok = all(bool(torch.all((g - w).abs() <= SPECTRAL_RTOL * w.abs()))
             for g, w in ((out_re, want_re), (out_im, want_im)))
    del want_re, want_im
    ops = SpectralOps(make_grid(tuple(rho_R.shape)), device=dev)
    ksq64 = spectral_diag._ksq(rho_R.shape, dev).double()
    spec64 = torch.fft.fftn(rho_R.double())
    vs_f64 = []
    for c, beta in enumerate(betas):
        exact = torch.fft.ifftn(beta * ksq64 * ksq64 * spec64).real
        scale = float(exact.abs().max())
        kernel_route = torch.fft.ifftn(torch.complex(out_re[c], out_im[c])).real.double()
        rfft_route = ops.reg_apply(rho_R, beta).double()
        vs_f64.append({"beta": beta, "max_abs": scale,
                       "kernel_route_rel": float((kernel_route - exact).abs().max()) / scale,
                       "reg_apply_rel": float((rfft_route - exact).abs().max()) / scale})
        del exact, kernel_route, rfft_route
    expected = {"tricubic_apply": 0, "tricubic_displace_many": 0, "tricubic_displace": 0,
                "biharmonic_scale": 1}
    emit("spectral", n=N_MAIN, betas=list(betas), launches=launches,
         max_abs_err_vs_plain=err, vs_float64=vs_f64)
    _require_launched(launches, expected, "spectral")
    require(ok, f"biharmonic_scale disagrees with plain version: max abs err {err}")
    return {"re": re, "im": im, "betas": betas, "launches": launches}


def _kernel_class(name: str) -> str:
    for i, (kname, meta) in enumerate(KERNELS.items()):
        if any(_is_symbol(sym, name) for sym in meta["symbols"]):
            return f"K{i + 1} {kname}"
    if re.search(r"fft|radix", name, re.I):
        return "cuFFT"
    if re.search(r"memcpy|memset", name, re.I):
        return "copies"
    return "other (elementwise, reductions, cat)"


def _profile_newton(phase: str, n: int, newton, **extra) -> None:
    """Device time of one Newton iteration (``newton()`` returns its log) by
    kernel class, from torch.profiler's CUDA activity, beside its host wall;
    ``extra`` values that are callables are read after the iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        log = newton()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, by_name = {}, {}
    for e in prof.events():
        # record_function ranges (telemetry.annotate) also appear on the
        # device timeline; they are not kernels and would count twice
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.elapsed_us()
        by_class[_kernel_class(e.name)] = by_class.get(_kernel_class(e.name), 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    cg = log.cg_iters.tolist() if torch.is_tensor(log.cg_iters) else log.cg_iters
    extra = {k: v() if callable(v) else v for k, v in extra.items()}
    emit(phase, n=n, **extra, cg_iters=cg, armijo_trials=log.ls_iters,
         wall_ms_profiled=wall * 1e3,
         device_ms=by_class if busy else "not measured: the profiler recorded no CUDA activity",
         device_busy_ms=busy, idle_share=(1 - busy / (wall * 1e3)) if busy else None,
         top_kernels_ms=[{"name": n[:120], "ms": ms} for n, ms in top])


def phase_profile(out, images, dev) -> None:
    """One more single-level Newton iteration at 256^3 from the solved
    velocity, with the spectral preconditioner; then the same iteration on
    the full Newton Hessian (``full_newton_profile``)."""
    from repro_torch.core import gauss_newton as gn
    from repro_torch.core import objective as obj
    from repro_torch.core.spectral import SpectralOps

    grid = out["grid"]
    ops = SpectralOps(grid, device=dev)
    g0 = torch.tensor(out["history"][0]["gnorm"], dtype=torch.float32, device=dev)
    for phase, cfg in (("profile", gn.GNConfig()),
                       ("full_newton_profile", gn.GNConfig(gauss_newton=False))):
        prob = obj.Problem(grid, ops.smooth(images[0]), ops.smooth(images[1]), cfg.beta,
                           cfg.n_t, cfg.incompressible)
        torch.cuda.reset_peak_memory_stats()
        _profile_newton(phase, N_MAIN,
                        lambda: gn.newton_iteration(out["v"], g0, prob, ops, cfg)[1],
                        max_memory_allocated=lambda: torch.cuda.max_memory_allocated())


def phase_ml_profile(ml, dev) -> None:
    """One more Newton iteration of the coarse-to-fine solve's 256^3 level
    from its solved velocity, preconditioned by the V-cycle over the whole
    ladder (64^3 and 128^3 inner solves), as ``multilevel.solve`` builds it."""
    from repro_torch.core import gauss_newton as gn
    from repro_torch.core import objective as obj
    from repro_torch.core.grid import make_grid
    from repro_torch.core.spectral import SpectralOps
    from repro_torch.kernels import ops as kops
    from repro_torch.multilevel.precond import make_vcycle_precond

    out, mcfg, images = ml["out"], ml["cfg"], ml["images"]
    level_ops = [SpectralOps(make_grid(tuple(shape)), device=dev) for shape in out["grids"]]
    fine = level_ops[-1]
    cfg = mcfg.solver
    interp = kops.make_interp(cfg.interp_method)
    prob = obj.Problem(fine.grid, fine.smooth(images[0]), fine.smooth(images[1]), cfg.beta,
                       cfg.n_t, cfg.incompressible)
    precond = make_vcycle_precond(
        prob, level_ops, level_interp=[interp] * len(level_ops), n_cg=mcfg.precond_cg_iters,
        n_cg_coarse=mcfg.precond_coarse_cg_iters, min_size=mcfg.precond_min_size,
    )
    last = len(out["levels"]) - 1
    fine_hist = [h for h in out["history"] if h["level"] == last and h["beta"] == cfg.beta]
    g0 = torch.tensor(fine_hist[0]["gnorm"], dtype=torch.float32, device=dev)
    _profile_newton(
        "ml_profile", N_MAIN,
        lambda: gn.newton_iteration(out["v"], g0, prob, fine, cfg, interp=interp,
                                    precond=precond)[1],
        grids=out["grids"], precond="vcycle",
    )


# --------------------------------------------------------------------------- #
def _cohort_case(name, f, disp, plan=None) -> dict:
    """One launch of K1 (``plan``) or K2 (``disp``) over a cohort, fields
    ``f`` (C, S, N..), with the staged-tile counter: bit for bit against
    the plain cohort version and against one single-subject launch per
    subject on its contiguous slab (not counted), and the staged tiles
    against the model summed over the subjects."""
    from fmad_ab import plain
    from repro_torch.kernels import ref, tricubic

    subjects, shape3 = f.shape[1], tuple(f.shape[2:])
    with tricubic.count_staged() as counts:
        if name == "tricubic_apply":
            got = tricubic.tricubic_apply_cuda(f, plan)
        else:
            got = tricubic.tricubic_displace_many_cuda(f, disp)
    err = _compare(got, plain(name, f, disp, plan))
    err_single = 0.0
    for s in range(subjects):
        slab = f[:, s].contiguous()
        if name == "tricubic_apply":
            one = tricubic.tricubic_apply_cuda(
                slab, ref.InterpPlan(plan.ib[s], plan.w[s], plan.halo_need))
        else:
            one = tricubic.tricubic_displace_many_cuda(slab, disp[s].contiguous())
        err_single = max(err_single, _compare(got[:, s], one))
        del one
    del got
    kernel = counts[(name, shape3)]
    model = tricubic.staged_tiles(tricubic.stencil_base(name, disp, plan))
    require(kernel["staged"] == model,
            f"{name} over {subjects} subjects staged {kernel['staged']} tiles, the model {model}")
    require(kernel["tiles"] == subjects * tricubic.n_tiles(shape3),
            f"{name}: {kernel['tiles']} tiles booked for {subjects} subjects")
    return {"kernel": name, "shape": list(shape3), "C": int(f.shape[0]), "S": subjects,
            "max_disp": float(disp.abs().max()), "max_abs_err": err,
            "max_abs_err_vs_single_launches": err_single, "staged_tiles": kernel["staged"],
            "tiles": kernel["tiles"], "staged_share": kernel["staged"] / kernel["tiles"]}


def phase_cohort_kernel_parity(dev, errs) -> None:
    """K1 (C=1..3) and K2 (C=3) with the subject axis over COHORT_S
    subjects, at 256^3 and on the non-cubic grid, on random displacements
    (no tile stages) and smooth ones (one per subject): each against the
    plain cohort version and against per-subject launches, bit for bit, and
    its staged tiles against the model per subject."""
    from fmad_ab import smooth_disp
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = []
    for shape, smooth in (((N_MAIN,) * 3, SMOOTH_DISP), (NONCUBIC, NONCUBIC_SMOOTH_DISP)):
        for field in ("random", "smooth"):
            if field == "smooth":
                d = torch.stack([smooth_disp(shape, smooth, gen, dev) for _ in range(COHORT_S)])
            else:
                d = torch.rand((COHORT_S, 3) + shape, generator=gen, device=dev)
                d = (d * 2 - 1) * MAX_DISP
            plan = ref.make_interp_plan(d)
            f = torch.randn((3, COHORT_S) + shape, generator=gen, device=dev)
            for name, c in (("tricubic_apply", 1), ("tricubic_apply", 2), ("tricubic_apply", 3),
                            ("tricubic_displace_many", 3)):
                case = _cohort_case(name, f[:c].contiguous(), d, plan)
                errs[name] = max(errs[name], case["max_abs_err"])
                cases.append({"field": field, **case})
            del d, plan, f
    emit("cohort_kernel_parity", tricubic="bit for bit, and per-subject launches bit for bit",
         cases=cases)


def _cohort_images(n, dev, seeds):
    """``brain_like(n, seed=s)`` for each of ``seeds``, presmoothed as
    ``register()`` presmooths its inputs: (S, N..) stacks and the grid."""
    from repro_torch.core.spectral import SpectralOps
    from repro_torch.data import synthetic

    pairs = [synthetic.brain_like(n, seed=s, device=dev) for s in seeds]
    grid = pairs[0][2]
    ops = SpectralOps(grid, device=dev)
    rho_R = torch.stack([ops.smooth(p[0]) for p in pairs])
    rho_T = torch.stack([ops.smooth(p[1]) for p in pairs])
    return rho_R, rho_T, grid


def _cohort_cfg(method="auto", max_newton=MAX_NEWTON):
    from repro_torch.core import gauss_newton as gn

    return gn.GNConfig(max_newton=max_newton, interp_method=method)


def _independent(rho_R, rho_T, grid, cfg, dev) -> list[dict]:
    """Each subject's single-level ``gn.solve`` of the same images and
    config, with its seconds."""
    from repro_torch.core import gauss_newton as gn

    outs = []
    for s in range(rho_R.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gn.solve(rho_R[s], rho_T[s], grid, cfg, device=dev)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        outs.append(out)
    return outs


def _cohort_counts(cohort, singles) -> dict:
    """Per-subject Newton and matvec counts, and per-iteration cg_iters, of
    a cohort and of the independent solves."""
    return {
        "cohort": {"newton_iters": cohort["newton_iters"],
                   "hessian_matvecs": cohort["hessian_matvecs"],
                   "cg_iters": [[h["cg_iters"][s] for h in cohort["history"] if h["active"][s]]
                                for s in range(len(singles))]},
        "independent": {"newton_iters": [o["newton_iters"] for o in singles],
                        "hessian_matvecs": [o["hessian_matvecs"] for o in singles],
                        "cg_iters": [[h["cg_iters"] for h in o["history"]] for o in singles]},
    }


def _v_rel(cohort, singles) -> list[float]:
    return [float((cohort["v"][s] - o["v"]).abs().max()) / max(float(o["v"].abs().max()), 1e-30)
            for s, o in enumerate(singles)]


def phase_cohort_solve_parity(dev) -> None:
    """``gn.solve_cohort`` of COHORT_S subjects at 64^3 through the kernels
    and through the plain versions: the same per-subject counts and
    per-iteration cg_iters, max|dv| == 0, and no launch on the plain run;
    and through the kernels against the independent single-level solves:
    the same counts and max|dv|/max|v| < COHORT_V_RTOL."""
    from repro_torch.core import gauss_newton as gn

    rho_R, rho_T, grid = _cohort_images(N_SOLVE_PARITY, dev, range(COHORT_S))
    outs, launches = {}, {}
    for method in ("auto", "ref"):
        _reset_launches()
        outs[method] = gn.solve_cohort(rho_R, rho_T, grid, _cohort_cfg(method), device=dev)
        torch.cuda.synchronize()
        launches[method] = _launches()
    singles = _independent(rho_R, rho_T, grid, _cohort_cfg(), dev)
    counts = {m: _cohort_counts(o, singles)["cohort"] for m, o in outs.items()}
    vs_singles = _cohort_counts(outs["auto"], singles)
    dv = float((outs["auto"]["v"] - outs["ref"]["v"]).abs().max())
    rel = _v_rel(outs["auto"], singles)
    expected = _expected_cohort_launches(outs["auto"]["history"])
    emit("cohort_solve_parity", n=N_SOLVE_PARITY, subjects=COHORT_S, counts=counts,
         independent=vs_singles["independent"], max_abs_dv_kernel_vs_plain=dv,
         max_rel_dv_vs_independent=rel, launches=launches, expected_launches_auto=expected)
    require(counts["auto"] == counts["ref"], f"cohort counts differ, kernels vs plain: {counts}")
    require(dv == 0.0, f"cohort max |v_kernel - v_ref| = {dv} != 0")
    require(all(n == 0 for n in launches["ref"].values()),
            f"the plain cohort run launched kernels: {launches['ref']}")
    _require_launched(launches["auto"], expected, "cohort_solve_parity")
    require(vs_singles["cohort"] == vs_singles["independent"],
            f"cohort counts differ from the independent solves: {vs_singles}")
    require(max(rel) < COHORT_V_RTOL, f"cohort against independent: max|dv|/max|v| = {rel}")


def _expected_cohort_launches(history) -> dict:
    """Launches of ``gn.solve_cohort``, counted from its history: each
    cohort Newton iteration launches as ``_solve_launches``'s single one,
    one launch per call over all subjects, with ``c`` the largest live
    subject's cg_iters (``pcg_masked`` loops while any subject is live) and
    ``a`` the Armijo halvings the subjects shared.  No diagnostics."""
    k2, k1 = _solve_launches([{"cg_iters": max(h["cg_iters"]),
                               "armijo_trials": h["armijo_trials"]} for h in history])
    return {"tricubic_apply": k1, "tricubic_displace_many": k2, "tricubic_displace": 0,
            "biharmonic_scale": 0}


def phase_cohort(dev) -> dict:
    """``gn.solve_cohort`` of brain_like(256, seed=s), s = 0..COHORT_S-1,
    default config cut to MAX_NEWTON Newton iterations, through the
    kernels: walls from the ``gn.cohort_iter`` spans, per-subject results,
    peak memory, launches against the count from the code, and K1/K2's
    staged share.  Then the same pairs' independent single-level solves in
    the same call: counts (their equality with the cohort's is recorded,
    not gated: batched and single cuFFT transforms may round differently)
    and seconds per subject."""
    from repro_torch import telemetry
    from repro_torch.core import gauss_newton as gn
    from repro_torch.kernels import tricubic

    rho_R, rho_T, grid = _cohort_images(N_MAIN, dev, range(COHORT_S))
    cfg = _cohort_cfg()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with telemetry.ListSink() as sink, tricubic.count_staged() as counts:
        out = gn.solve_cohort(rho_R, rho_T, grid, cfg, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _launches()
    staged = _path_staged(counts)
    walls = [r["wall_s"] for r in sink.records
             if r["kind"] == "span" and r["name"] == "gn.cohort_iter"]
    iters = [{k: h[k] for k in ("iter", "J", "gnorm", "rel_gnorm", "cg_iters", "active",
                                "armijo_trials", "status")} | {"wall_s": w}
             for h, w in zip(out["history"], walls)]
    expected = _expected_cohort_launches(out["history"])
    singles = _independent(rho_R, rho_T, grid, cfg, dev)
    counts_ = _cohort_counts(out, singles)
    emit("cohort_path", n=N_MAIN, subjects=COHORT_S, seconds=secs, iterations=iters,
         newton_iters=out["newton_iters"], hessian_matvecs=out["hessian_matvecs"],
         status=out["status"], compiled_executables=out["compiled_executables"],
         max_memory_allocated=peak, launches=launches, expected_launches=expected,
         staged_tiles=staged,
         independent={"seconds": [o["seconds"] for o in singles],
                      "seconds_total": sum(o["seconds"] for o in singles),
                      **counts_["independent"],
                      "J": [[h["J"] for h in o["history"]] for o in singles],
                      "gnorm": [[h["gnorm"] for h in o["history"]] for o in singles]},
         counts_equal_independent=counts_["cohort"] == counts_["independent"],
         max_rel_dv_vs_independent=_v_rel(out, singles))
    _require_launched(launches, expected, "cohort_path")
    _require_staged(staged, "cohort_path")
    scalars = [x for h in out["history"] for key in ("J", "gnorm") for x in h[key]]
    require(all(np.isfinite(scalars)), f"cohort_path: non-finite J or gnorm: {scalars}")
    require(bool(torch.isfinite(out["v"]).all()), "cohort_path: non-finite velocity")
    require(out["compiled_executables"] == 1,
            f"cohort_path: {out['compiled_executables']} step signatures")
    del singles
    return {"out": out, "images": (rho_R, rho_T), "grid": grid, "cfg": cfg,
            "launches": launches, "staged": staged}


def _serve_jobs(dev) -> list:
    """SERVE_JOBS jobs of brain phantom pairs at 256^3, presmoothed."""
    from repro_torch.launch import reg_serve

    rho_R, rho_T, _ = _cohort_images(N_MAIN, dev, range(SERVE_JOBS))
    return [reg_serve.RegJob(job_id=s, rho_R=rho_R[s], rho_T=rho_T[s])
            for s in range(SERVE_JOBS)]


def _serve_cfg():
    return _cohort_cfg(max_newton=SERVE_MAX_NEWTON)


class _RecordingStep:
    """A ``gn.make_cohort_step`` step that keeps each call's active mask,
    per-subject cg_iters and shared Armijo halvings, so that the server's
    billing and its launches can be recomputed from what the step returned."""

    def __init__(self, step):
        self.step, self.ops, self.calls = step, step.ops, []

    def __call__(self, v, g0_forcing, active, *rest):
        v_new, log = self.step(v, g0_forcing, active, *rest)
        self.calls.append((active.cpu().numpy(), log.cg_iters.cpu().numpy(), log.ls_iters))
        return v_new, log

    def _cache_size(self) -> int:
        return self.step._cache_size()


@contextlib.contextmanager
def _recording_steps():
    """Every cohort step the server builds in the block is a
    ``_RecordingStep``; yields the list of them."""
    from unittest import mock

    from repro_torch.core import gauss_newton as gn

    steps, make_step = [], gn.make_cohort_step

    def recording(*args, **kwargs):
        steps.append(_RecordingStep(make_step(*args, **kwargs)))
        return steps[-1]

    with mock.patch.object(gn, "make_cohort_step", recording):
        yield steps


def _expected_served_launches(steps) -> dict:
    """Launches of a server's run, counted from its steps' calls: each call
    is one cohort Newton iteration (``_expected_cohort_launches``).  The
    server interpolates nowhere else."""
    return _expected_cohort_launches([{"cg_iters": [int(c) for c in cg], "armijo_trials": ls}
                                      for step in steps for _, cg, ls in step.calls])


def phase_serve(dev) -> dict:
    """``serve_jobs`` of SERVE_JOBS brain phantom pairs at 256^3 through
    COHORT_S slots, default config cut to SERVE_MAX_NEWTON: each job's
    billing and status, the server's iterations and refills, and its step
    signatures.  Gates: one step signature, at least 2 refills, every job
    retired with a status, every job billed the sum of its slot's cg_iters
    over the steps it held the slot, and K1/K2 launched as counted from
    the steps' calls."""
    from repro_torch import telemetry
    from repro_torch.kernels import build, tricubic
    from repro_torch.launch import reg_serve

    jobs = _serve_jobs(dev)
    lib = build.library()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with _recording_steps() as steps, telemetry.ListSink() as sink, \
            tricubic.count_staged() as counts:
        out = reg_serve.serve_jobs(jobs, _serve_cfg(), slots=COHORT_S, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = _launches()
    staged = _path_staged(counts)
    expected = _expected_served_launches(steps)
    (bucket,) = out["buckets"].values()
    events = {r["job_id"]: r for r in sink.records if r["kind"] == "job"}
    calls = steps[0].calls if len(steps) == 1 else []
    per_job = []
    for res in out["results"]:
        ev = events[str(res.job_id)]
        residency = calls[ev["admitted_step"]:ev["retired_step"]]
        per_job.append({"job": res.job_id, "slot": ev["slot"], "status": res.status,
                        "newton_iters": res.newton_iters, "hessian_matvecs": res.hessian_matvecs,
                        "steps": [ev["admitted_step"], ev["retired_step"]],
                        "slot_cg_iters": [int(cg[ev["slot"]]) for _, cg, _ in residency],
                        "rel_gnorm": res.rel_gnorm})
    emit("serve_path", n=N_MAIN, jobs=SERVE_JOBS, slots=COHORT_S, max_newton=SERVE_MAX_NEWTON,
         seconds=secs, cohort_iterations=bucket["cohort_iterations"], refills=bucket["refills"],
         compiled_executables=out["compiled_executables"], per_job=per_job,
         occupancy=[int(a.sum()) for a, _, _ in calls],
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         expected_launches=expected, staged_tiles=staged)
    require(len(steps) == 1, f"serve_path built {len(steps)} cohort steps")
    require(out["compiled_executables"] == 1,
            f"serve_path: {out['compiled_executables']} step signatures")
    require(build.library() is lib, "serve_path loaded another kernel library")
    require(bucket["refills"] >= 2, f"serve_path: {bucket['refills']} refills")
    require(sorted(j["job"] for j in per_job) == list(range(SERVE_JOBS)),
            f"serve_path: jobs retired {[j['job'] for j in per_job]}")
    require(all(j["status"] in ("converged", "stagnated", "max_newton") for j in per_job),
            f"serve_path: statuses {[j['status'] for j in per_job]}")
    for j in per_job:
        require(j["hessian_matvecs"] == sum(j["slot_cg_iters"]),
                f"serve_path: job {j['job']} billed {j['hessian_matvecs']}, its slot's "
                f"cg_iters {j['slot_cg_iters']}")
        require(j["newton_iters"] == len(j["slot_cg_iters"]),
                f"serve_path: job {j['job']} held its slot for {j['slot_cg_iters']}")
    _require_launched(launches, expected, "serve_path")
    require(all(np.isfinite(float(r.rel_gnorm)) for r in out["results"]),
            "serve_path: non-finite rel_gnorm")
    _require_staged(staged, "serve_path")
    return {"launches": launches, "staged": staged, "out": out}


def _job_summary(res) -> dict:
    return {"job": res.job_id, "status": res.status, "attempts": res.attempts,
            "newton_iters": res.newton_iters, "hessian_matvecs": res.hessian_matvecs,
            "rel_gnorm": res.rel_gnorm}


def _same_result(a, b) -> bool:
    """Two JobResults of one job: velocity bit for bit, and the billing."""
    return (torch.equal(a.v, b.v) and a.newton_iters == b.newton_iters
            and a.hessian_matvecs == b.hessian_matvecs and a.status == b.status)


def _poisoned_launches(jobs, dev) -> list[dict]:
    """K1 (C=2) and K2 (C=3) over COHORT_S of the serve jobs' subjects at
    256^3, subject 1 with NaN, +inf or -inf in every other x1-plane of its
    displacement (its slot velocity's RK2 midpoint displacement) or of its
    fields (``fmad_ab.poisoned_cohort_case``): no CUDA error, nothing
    written outside the output, the healthy subjects bit for bit the
    launch without the poison and the launch without the subject, and the
    output the plain cohort version's."""
    from fmad_ab import poisoned_cohort_case, smooth_disp
    from repro_torch.kernels import build

    lib = build.library()
    rho_T = torch.stack([j.rho_T for j in jobs[:COHORT_S]])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    disp = torch.stack([smooth_disp((N_MAIN,) * 3, SMOOTH_DISP, gen, dev)
                        for _ in range(COHORT_S)])
    fields = {"tricubic_apply": torch.stack([rho_T, rho_T * rho_T]).contiguous(),
              "tricubic_displace_many": disp.transpose(0, 1).contiguous()}
    cases = []
    for name, f in fields.items():
        for where in ("disp", "fields"):
            for value in (float("nan"), float("inf"), float("-inf")):
                case = poisoned_cohort_case(lib, name, f, disp, 1, value, where)
                cases.append({"kernel": name, "poisoned": where, "value": str(value), **case})
        del f
    return cases


def phase_resilience(serve, dev) -> dict:
    """``serve_jobs`` of ``serve_path``'s jobs and config with
    ``NaNInjector(job_id=1, field="v", at_iteration=1)`` and
    ``RetryPolicy(max_attempts=2)`` retrying the failure statuses (the
    default also retries ``max_newton``, the status of every job under the
    SERVE_MAX_NEWTON cut).  Gates: the fault fired; job 1 retired
    ``nonfinite`` at attempt 1 and finished at attempt 2 with a finite v;
    every other job's v, counts and status bit for bit ``serve_path``'s;
    one step built, one step signature and one retry bucket; K1 and K2
    launched as counted from the steps' calls and no CUDA error after a
    synchronisation; the trace's fault, recovery and
    per-attempt job records valid under the schema.  First, K1 and K2 over
    a cohort with a poisoned subject (``_poisoned_launches``)."""
    from repro_torch import telemetry
    from repro_torch.kernels import tricubic
    from repro_torch.launch import reg_serve
    from repro_torch.resilience import NaNInjector, RetryPolicy, health

    jobs = _serve_jobs(dev)
    poisoned = _poisoned_launches(jobs, dev)
    emit("poisoned_launches", n=N_MAIN, subjects=COHORT_S, cases=poisoned)
    bad = [c for c in poisoned if not all(c[k] for k in ("launch_ok", "guard_intact",
                                                         "healthy_equal",
                                                         "healthy_equal_without",
                                                         "plain_equal"))]
    require(not bad, f"poisoned cohort launches: {bad}")
    fault = NaNInjector(job_id=1, field="v", at_iteration=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with _recording_steps() as steps, telemetry.ListSink() as sink, \
            tricubic.count_staged() as counts:
        out = reg_serve.serve_jobs(jobs, _serve_cfg(), slots=COHORT_S, device=dev,
                                   retry=RetryPolicy(max_attempts=2,
                                                     retry_on=health.FAILED_NAMES),
                                   faults=[fault])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = _launches()
    staged = _path_staged(counts)
    expected = _expected_served_launches(steps)
    res = {r.job_id: r for r in out["results"]}
    base = {r.job_id: r for r in serve["out"]["results"]}
    records = [r for r in sink.records if r["kind"] in ("fault", "recovery", "job")]
    invalid = [(r["kind"], telemetry.validate_record(r)) for r in sink.records
               if telemetry.validate_record(r)]
    job1 = [r for r in records if r["kind"] == "job" and r["job_id"] == "1"]
    retry_buckets = [k for k, st in out["buckets"].items() if st["attempt"] > 1]
    emit("resilience_path", n=N_MAIN, jobs=SERVE_JOBS, slots=COHORT_S,
         max_newton=SERVE_MAX_NEWTON, seconds=secs, fired=fault.fired,
         per_job=[_job_summary(r) for r in out["results"]],
         bit_identical_to_serve_path={str(j): _same_result(res[j], base[j])
                                      for j in base if j != 1},
         buckets={str(k): st for k, st in out["buckets"].items()},
         compiled_executables=out["compiled_executables"],
         trace=[{k: r.get(k) for k in ("kind", "fault", "action", "job_id", "attempts",
                                       "status", "target")} for r in records],
         invalid_records=invalid, max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, expected_launches=expected, staged_tiles=staged)
    require(fault.fired, "resilience_path: the NaN injection did not fire")
    require([(e["attempts"], e["status"]) for e in job1][:1] == [(1, "nonfinite")],
            f"resilience_path: job 1's records {job1}")
    require(res[1].attempts == 2 and res[1].status not in ("nonfinite", "diverged",
                                                           "pcg_breakdown"),
            f"resilience_path: job 1 ended {_job_summary(res[1])}")
    require(bool(torch.isfinite(res[1].v).all()), "resilience_path: job 1's v is not finite")
    require(sorted(res) == list(range(SERVE_JOBS)), f"resilience_path: jobs {sorted(res)}")
    for j in base:
        if j != 1:
            require(_same_result(res[j], base[j]),
                    f"resilience_path: job {j} differs from serve_path's: "
                    f"{_job_summary(res[j])} against {_job_summary(base[j])}")
    require(len(steps) == 1, f"resilience_path built {len(steps)} cohort steps")
    require(out["compiled_executables"] == 1,
            f"resilience_path: {out['compiled_executables']} step signatures")
    require(len(retry_buckets) == 1, f"resilience_path: retry buckets {retry_buckets}")
    _require_launched(launches, expected, "resilience_path")
    kinds = {r["kind"] for r in records}
    require({"fault", "recovery", "job"} <= kinds, f"resilience_path: trace kinds {kinds}")
    require(not invalid, f"resilience_path: invalid records {invalid}")
    return {"launches": launches, "staged": staged}


def phase_resume(serve, dev) -> dict:
    """``serve_path``'s jobs with ``checkpoint=<temporary directory>``
    (``checkpoint_every=2``) and ``KillAt(at_iteration=3)``; the
    ``SimulatedCrash`` starts ``serve_jobs([], ..., resume=True)`` from the
    latest snapshot.  Gates: every job bit for bit ``serve_path``'s result;
    completed + unfinished == SERVE_JOBS with unfinished < SERVE_JOBS; only
    the unfinished jobs emit job records on resume; the cohort iterations
    those of the uninterrupted run; K1/K2 launched as counted from the
    steps' calls, over the killed and the resumed run.  Reports the bytes
    and seconds of each save and of the restore."""
    import tempfile

    from repro_torch import telemetry
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import reg_serve
    from repro_torch.resilience import KillAt, SimulatedCrash

    io: list[dict] = []

    class TimedManager(CheckpointManager):
        """Times each save and restore and reports the bytes of its step."""

        def save(self, step, tree, metadata=None, blocking=True):
            t0 = time.perf_counter()
            super().save(step, tree, metadata, blocking)
            secs = time.perf_counter() - t0
            path = os.path.join(self.dir, f"step_{step}")
            nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
            io.append({"op": "save", "step": step, "bytes": nbytes, "seconds": secs})

        def restore(self, *args, **kwargs):
            t0 = time.perf_counter()
            got = super().restore(*args, **kwargs)
            torch.cuda.synchronize()
            io.append({"op": "restore", "step": got[1]["step"],
                       "seconds": time.perf_counter() - t0})
            return got

    jobs = _serve_jobs(dev)
    base = {r.job_id: r for r in serve["out"]["results"]}
    kill = KillAt(at_iteration=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, _recording_steps() as steps:
        mgr = TimedManager(tmp, keep=1)
        try:
            reg_serve.serve_jobs(jobs, _serve_cfg(), slots=COHORT_S, device=dev, checkpoint=mgr,
                                 checkpoint_every=2, faults=[kill])
            crashed = False
        except SimulatedCrash:
            crashed = True
        del jobs
        with telemetry.ListSink() as sink:
            out = reg_serve.serve_jobs([], _serve_cfg(), slots=COHORT_S, device=dev,
                                       checkpoint=mgr, checkpoint_every=2, resume=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        mgr.close()
    launches = _launches()
    expected = _expected_served_launches(steps)
    res = {r.job_id: r for r in out["results"]}
    recov = [r for r in sink.records if r["kind"] == "recovery"]
    served = sorted({r["job_id"] for r in sink.records if r["kind"] == "job"})
    attrs = recov[0]["attrs"] if recov else {}
    (bucket,) = out["buckets"].values()
    (base_bucket,) = serve["out"]["buckets"].values()
    emit("resume_path", n=N_MAIN, jobs=SERVE_JOBS, slots=COHORT_S, crashed=crashed,
         killed_at=kill.at_iteration, seconds=secs, checkpoint_io=io,
         recovery=[{k: r.get(k) for k in ("action", "step", "attrs")} for r in recov],
         served_on_resume=served, per_job=[_job_summary(r) for r in out["results"]],
         bit_identical_to_serve_path={str(j): _same_result(res[j], base[j]) for j in base
                                      if j in res},
         cohort_iterations=bucket["cohort_iterations"],
         uninterrupted_cohort_iterations=base_bucket["cohort_iterations"],
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
         expected_launches=expected)
    require(crashed and kill.fired, "resume_path: the kill did not fire")
    require(sorted(res) == sorted(base), f"resume_path: jobs {sorted(res)}")
    for j in base:
        require(_same_result(res[j], base[j]),
                f"resume_path: job {j} differs from serve_path's: {_job_summary(res[j])} "
                f"against {_job_summary(base[j])}")
    require(recov and recov[0]["action"] == "resume_from_checkpoint",
            f"resume_path: recovery records {recov}")
    require(attrs.get("completed", -1) + attrs.get("unfinished", -1) == SERVE_JOBS
            and attrs["unfinished"] < SERVE_JOBS, f"resume_path: resumed with {attrs}")
    require(len(served) == attrs["unfinished"],
            f"resume_path: served {served} on resume, {attrs['unfinished']} unfinished")
    require(bucket["cohort_iterations"] == base_bucket["cohort_iterations"],
            f"resume_path: {bucket['cohort_iterations']} cohort iterations against "
            f"{base_bucket['cohort_iterations']}")
    _require_launched(launches, expected, "resume_path")
    return {"launches": launches}


def phase_cohort_profile(cohort, dev) -> None:
    """One more cohort Newton iteration at 256^3 from the cohort's solved
    velocities, every subject active, by kernel class."""
    from repro_torch.core import gauss_newton as gn
    from repro_torch.core import objective as obj
    from repro_torch.core.spectral import SpectralOps

    out, (rho_R, rho_T), grid, cfg = cohort["out"], cohort["images"], cohort["grid"], cohort["cfg"]
    ops = SpectralOps(grid, device=dev)
    prob = obj.Problem(grid, rho_R, rho_T, cfg.beta, cfg.n_t, cfg.incompressible)
    g0 = torch.tensor(out["history"][0]["gnorm"], dtype=torch.float32, device=dev)
    active = torch.ones(COHORT_S, dtype=torch.bool, device=dev)
    _profile_newton("cohort_profile", N_MAIN,
                    lambda: gn.newton_iteration_cohort(out["v"], g0, active, prob, ops, cfg)[1],
                    subjects=COHORT_S)


# --------------------------------------------------------------------------- #
def _bound_ms(nbytes: float, flops: float, ops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bounds(nbytes: float, flops: float) -> dict:
    """The bound at the card's published f32 rate, and under the rounding
    contract (no FMA: F32_UNFUSED_OPS_PER_S)."""
    bound, by = _bound_ms(nbytes, flops)
    unfused, unfused_by = _bound_ms(nbytes, flops, F32_UNFUSED_OPS_PER_S)
    return {"bound_ms": bound, "bound_by": by, "bound_unfused_ms": unfused,
            "bound_unfused_by": unfused_by}


def _tile_bytes_flops(name: str, c: int, npts: int) -> tuple[int, int]:
    """Bytes and f32 operations of one K1, K2 or K3 launch (csrc/tricubic.cu).
    Per point and channel, contract_run() does 147 operations: 16 rows of 4
    products and 3 sums, 4 plane sums of 7, and the last sum of 7.  K1 reads
    its weights; K2 forms them per axis with floor, a subtraction and
    lagrange()'s 3 sums and 12 products (its two negations are sign
    modifiers of products), 17 in all; K3 adds the sum q = x + disp first."""
    if name == "tricubic_apply":
        return (2 * c + 15) * 4 * npts, 147 * c * npts
    per_axis = 17 if name == "tricubic_displace_many" else 18
    return (2 * c + 3) * 4 * npts, (147 * c + 3 * per_axis) * npts


def phase_kernel_times(solve, warp, spectral, dev) -> dict:
    """Times at 256^3 on the paths' own data (``_solve_fields``): the
    departure solve of the solved velocity (K2, C=3); the planned apply of
    its departure plan to a C=2 stack of deformed images (K1, the C of the
    adjoint and incremental transport steps); the warp's resampling of the
    template (K3); the scaling of the reference image's spectrum by two
    betas (K4).  Each row: CUDA events over 50 launches (the plain version:
    3; K1-K3 by direct calls of their C entry points, K4 through its
    wrapper), the bound from the bytes and operations of these inputs (at
    the published f32 rate and without FMA), K1-K3's staged share, and one
    PyTorch call computing the same function where there is one.  Then
    K1 (C=2) and K2 (C=3) on random fields and a smooth displacement of
    SMOOTH_DISP x n/256 voxels at each of TIME_SIZES, 50 x 256/n launches
    each."""
    from fmad_ab import raw_launcher, smooth_disp, time_ms
    from repro_torch.kernels import build, ref, spectral_diag, tricubic

    lib = build.library()
    plan, f2, vg, d_star = solve["plan"], solve["f2"], solve["vg"], solve["d_star"]
    disp = solve["disp"]
    field, wdisp = warp["field"], warp["disp"]
    re, im, betas = spectral["re"], spectral["im"], spectral["betas"]
    nb = len(betas)
    # the library yardstick of K4: one torch.mul of the stacked planes by a
    # precomputed symbol (computed here, outside the timed call)
    planes = torch.stack([re, im])[None]  # (1, 2, N..)
    ksq = spectral_diag._ksq(re.shape, dev)
    sym = torch.stack([(b * ksq) * ksq for b in betas])[:, None]  # (C, 1, N..)
    npts = vg[0].numel()
    rows = {}
    for name, kern, plain, library, c, nbytes, flops, max_disp in (
        ("tricubic_apply", raw_launcher(lib, "tricubic_apply", f2, plan=plan),
         lambda: ref.interp_apply(f2, plan), None, 2, *_tile_bytes_flops("tricubic_apply", 2, npts),
         disp),
        ("tricubic_displace_many", raw_launcher(lib, "tricubic_displace_many", vg, d_star),
         lambda: ref.tricubic_displace_many(vg, d_star), None, 3,
         *_tile_bytes_flops("tricubic_displace_many", 3, npts), d_star),
        ("tricubic_displace", raw_launcher(lib, "tricubic_displace", field[None], wdisp),
         lambda: ref.tricubic_displace(field, wdisp), None, 1,
         *_tile_bytes_flops("tricubic_displace", 1, npts), wdisp),
        ("biharmonic_scale", lambda: spectral_diag.biharmonic_scale_cuda(re, im, betas),
         lambda: spectral_diag.biharmonic_scale_ref(re, im, betas),
         lambda: torch.mul(planes, sym), nb, (2 + 2 * nb) * 4 * npts, (5 + 4 * nb) * npts,
         None),
    ):
        ms = time_ms(kern, reps=50)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        library_ms = None if library is None else time_ms(library, reps=50)
        rows[name] = {"C": c, "ms": ms, "plain_ms": plain_ms, **_bounds(nbytes, flops),
                      "library_ms": library_ms, "bytes": nbytes, "flops": flops,
                      "max_disp": None if max_disp is None else float(max_disp.abs().max())}
    for name, disp_, plan_ in (("tricubic_apply", None, plan),
                               ("tricubic_displace_many", d_star, None),
                               ("tricubic_displace", wdisp, None)):
        base = tricubic.stencil_base(name, disp_, plan_)
        rows[name]["staged_share"] = (tricubic.staged_tiles(base, tricubic.BOX_ROWS_OF[name])
                                      / tricubic.n_tiles(base.shape[1:]))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sizes = []
    for n in TIME_SIZES:
        shape = (n,) * 3
        f3 = torch.randn((3,) + shape, generator=gen, device=dev)
        d = smooth_disp(shape, SMOOTH_DISP * n / N_MAIN, gen, dev)
        splan = ref.make_interp_plan(d)
        for name, c, kern in (
            ("tricubic_apply", 2, raw_launcher(lib, "tricubic_apply", f3[:2].contiguous(),
                                              plan=splan)),
            ("tricubic_displace_many", 3, raw_launcher(lib, "tricubic_displace_many", f3, d)),
        ):
            sizes.append({"kernel": name, "n": n, "C": c, "max_disp": float(d.abs().max()),
                          "ms": time_ms(kern, reps=50 * N_MAIN // n),
                          **_bounds(*_tile_bytes_flops(name, c, n ** 3)),
                          "staged_share": tricubic.staged_tiles(splan.ib)
                          / tricubic.n_tiles(shape)})
        del f3, d, splan
    emit("kernel_times", n=N_MAIN, rows=rows, sizes=sizes,
         library_ms_note="no single PyTorch call computes a tricubic interpolation "
                         "(grid_sample is at most trilinear in 3-D), so K1-K3 have none; "
                         "K4's is torch.mul of the stacked planes (1,2,N..) by a "
                         "precomputed beta_c |k|^4 (C,1,N..)")
    return rows


def phase_cohort_kernel_times(cohort, dev) -> dict:
    """K1 (C=2) and K2 (C=3) over the cohort's COHORT_S subjects in one
    launch at 256^3, on the cohort's own fields: the departure plans of its
    solved velocities with a C=2 stack of its templates (K1), the RK2
    midpoint displacements -dt v with the velocity components (K2).  Each
    row: CUDA events over 20 launches (the plain cohort version: 3),
    beside the COHORT_S single-subject launches on the contiguous slabs
    one after another, and the bound from the cohort's bytes and
    operations."""
    from fmad_ab import plain, raw_launcher, time_ms
    from repro_torch.core import planner
    from repro_torch.kernels import build, ref

    lib = build.library()
    out, (_, rho_T), grid, cfg = cohort["out"], cohort["images"], cohort["grid"], cohort["cfg"]
    dt = 1.0 / cfg.n_t
    h = torch.tensor(grid.spacing, dtype=torch.float32, device=dev).reshape(3, 1, 1, 1)
    vg = out["v"] / h  # (S, 3, N..)
    disp = planner.departure_displacement(out["v"], grid, dt)
    plan = ref.make_interp_plan(disp)
    inputs = {
        "tricubic_apply": (torch.stack([rho_T, rho_T * rho_T]).contiguous(), None, plan),
        "tricubic_displace_many": (torch.swapaxes(vg, 0, 1).contiguous(),
                                   (-dt * vg).contiguous(), None),
    }
    rows = {}
    for name, (f, d, p) in inputs.items():
        c, subjects = f.shape[0], f.shape[1]
        npts = math.prod(f.shape[2:])
        slabs = [(f[:, s].contiguous(), None if d is None else d[s].contiguous(),
                  None if p is None else ref.InterpPlan(p.ib[s], p.w[s], p.halo_need))
                 for s in range(subjects)]
        singles = [raw_launcher(lib, name, *slab) for slab in slabs]

        def one_by_one():
            for fn in singles:
                fn()

        nbytes, flops = _tile_bytes_flops(name, c, subjects * npts)
        rows[name] = {"C": c, "S": subjects,
                      "ms": time_ms(raw_launcher(lib, name, f, d, p), reps=20),
                      "single_launches_ms": time_ms(one_by_one, reps=20),
                      "plain_ms": time_ms(lambda: plain(name, f, d, p), reps=3, warmup=1),
                      **_bounds(nbytes, flops), "bytes": nbytes, "flops": flops}
        del slabs, singles
    emit("cohort_kernel_times", n=N_MAIN, rows=rows)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    info = phase_device()
    phase_build()
    errs = phase_kernel_parity(dev)
    phase_cohort_kernel_parity(dev, errs)
    phase_solve_parity(dev)
    phase_full_newton_parity(dev)
    phase_ml_solve_parity(dev)
    phase_cohort_solve_parity(dev)
    ml = phase_multilevel(dev)
    phase_ml_profile(ml, dev)
    del ml
    torch.cuda.empty_cache()
    out, main_launches, images, main_staged = phase_main(dev)
    full_newton = phase_full_newton(out["smoke"], dev)
    warp = phase_warp(out, images, dev)
    spectral = phase_spectral(images, dev)
    solve = _solve_fields(out, dev)
    phase_kernel_parity_solve(solve, errs)
    times = phase_kernel_times(solve, warp, spectral, dev)
    del solve
    phase_profile(out, images, dev)
    del out, images
    launches = {"main_path": main_launches, "full_newton_path": full_newton["launches"],
                "warp": warp["launches"], "spectral": spectral["launches"]}
    # the share of the tiles of each kernel's launches on its path that staged
    path_staged = {"main_path": main_staged, "full_newton_path": full_newton["staged"],
                   "warp": warp["staged"], "spectral": {}}
    del warp, spectral
    torch.cuda.empty_cache()
    cohort = phase_cohort(dev)
    cohort_times = phase_cohort_kernel_times(cohort, dev)
    phase_cohort_profile(cohort, dev)
    launches["cohort_path"], path_staged["cohort_path"] = cohort["launches"], cohort["staged"]
    del cohort
    torch.cuda.empty_cache()
    serve = phase_serve(dev)
    launches["serve_path"], path_staged["serve_path"] = serve["launches"], serve["staged"]
    torch.cuda.empty_cache()
    resilience = phase_resilience(serve, dev)
    launches["resilience_path"] = resilience["launches"]
    torch.cuda.empty_cache()
    launches["resume_path"] = phase_resume(serve, dev)["launches"]
    del serve
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"], "path": meta["path"], "parity": "ok",
         "launches": launches[meta["path"]][name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
         "bound_unfused_ms": times[name]["bound_unfused_ms"],
         "library_ms": times[name]["library_ms"],
         "staged_share": (path_staged[meta["path"]][name]["all"]["share"]
                          if name in path_staged[meta["path"]] else None),
         # every path's launches, and K1/K2 over the cohort's subjects in one
         # launch
         "launches_by_path": {path: n[name] for path, n in launches.items()},
         "cohort": cohort_times.get(name)}
        for name, meta in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
