"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
kernel against its plain PyTorch version on the card, checks that the
kernel path and the plain path give the same solve at 64^3, runs the
default single-level ``register()`` at 256^3 and shows that it went
through both kernels, times the kernels beside their bounds, and profiles
one more Newton iteration by kernel class.  Every
phase prints one JSON line; any failed phase ends the run with a nonzero
exit code.  The last line is ``{"ok": true, "device": {...}}``.

Imports neither JAX nor the JAX package.  Exits nonzero without printing a
result when no CUDA device is present.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
N_MAIN = 256
N_SOLVE_PARITY = 64
NONCUBIC = (40, 48, 36)  # N3 % 8 != 0: no tile condition
MAX_DISP = 12.0  # voxels, beyond the TPU kernels' halo of 4
ATOL, RTOL = 2e-5, 1e-4  # kernel against plain version (tests/test_kernels.py)
V_TOL = 1e-4  # solve parity: max |v_kernel - v_ref|
MAX_NEWTON = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
KERNELS = {
    "tricubic_apply": {
        "source": "src/repro_torch/kernels/csrc/tricubic.cu",
        "replaces": "src/repro/kernels/tricubic.py:243",
    },
    "tricubic_displace_many": {
        "source": "src/repro_torch/kernels/csrc/tricubic.cu",
        "replaces": "src/repro/kernels/tricubic.py:202",
    },
}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **payload) -> None:
    print(json.dumps({"phase": phase, **payload}), flush=True)


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
            current = "apply_kernel" if "apply_kernel" in m.group(1) else (
                "displace_kernel" if "displace_kernel" in m.group(1) else m.group(1))
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
    require(set(per_kernel) >= {"apply_kernel", "displace_kernel"},
            f"ptxas report lacks a kernel: {log}")
    emit("build", seconds=secs, dir=str(build.build_dir()), ptxas=per_kernel)


# --------------------------------------------------------------------------- #
def _inputs(shape, c, gen, dev):
    f = torch.randn((c,) + shape, generator=gen, device=dev)
    d = (torch.rand((3,) + shape, generator=gen, device=dev) * 2 - 1) * MAX_DISP
    return f, d


def _compare(got, want) -> float:
    err = (got - want).abs()
    ok = bool(torch.all(err <= ATOL + RTOL * want.abs()))
    require(ok, f"kernel disagrees with plain version: max abs err {float(err.max())}")
    return float(err.max())


def phase_kernel_parity(dev) -> dict:
    from repro_torch.kernels import ref, tricubic

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {name: 0.0 for name in KERNELS}
    cases = []
    for shape in ((N_MAIN,) * 3, NONCUBIC):
        for name, chans in (("tricubic_apply", (1, 2, 3)), ("tricubic_displace_many", (3,))):
            for c in chans:
                f, d = _inputs(shape, c, gen, dev)
                if name == "tricubic_apply":
                    plan = ref.make_interp_plan(d)
                    got = tricubic.tricubic_apply_cuda(f, plan)
                    want = ref.interp_apply(f, plan)
                else:
                    got = tricubic.tricubic_displace_many_cuda(f, d)
                    want = ref.tricubic_displace_many(f, d)
                torch.cuda.synchronize()
                err = _compare(got, want)
                errs[name] = max(errs[name], err)
                cases.append({"kernel": name, "shape": list(shape), "C": c,
                              "max_disp": float(d.abs().max()), "max_abs_err": err})
                del f, d, got, want
    emit("kernel_parity", atol=ATOL, rtol=RTOL, cases=cases)
    return errs


# --------------------------------------------------------------------------- #
def _register(n, method, dev):
    """The default single-level ``register()`` on the brain phantom pair,
    cut to ``MAX_NEWTON`` Newton iterations.  Returns (result, images)."""
    from repro_torch.core import gauss_newton as gn
    from repro_torch.core.registration import RegistrationConfig, register
    from repro_torch.data import synthetic

    rho_R, rho_T, grid = synthetic.brain_like(n, seed=SEED, device=dev)
    cfg = RegistrationConfig(solver=gn.GNConfig(max_newton=MAX_NEWTON, interp_method=method))
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


def _expected_launches(history) -> dict:
    """Launches the code makes, counted from the solve's history.

    K2 (departure solve): 2 per Newton state (+v and -v), 1 per Armijo
    trial, 2 for the final diagnostics plan.  K1 (planned apply): 4 for the
    state and 4 for the adjoint transport of each Newton state, 8 per GN
    matvec, 4 per Armijo trial, 5 for the deformation map and 4 for the
    final stacked transport.
    """
    newton = len(history)
    trials = sum(1 + h["armijo_trials"] for h in history)
    matvecs = sum(h["cg_iters"] for h in history)
    return {
        "tricubic_displace_many": 2 * newton + trials + 2,
        "tricubic_apply": 8 * newton + 8 * matvecs + 4 * trials + 5 + 4,
    }


def phase_main(dev) -> tuple[dict, dict, tuple]:
    from repro_torch import telemetry
    from repro_torch.kernels import tricubic

    torch.cuda.reset_peak_memory_stats()
    tricubic.reset_launches()
    t0 = time.perf_counter()
    with telemetry.ListSink() as sink:
        out, images = _register(N_MAIN, "auto", dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(tricubic.LAUNCHES)
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
         launches=launches, expected_launches=expected)
    for name in KERNELS:
        require(launches[name] > 0, f"{name} was not launched on the main path")
    require(launches == expected, f"launch counts {launches} != counted from code {expected}")
    scalars = [out["det_min"], out["det_max"], out["residual_rel"]]
    scalars += [x for h in out["history"] for x in (h["J"], h["gnorm"])]
    require(all(np.isfinite(scalars)), f"non-finite diagnostics: {scalars}")
    require(bool(torch.isfinite(out["v"]).all()), "non-finite velocity")
    require(out["det_min"] > 0, f"det_min = {out['det_min']} <= 0")
    return out, launches, images


def _kernel_class(name: str) -> str:
    if "apply_kernel" in name:
        return "K1 tricubic_apply"
    if "displace_kernel" in name:
        return "K2 tricubic_displace_many"
    if re.search(r"fft|radix", name, re.I):
        return "cuFFT"
    if re.search(r"memcpy|memset", name, re.I):
        return "copies"
    return "other (elementwise, reductions, cat)"


def phase_profile(out, images, dev) -> None:
    """Device time of one more Newton iteration at 256^3, from the solved
    velocity, by kernel class (torch.profiler's CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import gauss_newton as gn
    from repro_torch.core import objective as obj
    from repro_torch.core.spectral import SpectralOps

    grid = out["grid"]
    cfg = gn.GNConfig()
    ops = SpectralOps(grid, device=dev)
    prob = obj.Problem(grid, ops.smooth(images[0]), ops.smooth(images[1]), cfg.beta, cfg.n_t,
                       cfg.incompressible)
    g0 = torch.tensor(out["history"][0]["gnorm"], dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, log = gn.newton_iteration(out["v"], g0, prob, ops, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, by_name = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_class[_kernel_class(e.name)] = by_class.get(_kernel_class(e.name), 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", n=N_MAIN, cg_iters=log.cg_iters, armijo_trials=log.ls_iters,
         wall_ms_profiled=wall * 1e3,
         device_ms=by_class if busy else "not measured: the profiler recorded no CUDA activity",
         device_busy_ms=busy, idle_share=(1 - busy / (wall * 1e3)) if busy else None,
         top_kernels_ms=[{"name": n[:120], "ms": ms} for n, ms in top])


# --------------------------------------------------------------------------- #
def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_times(out, dev) -> dict:
    """Times at 256^3 on the main path's own data: the departure solve of
    the solved velocity (K2, C=3), and the planned apply of its departure
    plan to a C=2 stack of deformed images (K1, the C of the adjoint and
    incremental transport steps)."""
    from repro_torch.core import gauss_newton as gn
    from repro_torch.core import planner
    from repro_torch.kernels import ref, tricubic

    grid = out["grid"]
    v = out["v"]
    dt = 1.0 / gn.GNConfig().n_t
    h = torch.tensor(grid.spacing, dtype=torch.float32, device=dev).reshape(3, 1, 1, 1)
    vg = (v / h).contiguous()
    d_star = (-dt * vg).contiguous()
    disp = planner.departure_displacement(v, grid, dt)
    plan = ref.make_interp_plan(disp)
    lam = out["rho_deformed"]
    f2 = torch.stack([lam, lam * lam]).contiguous()
    npts = grid.num_points
    rows = {}
    for name, kern, plain, c, nbytes, flops in (
        ("tricubic_apply", lambda: tricubic.tricubic_apply_cuda(f2, plan),
         lambda: ref.interp_apply(f2, plan), 2, (2 * 2 + 15) * 4 * npts, 168 * 2 * npts),
        ("tricubic_displace_many", lambda: tricubic.tricubic_displace_many_cuda(vg, d_star),
         lambda: ref.tricubic_displace_many(vg, d_star), 3, (2 * 3 + 3) * 4 * npts,
         (168 * 3 + 66) * npts),
    ):
        ms = _time_ms(kern, reps=50)
        plain_ms = _time_ms(plain, reps=3, warmup=1)
        bound, by = _bound_ms(nbytes, flops)
        rows[name] = {"C": c, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "bytes": nbytes, "flops": flops,
                      "max_disp": float((disp if name == "tricubic_apply" else d_star).abs().max())}
    emit("kernel_times", n=N_MAIN, rows=rows,
         library_ms_note="no single PyTorch call computes a tricubic interpolation; "
                         "grid_sample is at most trilinear in 3-D, so library_ms is null")
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
    phase_solve_parity(dev)
    out, launches, images = phase_main(dev)
    times = phase_kernel_times(out, dev)
    phase_profile(out, images, dev)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **meta, "parity": "ok",
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
         "library_ms": None}
        for name, meta in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
