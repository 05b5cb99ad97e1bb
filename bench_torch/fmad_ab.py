"""What building the tricubic kernels without FMA contraction costs.

The port builds its kernels with ``-fmad=false`` (the rounding contract at
the head of ``src/repro_torch/kernels/csrc/tricubic.cu``: kernel and plain
version round alike, so the V-cycle solve takes the same PCG iterations on
either).  This script builds the library twice from the checkout's sources,
with the port's flags and with ``-fmad=true`` in their place, and times the
three tricubic kernels from both libraries in one process:

* K1 ``tricubic_apply_cuda`` at C=2 and C=3 (transport steps and Hessian
  matvecs),
* K2 ``tricubic_displace_many_cuda`` at C=3 (the RK2 departure solve),
* K3 ``tricubic_displace_cuda`` (one field through a deformation).

Rounds alternate the order of the two libraries (A B, B A, ...); each
timing is CUDA events over ``--reps`` launches after two warm-up launches.
The inputs are random fields and a smooth periodic displacement of at most
``--max-disp`` voxels, made on the card from ``--seed``.  Each variant's
output is also compared with the plain version on the same inputs.

    PYTHONPATH=src python3 bench_torch/fmad_ab.py [--n 256] [--rounds 6]

Prints the card's name and power limit, one JSON line per round and a last
JSON line with each variant's median ms, the ratio of the medians, the
registers ``ptxas`` gave each kernel, and the max abs error against the
plain version.  Needs one CUDA card and ``nvcc``.

The module also holds the measurement helpers that ``tricubic_ab.py``,
``chip_smoke.py`` and the port's tests share: ``time_ms``,
``smooth_disp``, ``raw_launcher``, ``plain`` and ``poisoned_cohort_case``.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import build, ref, tricubic

VARIANTS = {
    "fmad_false": build.NVCC_FLAGS,
    "fmad_true": tuple("-fmad=true" if f == "-fmad=false" else f for f in build.NVCC_FLAGS),
}
SYMBOLS = ("apply_kernel", "displace_kernel", "field_warp_kernel", "apply_cohort_kernel",
           "displace_cohort_kernel")


def _registers(log: str) -> dict:
    """Registers per kernel from a ``-Xptxas -v`` report (mangled names carry
    the symbol length-prefixed, so ``apply_kernel`` is not ``..._apply_kernel``)."""
    regs, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = next((s for s in SYMBOLS if f"{len(s)}{s}" in m.group(1)), None)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            regs[current] = int(m.group(1))
    return regs


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events, after
    ``warmup`` calls."""
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


def smooth_disp(shape, max_disp: float, gen: torch.Generator, dev) -> torch.Tensor:
    """(3, N1, N2, N3) f32: a few periodic low modes (wave numbers 1 and 2)
    scaled to at most ``max_disp`` voxels, phases drawn from ``gen``."""
    axes = [torch.arange(n, device=dev, dtype=torch.float32) * (2 * math.pi / n) for n in shape]
    x1, x2, x3 = torch.meshgrid(*axes, indexing="ij")
    ph = torch.rand((3, 3), generator=gen, device=dev) * (2 * math.pi)
    d = torch.stack([
        torch.sin(x2 + ph[i, 0]) * torch.cos(x3 + ph[i, 1]) + 0.5 * torch.sin(2 * x1 + ph[i, 2])
        for i in range(3)
    ])
    return (d * (max_disp / d.abs().max())).contiguous()


def raw_launcher(lib, name: str, f, disp=None, plan=None, counter=None, staged_arg: bool = True,
                 out=None):
    """A function that launches one tricubic kernel of ``lib`` by a direct
    call of its C entry point on the current stream, into an output
    allocated here, and returns that output.  A timing of it leaves out the
    wrappers' host work (checks, allocation), which at 64^3 takes longer
    than the kernel.  ``name``, a key of ``tricubic.LAUNCHES``:
    "tricubic_apply" (K1, ``plan``), "tricubic_displace_many" (K2,
    ``disp``) or "tricubic_displace" (K3, ``f`` of shape (1, N..), ``disp``).
    A cohort's K1 or K2 launch takes ``f`` (C, S, N..) with a cohort plan
    or displacement.  ``counter``: the staged-tile counter;
    ``staged_arg=False`` for a library whose entry points take none, whose
    K1 and K2 take no subject count and whose K3 takes no channel count
    either (the first design).  The
    function holds every tensor whose pointer it passes: a closure that
    kept only ``data_ptr()`` would let a tensor be freed and the kernel read
    whatever the allocator put there next.  ``out``: the output tensor
    (contiguous, ``f``'s shape), else one is allocated here."""
    c, (n1, n2, n3) = f.shape[0], f.shape[-3:]
    out = torch.empty_like(f) if out is None else out
    stream = torch.cuda.current_stream().cuda_stream
    extra = (None if counter is None else counter.data_ptr(),) if staged_arg else ()
    subjects = (f.shape[1] if f.ndim == 5 else 1,) if staged_arg else ()
    if name == "tricubic_apply":
        fn = lib.tricubic_apply_f32
        args = (f.data_ptr(), plan.ib.data_ptr(), plan.w.data_ptr(), out.data_ptr(), c,
                *subjects, n1, n2, n3, *extra, stream)
    elif name == "tricubic_displace_many":
        fn = lib.tricubic_displace_many_f32
        args = (f.data_ptr(), disp.data_ptr(), out.data_ptr(), c, *subjects, n1, n2, n3, *extra,
                stream)
    else:
        fn = lib.tricubic_displace_f32
        chans = (c,) if staged_arg else ()
        args = (f.data_ptr(), disp.data_ptr(), out.data_ptr(), *chans, n1, n2, n3, *extra, stream)
    held = (f, disp, plan, out, counter)

    def launch():
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{name} launch failed: cudaGetLastError() = {code}")
        return held[3]

    return launch


GUARD_WORDS = 1 << 16  # f32 words of guard on each side of a guarded output
GUARD_VALUE = -123.25


def poisoned_cohort_case(lib, name: str, f, disp, subject: int, value: float,
                         where: str = "disp") -> dict:
    """K1 ("tricubic_apply", its plan made from ``disp``) or K2
    ("tricubic_displace_many") over a cohort, fields ``f`` (C, S, N..) and
    displacements ``disp`` (S, 3, N..), with every other x1-plane of subject
    ``subject``'s displacement (``where="disp"``) or fields
    (``where="fields"``) set to ``value`` (NaN, +inf or -inf).

    The poisoned launch writes into an output placed between two runs of
    ``GUARD_WORDS`` words of ``GUARD_VALUE``.  Returns ``{"launch_ok",
    "guard_intact", "healthy_equal", "healthy_equal_without",
    "plain_equal"}``: the launch and the synchronisation after it raised
    nothing; the guards are untouched; the other subjects' outputs equal,
    bit for bit, those of the launch without the poison and those of a
    launch of the other subjects alone; and the whole output equals the
    plain cohort version's on the same poisoned inputs (NaN where it has
    NaN)."""
    f_bad, d_bad = f.clone(), disp.clone()
    if where == "disp":
        d_bad[subject, :, ::2] = value
    else:
        f_bad[:, subject, ::2] = value
    healthy = [s for s in range(f.shape[1]) if s != subject]

    def inputs(ff, dd):
        if name == "tricubic_apply":
            return {"plan": ref.make_interp_plan(dd)}
        return {"disp": dd}

    n = f.numel()
    buf = torch.full((n + 2 * GUARD_WORDS,), GUARD_VALUE, device=f.device)
    out_bad = buf[GUARD_WORDS:GUARD_WORDS + n].view(f.shape)
    launch_ok = True
    try:
        raw_launcher(lib, name, f_bad, out=out_bad, **inputs(f_bad, d_bad))()
        torch.cuda.synchronize()
    except RuntimeError:
        launch_ok = False
    guard = torch.cat([buf[:GUARD_WORDS], buf[GUARD_WORDS + n:]])
    clean = raw_launcher(lib, name, f, **inputs(f, disp))()
    idx = torch.tensor(healthy, device=f.device)
    f_h, d_h = f[:, idx].contiguous(), disp[idx].contiguous()
    alone = raw_launcher(lib, name, f_h, **inputs(f_h, d_h))()
    want = plain(name, f_bad, **inputs(f_bad, d_bad))
    torch.cuda.synchronize()
    return {
        "launch_ok": launch_ok,
        "guard_intact": bool(torch.all(guard == GUARD_VALUE)),
        "healthy_equal": bool(torch.equal(out_bad[:, idx], clean[:, idx])),
        "healthy_equal_without": bool(torch.equal(out_bad[:, idx], alone)),
        "plain_equal": bool(torch.equal(torch.isnan(out_bad), torch.isnan(want))
                            and torch.equal(torch.nan_to_num(out_bad), torch.nan_to_num(want))),
    }


def plain(name: str, f, disp=None, plan=None):
    """The plain version of what ``raw_launcher(lib, name, f, disp, plan)``
    launches, on the same inputs."""
    if name == "tricubic_apply":
        return ref.interp_apply(f, plan)
    if name == "tricubic_displace_many":
        return ref.tricubic_displace_many(f, disp)
    return ref.tricubic_displace_vec(f, disp)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--max-disp", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fmad_ab: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)

    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(build.build, VARIANTS.values())))
    libs = {name: build.load(path) for name, path in paths.items()}
    regs = {name: _registers((path.parent / build.LOG_NAME).read_text())
            for name, path in paths.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.n
    f3 = torch.randn((3, n, n, n), generator=gen, device=dev)
    f2 = f3[:2].contiguous()
    disp = smooth_disp((n, n, n), args.max_disp, gen, dev)
    plan = ref.make_interp_plan(disp)
    cases = {
        "K1_apply_C2": (lambda: tricubic.tricubic_apply_cuda(f2, plan),
                        lambda: ref.interp_apply(f2, plan)),
        "K1_apply_C3": (lambda: tricubic.tricubic_apply_cuda(f3, plan),
                        lambda: ref.interp_apply(f3, plan)),
        "K2_displace_many_C3": (lambda: tricubic.tricubic_displace_many_cuda(f3, disp),
                                lambda: ref.tricubic_displace_many(f3, disp)),
        "K3_displace": (lambda: tricubic.tricubic_displace_cuda(f3[0], disp),
                        lambda: ref.tricubic_displace(f3[0], disp)),
    }

    errs = {name: {} for name in VARIANTS}
    for case, (kern, plain) in cases.items():
        want = plain()
        for name, lib in libs.items():
            build._LIB = lib
            errs[name][case] = float((kern() - want).abs().max())
        del want

    times = {name: {case: [] for case in cases} for name in VARIANTS}
    order = list(VARIANTS)
    for r in range(args.rounds):
        row = {}
        for name in (order if r % 2 == 0 else order[::-1]):
            build._LIB = libs[name]
            for case, (kern, _) in cases.items():
                ms = time_ms(kern, args.reps)
                times[name][case].append(ms)
                row[f"{name}/{case}"] = ms
        print(json.dumps({"round": r, "ms": row}), flush=True)
    build._LIB = None

    med = {name: {case: statistics.median(v) for case, v in t.items()}
           for name, t in times.items()}
    print(json.dumps({
        "n": n, "rounds": args.rounds, "reps": args.reps, "max_disp": args.max_disp,
        "median_ms": med,
        "ratio_fmad_false_over_true": {c: med["fmad_false"][c] / med["fmad_true"][c]
                                       for c in cases},
        "registers": regs, "max_abs_err_vs_plain": errs,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
