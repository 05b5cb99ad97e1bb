"""Same-call A/B of the tricubic kernels K1-K3 against their first design.

``bench_torch/tricubic_baseline.cu`` is a verbatim copy of the first
design of ``src/repro_torch/kernels/csrc/tricubic.cu`` (one thread per
output point, no shared memory), kept here for measurement only: the port
never builds it.  This script builds it (``baseline``) and the checkout's
``csrc/tricubic.cu`` (``tree``), each into its own library with the port's
flags, and times both in one process at each of ``--sizes`` (cubic grids):

* K1 ``tricubic_apply_f32`` at C=2 and C=3 (transport steps and Hessian
  matvecs) on the plan of a smooth displacement of ``--max-disp`` voxels,
  and K2 ``tricubic_displace_many_f32`` at C=3 (the RK2 departure solve)
  on that displacement: the transport steps' departure fields, whose
  tiles the tree stages;
* K1 at C=2 and K2 at C=3 on smooth displacements of each of
  ``--strained`` voxels: the strain of a larger deformation per time
  step, where part or most of the tiles span more than the tree stages;
* K1 at C=2 and K2 at C=3 on a rough displacement (uniform in
  +-``--rough`` voxels), where no tile of the tree stages its box;
* K3 ``tricubic_displace_f32`` (one field) on the smooth field, on a
  smooth field of ``--warp-disp`` voxels (the size of a whole
  registration's deformation, which the template is warped through), on
  each strained field and on the rough one.

Then, for the tree alone (the first design has no subject axis), a
cohort case at the largest of ``--sizes``: K1 at C=2 and K2 at C=3 over
``COHORT_SUBJECTS`` = 4 subjects in one launch (the cohort width of the
registration server), fields (C, S, N..) against S
smooth displacements of ``--max-disp`` voxels (a cohort's departure
fields, drawn from their own generator so that the cases above keep their
inputs), timed beside the S single-subject launches on the contiguous
slabs of the same inputs, one after another; the cohort launch must equal
those launches and the plain cohort version bit for bit, and count the
tiles the model counts for its subjects.

Smooth displacements are ``fmad_ab.smooth_disp`` with the amplitude given
at 256^3 and scaled by n/256 at other sizes (the same physical field on
every grid).  Inputs are made on the card from ``--seed``.  Each kernel is
launched by a direct call of its C entry point on a preallocated output
(``fmad_ab.raw_launcher``), so no wrapper's host work is timed; a timing
is CUDA events over ``reps`` launches after two warm-up launches, with
``reps`` = 50 x 256 / n.  Rounds run the libraries in turns, the order
reversed every other round.  Each library's output is compared with the
plain version on the same inputs, and the tree's staged-tile counter with
the plain model ``tricubic.staged_tiles``.

    PYTHONPATH=src python3 bench_torch/tricubic_ab.py [--sizes 64 128 256] [--rounds 6]

Prints the card's name and power limit, each library's ``ptxas`` report
(registers, shared memory, spill bytes), one JSON line per round and a
last JSON line with each library's median ms per case, the ratio
tree / baseline, the max abs error against the plain version and the
tree's staged share, and the cohort cases' medians (one launch over S
subjects and the sum of S single-subject launches) with their ratio.
Exits 1 if the tree is not bit for bit equal to the plain version (or, a
cohort launch, to its single-subject launches) or stages other tiles than
the model.  Needs one CUDA card
and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from fmad_ab import plain, raw_launcher, smooth_disp, time_ms
from repro_torch.kernels import build, ref, tricubic

HERE = Path(__file__).resolve().parent
BASELINE = HERE / "tricubic_baseline.cu"
COHORT_SUBJECTS = 4  # the cohort case's S: the server's slots, the cohort path's width
_VP, _I = ctypes.c_void_p, ctypes.c_int
# the first design's entry points: no staged-tile counter, and K3 takes one
# field with no channel count
BASELINE_SIGNATURES = {
    "tricubic_apply_f32": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "tricubic_displace_many_f32": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "tricubic_displace_f32": [_VP, _VP, _VP, _I, _I, _I, _VP],
}
TREE_SIGNATURES = {name: build.SIGNATURES[name] for name in BASELINE_SIGNATURES}
SYMBOLS = ("apply_kernel", "displace_kernel", "field_warp_kernel", "apply_cohort_kernel",
           "displace_cohort_kernel")


def _ptxas(log: str) -> dict:
    """Registers, shared memory and spill bytes per kernel from a
    ``-Xptxas -v`` report (mangled names carry the symbol length-prefixed)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = next((s for s in SYMBOLS if f"{len(s)}{s}" in m.group(1)), None)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(current, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            s = re.search(r"(\d+) bytes smem", line)
            out.setdefault(current, {}).update(registers=int(m.group(1)),
                                               smem_bytes=int(s.group(1)) if s else 0)
    return out


def _cases(n: int, args, gen, warp_gen, dev) -> dict:
    """case -> (kernel, fields, displacement, plan) at n^3.  The warp-sized
    field comes from ``warp_gen``, so that ``gen`` draws the K1 and K2
    inputs of the script before K3 had cases (a same-call comparison with
    that script's commit times both on the same fields)."""
    f3 = torch.randn((3, n, n, n), generator=gen, device=dev)
    f2 = f3[:2].contiguous()
    f1 = f3[:1].contiguous()
    smooth = smooth_disp((n, n, n), args.max_disp * n / 256, gen, dev)
    plan = ref.make_interp_plan(smooth)
    cases = {
        "K1_C2_smooth": ("tricubic_apply", f2, smooth, plan),
        "K1_C3_smooth": ("tricubic_apply", f3, smooth, plan),
        "K2_C3_smooth": ("tricubic_displace_many", f3, smooth, plan),
        "K3_smooth": ("tricubic_displace", f1, smooth, None),
    }
    for amp in args.strained:
        d = smooth_disp((n, n, n), amp * n / 256, gen, dev)
        p = ref.make_interp_plan(d)
        cases[f"K1_C2_strained{amp:g}"] = ("tricubic_apply", f2, d, p)
        cases[f"K2_C3_strained{amp:g}"] = ("tricubic_displace_many", f3, d, p)
        cases[f"K3_strained{amp:g}"] = ("tricubic_displace", f1, d, None)
    rough = (torch.rand((3, n, n, n), generator=gen, device=dev) * 2 - 1) * args.rough
    plan = ref.make_interp_plan(rough)
    cases["K1_C2_rough"] = ("tricubic_apply", f2, rough, plan)
    cases["K2_C3_rough"] = ("tricubic_displace_many", f3, rough, plan)
    cases["K3_rough"] = ("tricubic_displace", f1, rough, None)
    warp = smooth_disp((n, n, n), args.warp_disp * n / 256, warp_gen, dev)
    cases["K3_warp"] = ("tricubic_displace", f1, warp, None)
    return cases


def _cohort(n: int, subjects: int, max_disp: float, lib, rounds: int, gen, dev) -> dict:
    """The tree's K1 (C=2) and K2 (C=3) over ``subjects`` subjects at n^3 in
    one launch, against the same subjects launched one by one: bit for bit
    (also against the plain cohort version), the staged tiles against the
    model, and the medians over ``rounds`` of CUDA-event timings, in turns."""
    shape = (n, n, n)
    disp = torch.stack([smooth_disp(shape, max_disp * n / 256, gen, dev)
                        for _ in range(subjects)])
    plan = ref.make_interp_plan(disp)
    f3 = torch.randn((3, subjects) + shape, generator=gen, device=dev)
    reps = max(1, 50 * 256 // n)
    out = {}
    for name, c in (("tricubic_apply", 2), ("tricubic_displace_many", 3)):
        f = f3[:c].contiguous()
        slabs = [f[:, s].contiguous() for s in range(subjects)]
        subj = [(disp[s], ref.InterpPlan(plan.ib[s], plan.w[s], plan.halo_need))
                for s in range(subjects)]
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        got = raw_launcher(lib, name, f, disp, plan, counter=counter)()
        singles = [raw_launcher(lib, name, slabs[s], *subj[s])() for s in range(subjects)]
        torch.cuda.synchronize()
        want = plain(name, f, disp, plan)
        err_plain = float((got - want).abs().max())
        err_single = max(float((got[:, s] - singles[s]).abs().max()) for s in range(subjects))
        del want, singles
        staged = int(counter.item())
        model = tricubic.staged_tiles(tricubic.stencil_base(name, disp, plan))
        cohort_fn = raw_launcher(lib, name, f, disp, plan)
        single_fns = [raw_launcher(lib, name, slabs[s], *subj[s]) for s in range(subjects)]

        def one_by_one():
            for fn in single_fns:
                fn()

        ms = {"cohort": [], "singles": []}
        for r in range(rounds):
            for key in (("cohort", "singles") if r % 2 == 0 else ("singles", "cohort")):
                ms[key].append(time_ms(cohort_fn if key == "cohort" else one_by_one, reps))
        med = {k: statistics.median(v) for k, v in ms.items()}
        out[f"{name}_C{c}_S{subjects}@{n}"] = {
            "median_ms": med, "cohort_over_singles": med["cohort"] / med["singles"],
            "ms": ms, "max_abs_err_vs_plain": err_plain,
            "max_abs_err_vs_single_launches": err_single,
            "staged_tiles": {"tree": staged, "model": model,
                             "tiles": subjects * tricubic.n_tiles(shape)},
        }
        del f, slabs, cohort_fn, single_fns
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--max-disp", type=float, default=2.0)
    ap.add_argument("--strained", type=float, nargs="*", default=[16.0, 24.0])
    ap.add_argument("--rough", type=float, default=12.0)
    ap.add_argument("--warp-disp", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tricubic_ab: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)

    sources = {"baseline": BASELINE, "tree": build.CSRC / "tricubic.cu"}
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {v: pool.submit(build.build, build.NVCC_FLAGS, (p,))
                   for v, p in sources.items()}
        paths = {v: f.result() for v, f in futures.items()}
    libs = {"baseline": build.load(paths["baseline"], BASELINE_SIGNATURES),
            "tree": build.load(paths["tree"], TREE_SIGNATURES)}
    ptxas = {v: _ptxas((p.parent / build.LOG_NAME).read_text()) for v, p in paths.items()}
    print(json.dumps({"ptxas": ptxas}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    warp_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    times, errs, staged = {}, {}, {}
    for n in args.sizes:
        reps = max(1, 50 * 256 // n)
        launches = {}
        for case, (name, f, disp, plan) in _cases(n, args, gen, warp_gen, dev).items():
            key = f"{case}@{n}"
            want = plain(name, f, disp, plan)
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            errs[key], launches[key] = {}, {}
            for variant, lib in libs.items():
                base = variant == "baseline"
                got = raw_launcher(lib, name, f, disp, plan, counter=None if base else counter,
                                   staged_arg=not base)()
                torch.cuda.synchronize()
                errs[key][variant] = float((got - want).abs().max())
                launches[key][variant] = raw_launcher(lib, name, f, disp, plan,
                                                      staged_arg=not base)
                del got
            del want
            tiles = tricubic.n_tiles(f.shape[1:])
            model = tricubic.staged_tiles(tricubic.stencil_base(name, disp, plan),
                                          tricubic.BOX_ROWS_OF[name])
            staged[key] = {"tree": int(counter.item()), "model": model,
                           "tiles": tiles, "share": int(counter.item()) / tiles}
        order = list(libs)
        for r in range(args.rounds):
            row = {}
            for variant in (order if r % 2 == 0 else order[::-1]):
                for key, fns in launches.items():
                    ms = time_ms(fns[variant], reps)
                    times.setdefault(key, {}).setdefault(variant, []).append(ms)
                    row[f"{variant}/{key}"] = ms
            print(json.dumps({"n": n, "round": r, "reps": reps, "ms": row}), flush=True)
        del launches
        torch.cuda.empty_cache()

    cohort_gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    cohort = _cohort(max(args.sizes), COHORT_SUBJECTS, args.max_disp, libs["tree"],
                     args.rounds, cohort_gen, dev)
    print(json.dumps({"cohort": cohort}), flush=True)

    med = {key: {v: statistics.median(ts) for v, ts in t.items()} for key, t in times.items()}
    print(json.dumps({
        "sizes": args.sizes, "rounds": args.rounds, "max_disp_at_256": args.max_disp,
        "warp_disp_at_256": args.warp_disp, "strained_at_256": args.strained,
        "rough": args.rough, "median_ms": med,
        "tree_over_baseline": {k: m["tree"] / m["baseline"] for k, m in med.items()},
        "ptxas": ptxas, "max_abs_err_vs_plain": errs, "staged_tiles": staged,
        "cohort": {k: {"median_ms": c["median_ms"], "cohort_over_singles": c["cohort_over_singles"]}
                   for k, c in cohort.items()},
    }), flush=True)
    bad = {k: e for k, e in errs.items() if e["tree"] != 0.0}
    bad.update({k: c for k, c in cohort.items()
                if c["max_abs_err_vs_plain"] != 0.0 or c["max_abs_err_vs_single_launches"] != 0.0})
    mismatch = {k: s for k, s in staged.items() if s["tree"] != s["model"]}
    mismatch.update({k: c["staged_tiles"] for k, c in cohort.items()
                     if c["staged_tiles"]["tree"] != c["staged_tiles"]["model"]})
    if bad or mismatch:
        print(json.dumps({"failed": {"not_bit_exact": bad, "staged_mismatch": mismatch}}),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
