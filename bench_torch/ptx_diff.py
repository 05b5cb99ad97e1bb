"""Kernel-by-kernel PTX comparison of two copies of a CUDA source.

Compiles each of ``OLD`` and ``NEW`` to PTX with the port's flags
(``build.NVCC_FLAGS`` for ``sm_90a``, ``-ptx`` in place of the object
file) and compares the body of every kernel entry of ``OLD`` with the
entry of the same name in ``NEW``.  Mangled names and basic-block labels
are made anonymous first: a template argument changes a mangled name, and
a kernel added before another renumbers the other's labels, without
changing one instruction.  Kernels are named by the unmangled identifier
(``apply_kernel``).  For example, against a parent commit unpacked under
``build/parent``:

    PYTHONPATH=src python3 bench_torch/ptx_diff.py \\
        build/parent/src/repro_torch/kernels/csrc/tricubic.cu \\
        src/repro_torch/kernels/csrc/tricubic.cu

Prints one JSON line: for each kernel of ``OLD``, ``identical`` or
``differs`` (or ``missing`` from ``NEW``) with both bodies' line counts,
and the kernels only ``NEW`` has.  Exits 1 when a kernel of ``OLD`` is
not identical.  Needs ``nvcc``, no card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.kernels import build

_ENTRY = re.compile(r"^\.(?:visible \.)?entry\s+(\w+)", re.M)


def kernel_name(mangled: str) -> str:
    """The identifier a mangled entry name ends its scope with: the
    length-prefixed name ending in ``kernel`` (``..._12apply_kernelEPKf..``
    -> ``apply_kernel``); other names unchanged."""
    for m in re.finditer(r"\d+", mangled):
        digits = m.group(0)
        for i in range(len(digits)):
            name = mangled[m.end():m.end() + int(digits[i:])]
            if name.endswith("kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
                return name
    return mangled


def bodies(ptx: str) -> dict[str, list[str]]:
    """kernel name -> its entry's lines, mangled names and block labels
    made anonymous."""
    starts = [m.start() for m in _ENTRY.finditer(ptx)] + [len(ptx)]
    out = {}
    for a, b in zip(starts, starts[1:]):
        block = ptx[a:b]
        name = kernel_name(_ENTRY.match(block).group(1))
        block = re.sub(r"\$L__BB\d+_", "$L__BB_", re.sub(r"_Z\w+", "_Z", block))
        out[name] = block.splitlines()
    return out


def compile_ptx(source: Path, ptx: Path) -> str:
    # the port's flags without its arch pair (-ptx takes one target) and
    # without ptxas's report (no ptxas runs)
    flags = [f for f in build.NVCC_FLAGS if f not in build.ARCH_FLAGS + ("-Xptxas", "-v")]
    proc = subprocess.run([build.find_nvcc(), "-arch=sm_90a", *flags, "-ptx", "-o", str(ptx),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return ptx.read_text()


def compare(old: dict[str, list[str]], new: dict[str, list[str]]) -> dict:
    kernels = {}
    for name, body in old.items():
        verdict = ("missing" if name not in new
                   else "identical" if new[name] == body else "differs")
        kernels[name] = {"verdict": verdict, "lines": [len(body), len(new.get(name, []))]}
    return {"kernels": kernels, "new_only": sorted(set(new) - set(old))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    args = ap.parse_args()
    build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_ROOT) as tmp:
        old, new = (bodies(compile_ptx(src, Path(tmp) / f"{tag}.ptx"))
                    for tag, src in (("old", args.old), ("new", args.new)))
    result = compare(old, new)
    print(json.dumps(result), flush=True)
    return 0 if all(k["verdict"] == "identical" for k in result["kernels"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
