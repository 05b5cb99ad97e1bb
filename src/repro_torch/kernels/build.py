"""Build the CUDA kernels at first use and bind them with ``ctypes``.

``nvcc`` compiles each source of ``csrc/`` for ``sm_90a`` (one compiler
process per source, all started together) and links the objects into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds).  The library goes to ``build/kernels/<hash of the
sources>/`` at the root of the checkout, a directory ``.gitignore`` lists;
a changed source builds anew, an unchanged one is loaded from there.  Nothing is built when the
module is imported: the CPU tests import every module on machines that
have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "tricubic.cu", CSRC / "spectral_diag.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: no multiply is fused into an add; part of the rounding
# contract stated at the head of csrc/tricubic.cu
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
LIB_NAME = "libkernels.so"
LOG_NAME = "ptxas.log"

_VP, _I, _FP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
SIGNATURES = {
    "tricubic_apply_f32": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _VP],
    "tricubic_displace_many_f32": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _VP],
    "tricubic_displace_f32": [_VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP],
    "biharmonic_scale_f32": [_VP, _VP, _VP, _VP, _FP, _I, _I, _I, _I, _VP],
}

_LIB: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def source_hash(flags: tuple[str, ...] = NVCC_FLAGS, sources: tuple[Path, ...] = SOURCES) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build_dir(flags: tuple[str, ...] = NVCC_FLAGS, sources: tuple[Path, ...] = SOURCES) -> Path:
    return BUILD_ROOT / source_hash(flags, sources)


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build(flags: tuple[str, ...] = NVCC_FLAGS, sources: tuple[Path, ...] = SOURCES) -> Path:
    """Compile the kernels unless this source's library exists; return its path.

    Every source compiles to an object in its own ``nvcc`` process, all
    running at once; one more ``nvcc`` links them.  The compilers'
    ``-Xptxas -v`` reports (registers, shared memory, spills) are kept
    beside the library as ``ptxas.log``.  Objects and library are written
    under temporary names, so a concurrent build never loads a half-written
    file.  ``flags`` other than ``NVCC_FLAGS`` build a variant for a
    measurement (``bench_torch/fmad_ab.py``), and other ``sources`` a
    library to compare with (``bench_torch/tricubic_ab.py``); the wrappers
    load the default.
    """
    out_dir = build_dir(flags, sources)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        cmds = [[nvcc, *flags, "-c", "-o", str(o), str(src)] for src, o in zip(sources, objs)]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        tmp_lib = Path(tmp) / LIB_NAME
        _run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)])
        (out_dir / LOG_NAME).write_text("".join(logs))
        os.replace(tmp_lib, lib)
    return lib


def ptxas_log() -> str:
    """The ``-Xptxas -v`` report of the current build (builds if needed)."""
    build()
    return (build_dir() / LOG_NAME).read_text()


def load(path: Path, signatures: dict = SIGNATURES) -> ctypes.CDLL:
    """Load a built library, with the ``argtypes`` of every function that
    ``signatures`` names set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The kernel library the wrappers launch from (built at first use)."""
    global _LIB
    if _LIB is None:
        _LIB = load(build())
    return _LIB
