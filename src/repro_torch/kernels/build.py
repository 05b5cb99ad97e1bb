"""Build the CUDA kernels at first use and bind them with ``ctypes``.

``nvcc`` compiles ``csrc/tricubic.cu`` for ``sm_90a`` into a shared library
with a plain C interface (no PyTorch headers, so the build takes seconds).
The library goes to ``build/kernels/<hash of the source>/`` at the root of
the checkout, a directory ``.gitignore`` lists; a changed source builds
anew, an unchanged one is loaded from there.  Nothing is built when the
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
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "tricubic.cu",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
LIB_NAME = "libtricubic.so"
LOG_NAME = "ptxas.log"

_VP, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "tricubic_apply_f32": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "tricubic_displace_many_f32": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
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


def source_hash() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build() -> Path:
    """Compile the kernels unless this source's library exists; return its path.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside the library as ``ptxas.log``.  The library is written
    under a temporary name and renamed, so a concurrent build never loads
    a half-written file.
    """
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    (out_dir / LOG_NAME).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def ptxas_log() -> str:
    """The ``-Xptxas -v`` report of the current build (builds if needed)."""
    build()
    return (build_dir() / LOG_NAME).read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library, with every function's ``argtypes`` set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
