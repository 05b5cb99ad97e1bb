"""Fused spectral diagonal scaling: ``out_c = beta_c * |k|^4 * spec`` for
several ``beta_c`` in one pass over a full c2c spectrum held as two real
planes.  Counterpart of ``repro/kernels/spectral_diag.py``:

* ``biharmonic_scale_cuda(spec_re, spec_im, betas)`` replaces
  ``biharmonic_scale_pallas`` (body ``_kernel``); CUDA source
  ``csrc/spectral_diag.cu``.
* ``biharmonic_scale_ref`` is its plain version: the fftfreq wavenumbers of
  ``Grid.k_grids(rfft_last=False)``, the symbol formed as
  ``(beta * |k|^2) * |k|^2`` in f32 like the kernel.
* ``biharmonic_scale(..., method="auto")`` picks one of the two under the
  rule of ``kernels/ops.py``: the kernel for CUDA tensors, the plain
  version for CPU tensors, ``"ref"`` the plain version anywhere.

No solver path calls it, in either package: the solver applies
``beta Lap^2`` on the rfft half-spectrum inside ``SpectralOps``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.grid import make_grid
from repro_torch.kernels import build
from repro_torch.kernels.ops import _use_kernel
from repro_torch.kernels.tricubic import _check, _raise_on

MAX_BETAS = 8  # kMaxBetas of csrc/spectral_diag.cu: the betas go by value

# launches since the last reset_launches() (see kernels/tricubic.py)
LAUNCHES = {"biharmonic_scale": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _betas(betas) -> tuple[float, ...]:
    betas = tuple(float(b) for b in betas)
    if not 1 <= len(betas) <= MAX_BETAS:
        raise ValueError(f"biharmonic_scale takes 1 to {MAX_BETAS} betas, got {len(betas)}")
    return betas


def _ksq(shape3, device) -> torch.Tensor:
    """|k|^2 on the full fftfreq grid, float32 (exact integers)."""
    k1, k2, k3 = make_grid(tuple(shape3)).k_grids(rfft_last=False)
    return torch.as_tensor((k1**2 + k2**2 + k3**2).astype(np.float32), device=device)


def biharmonic_scale_ref(spec_re: torch.Tensor, spec_im: torch.Tensor, betas=(1.0,)):
    """Plain version: returns (out_re, out_im), each (len(betas), N1,N2,N3)."""
    betas = _betas(betas)
    ksq = _ksq(spec_re.shape, spec_re.device)
    sym = torch.stack([(b * ksq) * ksq for b in betas])
    return spec_re * sym, spec_im * sym


def biharmonic_scale_cuda(spec_re: torch.Tensor, spec_im: torch.Tensor, betas=(1.0,)):
    """The CUDA kernel: ``spec_re``, ``spec_im`` (N1,N2,N3) f32 contiguous on
    one card; returns (out_re, out_im), each (len(betas), N1,N2,N3)."""
    betas = _betas(betas)
    if spec_re.ndim != 3:
        raise ValueError(f"spec_re must be (N1, N2, N3), got shape {tuple(spec_re.shape)}")
    n1, n2, n3 = spec_re.shape
    if n1 * n2 * n3 >= 2**31:
        raise ValueError("grids of 2^31 points or more are not supported")
    _check("spec_re", spec_re, torch.float32, spec_re.shape, spec_re.device)
    _check("spec_im", spec_im, torch.float32, spec_re.shape, spec_re.device)
    lib = build.library()
    out_shape = (len(betas), n1, n2, n3)
    out_re = torch.empty(out_shape, dtype=torch.float32, device=spec_re.device)
    out_im = torch.empty_like(out_re)
    c_betas = (ctypes.c_float * len(betas))(*betas)
    with torch.cuda.device(spec_re.device):
        code = lib.biharmonic_scale_f32(
            spec_re.data_ptr(), spec_im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
            c_betas, len(betas), n1, n2, n3, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "biharmonic_scale_f32")
    LAUNCHES["biharmonic_scale"] += 1
    return out_re, out_im


def biharmonic_scale(spec_re: torch.Tensor, spec_im: torch.Tensor, betas=(1.0,), *,
                     method: str = "auto"):
    """``beta_c * |k|^4`` applied to both planes, for every beta, in one pass."""
    if not _use_kernel(method, spec_re):
        return biharmonic_scale_ref(spec_re, spec_im, betas)
    return biharmonic_scale_cuda(spec_re.contiguous(), spec_im.contiguous(), betas)
