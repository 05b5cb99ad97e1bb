"""Wrappers of the hand-written CUDA tricubic kernels (``csrc/tricubic.cu``).

Counterpart of ``repro/kernels/tricubic.py``:

* ``tricubic_apply_cuda(fields, plan)`` replaces ``tricubic_apply_pallas``
  (body ``_kernel_planned``): the planned apply of every transport step and
  every Gauss-Newton Hessian matvec.  Plain version: ``ref.interp_apply``.
* ``tricubic_displace_many_cuda(fields, disp)`` replaces
  ``tricubic_displace_pallas_many`` (body ``_kernel_many``): the RK2
  departure solve.  Plain version: ``ref.tricubic_displace_many``.
* ``tricubic_displace_cuda(field, disp)`` replaces
  ``tricubic_displace_pallas`` (body ``_kernel``): one field resampled at
  x + disp, e.g. the template through a returned deformation.  Plain
  version: ``ref.tricubic_displace``.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, raises
if the launch was refused, and adds one to its entry of ``LAUNCHES``.  The
choice between a kernel and its plain version is made by the caller from
the tensor's device (``kernels/ops.py``); nothing here falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import InterpPlan

# launches per kernel since the last reset_launches(): a run reads these to
# show that its path went through the kernels
LAUNCHES = {"tricubic_apply": 0, "tricubic_displace_many": 0, "tricubic_displace": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the fields on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_fields(fields: torch.Tensor) -> tuple[int, int, int, int]:
    if fields.ndim != 4:
        raise ValueError(f"fields must be (C, N1, N2, N3), got shape {tuple(fields.shape)}")
    c, n1, n2, n3 = fields.shape
    if min(c, n1, n2, n3) < 1:
        raise ValueError(f"fields shape {tuple(fields.shape)} has an empty axis")
    if n1 * n2 * n3 >= 2**31:
        raise ValueError("grids of 2^31 points or more are not supported")
    _check("fields", fields, torch.float32, fields.shape, fields.device)
    return c, n1, n2, n3


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaGetLastError() = {code}")


def tricubic_apply_cuda(fields: torch.Tensor, plan: InterpPlan) -> torch.Tensor:
    """Planned apply: ``fields`` (C, N1,N2,N3) f32 at the plan's points.

    ``plan.ib`` (3, N..) int32 and ``plan.w`` (3, 4, N..) f32, all on the
    fields' CUDA device and contiguous.  Returns (C, N1,N2,N3).
    """
    c, n1, n2, n3 = _check_fields(fields)
    _check("plan.ib", plan.ib, torch.int32, (3, n1, n2, n3), fields.device)
    _check("plan.w", plan.w, torch.float32, (3, 4, n1, n2, n3), fields.device)
    lib = build.library()
    out = torch.empty_like(fields)
    with torch.cuda.device(fields.device):
        code = lib.tricubic_apply_f32(
            fields.data_ptr(), plan.ib.data_ptr(), plan.w.data_ptr(), out.data_ptr(),
            c, n1, n2, n3, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "tricubic_apply_f32")
    LAUNCHES["tricubic_apply"] += 1
    return out


def tricubic_displace_many_cuda(fields: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Batched displace: ``fields`` (C, N1,N2,N3) f32 at x + ``disp`` (3, N..)."""
    c, n1, n2, n3 = _check_fields(fields)
    _check("disp", disp, torch.float32, (3, n1, n2, n3), fields.device)
    lib = build.library()
    out = torch.empty_like(fields)
    with torch.cuda.device(fields.device):
        code = lib.tricubic_displace_many_f32(
            fields.data_ptr(), disp.data_ptr(), out.data_ptr(), c, n1, n2, n3,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "tricubic_displace_many_f32")
    LAUNCHES["tricubic_displace_many"] += 1
    return out


def tricubic_displace_cuda(field: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Single-field displace: ``field`` (N1,N2,N3) f32 at x + ``disp`` (3, N..)."""
    if field.ndim != 3:
        raise ValueError(f"field must be (N1, N2, N3), got shape {tuple(field.shape)}")
    _, n1, n2, n3 = _check_fields(field.unsqueeze(0))
    _check("disp", disp, torch.float32, (3, n1, n2, n3), field.device)
    lib = build.library()
    out = torch.empty_like(field)
    with torch.cuda.device(field.device):
        code = lib.tricubic_displace_f32(
            field.data_ptr(), disp.data_ptr(), out.data_ptr(), n1, n2, n3,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "tricubic_displace_f32")
    LAUNCHES["tricubic_displace"] += 1
    return out
