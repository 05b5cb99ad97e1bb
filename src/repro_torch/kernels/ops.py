"""Dispatch layer over the interpolation kernels (counterpart of
``repro/kernels/ops.py``).

``make_interp`` returns an ``Interp`` executor that implements the
solver-wide interpolation protocol::

    interp(fields, disp)             fields (..., N1,N2,N3) at x + disp
                                     (a 3-D field: the single-field kernel)
    interp.make_plan(disp)           -> InterpPlan (precomputed operators)
    interp.apply_plan(fields, plan)  planned apply

``method`` picks the implementation:

* ``"auto"`` (the default): the CUDA kernel for CUDA tensors, the plain
  version for CPU tensors.  There is no shape condition and no fallback:
  a CUDA tensor launches its kernel or the call raises.
* ``"cuda"``: the CUDA kernel; a CPU tensor raises.
* ``"ref"``: the plain PyTorch version on any device.  Tests and
  ``chip_smoke.py`` use it to hold the kernels against.

A cohort of S subjects (displacements ``(S, 3, N..)``, plans with ``ib``
``(S, 3, N..)``) puts the subject axis at -4 of the fields,
``(..., S, N1,N2,N3)``, and takes the same choice: one launch of the
planned apply or the batched displace over every subject on a card
(the kernels' subject axis), the plain cohort version on the CPU.  The
reference sends cohorts to its oracle whatever ``method`` says; the two
are equal bit for bit (ROADMAP Queue C).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.tricubic import (
    tricubic_apply_cuda,
    tricubic_displace_cuda,
    tricubic_displace_many_cuda,
)

METHODS = ("auto", "cuda", "ref")


def _use_kernel(method: str, t: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if method == "ref":
        return False
    if method == "auto":
        return t.device.type == "cuda"
    if method == "cuda":
        if t.device.type != "cuda":
            raise ValueError(f"interp method 'cuda' needs CUDA tensors, got device {t.device}")
        return True
    raise ValueError(f"unknown interp method {method!r}; expected one of {METHODS}")


def tricubic_displace(field: torch.Tensor, disp: torch.Tensor, *, method: str = "auto"):
    """``field`` (N1,N2,N3) sampled at x + ``disp`` (3, N1,N2,N3), grid units."""
    if not _use_kernel(method, field):
        return ref.tricubic_displace(field, disp)
    return tricubic_displace_cuda(field.contiguous(), disp.contiguous())


def tricubic_displace_vec(fields: torch.Tensor, disp: torch.Tensor, *, method: str = "auto"):
    """``tricubic_displace`` of each field of ``fields`` (C, N1,N2,N3) at
    x + ``disp`` (3, N1,N2,N3): on a card one launch of the single-field
    kernel over the C fields."""
    if not _use_kernel(method, fields):
        return ref.tricubic_displace_vec(fields, disp)
    return tricubic_displace_cuda(fields.contiguous(), disp.contiguous())


def tricubic_displace_many(
    fields: torch.Tensor, disp: torch.Tensor, *, method: str = "auto"
) -> torch.Tensor:
    """``fields`` (..., N1,N2,N3) at x + ``disp`` (3, N1,N2,N3), grid units;
    leading dims are channels sharing one weight construction / one launch.
    A cohort ``disp`` (S, 3, N..) pairs subject s with axis -4 of
    ``fields`` (..., S, N..)."""
    if not _use_kernel(method, fields):
        return ref.tricubic_displace_many(fields, disp)
    out = tricubic_displace_many_cuda(_channels(fields, disp.ndim == 5), disp.contiguous())
    return out.reshape(fields.shape)


def _channels(fields: torch.Tensor, cohort: bool) -> torch.Tensor:
    """``fields`` (..., N1,N2,N3) as the kernels' contiguous (C, N..), or a
    cohort's (..., S, N..) as (C, S, N..)."""
    keep = 4 if cohort else 3
    return fields.reshape((-1,) + tuple(fields.shape[-keep:])).contiguous()


class Interp:
    """Plan-aware single-device interpolation executor (see module docstring)."""

    def __init__(self, method: str = "auto"):
        if method not in METHODS:
            raise ValueError(f"unknown interp method {method!r}; expected one of {METHODS}")
        self.method = method

    def __call__(self, fields: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
        if fields.ndim == 3:
            return tricubic_displace(fields, disp, method=self.method)
        return tricubic_displace_many(fields, disp, method=self.method)

    def make_plan(self, disp: torch.Tensor) -> ref.InterpPlan:
        return ref.make_interp_plan(disp)

    def apply_plan(self, fields: torch.Tensor, plan: ref.InterpPlan) -> torch.Tensor:
        if not _use_kernel(self.method, fields):
            return ref.interp_apply(fields, plan)
        out = tricubic_apply_cuda(_channels(fields, plan.ib.ndim == 5), plan)
        return out.reshape(fields.shape)


def make_interp(method: str = "auto") -> Interp:
    """Factory for the solver's ``interp=`` slots."""
    return Interp(method=method)


def tricubic_points(field: torch.Tensor, coords: torch.Tensor, chunk: int | None = None):
    """``field`` (N1,N2,N3) at arbitrary query points ``coords`` (3, *Q),
    grid units: the plain version on any device (no kernel takes unbounded
    query points); ``chunk`` bounds the working set."""
    if chunk:
        return ref.tricubic_points_chunked(field, coords, chunk)
    return ref.tricubic_points(field, coords)


def max_displacement(disp: torch.Tensor) -> torch.Tensor:
    """max |disp| in grid units, the planner's halo requirement."""
    return torch.max(torch.abs(disp))
