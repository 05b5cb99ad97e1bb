"""Plain PyTorch versions of the interpolation kernels.

Tricubic **Lagrange** interpolation on a periodic grid (paper §III-C2):
64 coefficients (4^3) per point, exact for cubic polynomials and at grid
points.  Coordinates are in grid-index units (voxel i sits at coordinate
i); periodic wrap is index arithmetic, so any displacement is exact.
Counterpart of ``repro/kernels/ref.py``.

These functions are what the CUDA kernels of ``kernels/tricubic.py`` are
held against on the card, and what ``kernels/ops.py`` runs for tensors on
the CPU:

* ``interp_apply(fields, plan)`` is the plain version of the planned apply
  (``tricubic_apply_cuda``);
* ``tricubic_displace_many(fields, disp)`` is the plain version of the
  batched displace (``tricubic_displace_many_cuda``);
* ``tricubic_displace(field, disp)`` and, for C fields,
  ``tricubic_displace_vec(fields, disp)`` are the plain versions of the
  single-field displace (``tricubic_displace_cuda``).

A *cohort* of S subjects carries its plans as ``ib (S, 3, N..)`` and
``w (S, 3, 4, N..)`` (from displacements ``(S, 3, N..)``), and its fields
with the subject axis at -4, ``(..., S, N..)``: ``interp_apply`` and
``tricubic_displace_many`` then evaluate each subject's slab with that
subject's plan, by exactly the single-subject arithmetic, so the kernels'
subject axis stays bit for bit with them.

The gathers run over chunks of ``CHUNK`` points, so that a 256^3 call keeps
its (4, 4, 4, chunk) index and value blocks to a few GiB on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# points per gather chunk: (4,4,4,CHUNK) int64 indices are 2 GiB at 2^22
CHUNK = 1 << 22
_SIXTH = 1.0 / 6.0


def lagrange_weights(t: torch.Tensor) -> torch.Tensor:
    """Cubic Lagrange weights for stencil offsets (-1, 0, 1, 2) at frac t.

    Returns shape (4, *t.shape); rows sum to 1 for any t.
    """
    t = t.to(torch.promote_types(t.dtype, torch.float32))
    # /6 is a product with the f32 reciprocal: the rounding contract at the
    # head of csrc/tricubic.cu
    w_m1 = -t * (t - 1.0) * (t - 2.0) * _SIXTH
    w_0 = (t + 1.0) * (t - 1.0) * (t - 2.0) * 0.5
    w_1 = -(t + 1.0) * t * (t - 2.0) * 0.5
    w_2 = (t + 1.0) * t * (t - 1.0) * _SIXTH
    return torch.stack([w_m1, w_0, w_1, w_2])


def _dot4(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_k v[k] * w[k]`` over the leading stencil axis of length 4, added
    in the order ``((p0 + p1) + p2) + p3``, as the rounding contract at the
    head of ``csrc/tricubic.cu`` fixes it for kernel and plain version."""
    p = v * w
    return ((p[0] + p[1]) + p[2]) + p[3]


class InterpPlan(NamedTuple):
    """Cached per-point interpolation operators for one displacement field.

    ``ib``        (3, N1, N2, N3) int32: ``floor(disp)``, the stencil base
                  offset from each point's home voxel.
    ``w``         (3, 4, N1, N2, N3) float32: separable cubic Lagrange
                  weights at the fractional part ``disp - ib``.
    ``halo_need`` () float32: ``ceil(max |disp|)``.

    A cohort plan carries ``ib (S, 3, N..)`` and ``w (S, 3, 4, N..)``, and
    ``halo_need`` is the max over the cohort.
    """

    ib: torch.Tensor
    w: torch.Tensor
    halo_need: torch.Tensor


def make_interp_plan(disp: torch.Tensor) -> InterpPlan:
    """Precompute the tricubic operators for ``disp`` (3, N1, N2, N3), or a
    cohort plan for per-subject displacements ``disp`` (S, 3, N1, N2, N3)."""
    d = disp.to(torch.promote_types(disp.dtype, torch.float32))
    ibf = torch.floor(d)
    # single (3, N..) -> (3, 4, N..); cohort (S, 3, N..) -> (S, 3, 4, N..)
    w = torch.movedim(lagrange_weights(d - ibf), 0, -4)
    return InterpPlan(
        ib=ibf.to(torch.int32),
        w=w.contiguous(),
        halo_need=torch.ceil(torch.max(torch.abs(d))),
    )


def _gather_contract(flat_fields, base, w, shape3):
    """Chunked 64-point gather + separable contraction.

    ``flat_fields`` (C, Ntot) on a periodic ``shape3`` grid; ``base`` (3, M)
    integer stencil bases (the offset -1 row sits at ``base - 1``); ``w``
    (3, 4, M) weights.  Returns (C, M).  The contraction runs over stencil
    axis 1, then axis 2, then axis 3, each sum by ``_dot4``: under the
    rounding contract of ``csrc/tricubic.cu`` the kernels reproduce these
    values bit for bit.
    """
    n1, n2, n3 = shape3
    c, m = flat_fields.shape[0], base.shape[1]
    out = torch.empty((c, m), dtype=flat_fields.dtype, device=flat_fields.device)
    offs = torch.arange(-1, 3, dtype=torch.int64, device=base.device)
    for lo in range(0, m, CHUNK):
        hi = min(lo + CHUNK, m)
        b = base[:, lo:hi].to(torch.int64)
        i1 = torch.remainder(b[0][None, :] + offs[:, None], n1)  # (4, M)
        i2 = torch.remainder(b[1][None, :] + offs[:, None], n2)
        i3 = torch.remainder(b[2][None, :] + offs[:, None], n3)
        idx = (
            i1[:, None, None, :] * (n2 * n3) + i2[None, :, None, :] * n3 + i3[None, None, :, :]
        ).reshape(-1)
        del i1, i2, i3
        w0, w1, w2 = w[0, :, lo:hi], w[1, :, lo:hi], w[2, :, lo:hi]
        for ci in range(c):
            vals = flat_fields[ci][idx].reshape(4, 4, 4, hi - lo)
            s = _dot4(vals, w0[:, None, None, :])  # (4, 4, M)
            s = _dot4(s, w1[:, None, :])  # (4, M)
            out[ci, lo:hi] = _dot4(s, w2)
    return out


def _home(shape3, device) -> torch.Tensor:
    """(3, M) int32 home voxel index of every grid point, row-major."""
    axes = [torch.arange(n, dtype=torch.int32, device=device) for n in shape3]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0).reshape(3, -1)


def interp_apply(fields: torch.Tensor, plan: InterpPlan) -> torch.Tensor:
    """Evaluate ``fields`` (..., N1,N2,N3) at the planned departure points.

    Leading dims are channels sharing one gather-index computation;
    periodic wrap by index arithmetic (valid for any displacement).  With a
    cohort plan (``ib`` (S, 3, N..)) axis -4 of ``fields`` is the subject
    axis: each subject's slab ``fields[..., s, :, :, :]`` is evaluated with
    its own plan, as a single-subject call would evaluate it.
    """
    if plan.ib.ndim == 5:
        return torch.stack(
            [interp_apply(fields[..., s, :, :, :],
                          InterpPlan(plan.ib[s], plan.w[s], plan.halo_need))
             for s in range(plan.ib.shape[0])],
            dim=-4,
        )
    shape3 = tuple(plan.ib.shape[-3:])
    lead = fields.shape[:-3]
    ff = fields.reshape(-1, shape3[0] * shape3[1] * shape3[2])
    acc = torch.promote_types(torch.promote_types(fields.dtype, plan.w.dtype), torch.float32)
    base = _home(shape3, fields.device) + plan.ib.reshape(3, -1)
    w = plan.w.reshape(3, 4, -1).to(acc)
    out = _gather_contract(ff.to(acc), base, w, shape3)
    return out.reshape(lead + shape3).to(fields.dtype)


def tricubic_displace_many(fields: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Batched semi-Lagrangian form: ``fields`` (..., N1,N2,N3) at x + disp;
    a cohort ``disp`` (S, 3, N..) pairs subject s with axis -4 of ``fields``."""
    return interp_apply(fields, make_interp_plan(disp))


def _points(fields: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Each field of ``fields`` (C, N1,N2,N3) at ``coords`` (3, *Q), grid
    units: the query points and weights are formed once for the C fields."""
    acc = torch.promote_types(torch.promote_types(fields.dtype, coords.dtype), torch.float32)
    qshape = coords.shape[1:]
    q = coords.reshape(3, -1).to(acc)
    i0 = torch.floor(q)
    w = torch.movedim(lagrange_weights(q - i0), 0, 1)  # (3, 4, M)
    flat = fields.reshape(fields.shape[0], -1).to(acc)
    out = _gather_contract(flat, i0.to(torch.int64), w, tuple(fields.shape[-3:]))
    return out.reshape(fields.shape[:1] + qshape).to(fields.dtype)


def tricubic_points(field: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Interpolate ``field`` (N1,N2,N3) at ``coords`` (3, *Q), grid units."""
    return _points(field[None], coords)[0]


def tricubic_points_chunked(field: torch.Tensor, coords: torch.Tensor,
                            chunk: int = 1 << 16) -> torch.Tensor:
    """``tricubic_points`` over chunks of ``chunk`` query points, for a
    bounded working set."""
    qshape = coords.shape[1:]
    q = coords.reshape(3, -1)
    out = torch.cat([tricubic_points(field, q[:, lo:lo + chunk])
                     for lo in range(0, q.shape[1], chunk)])
    return out.reshape(qshape)


def tricubic_displace(field: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Evaluate ``field`` (N1,N2,N3) at ``x_i + disp_i``; disp (3, N1,N2,N3)."""
    return tricubic_displace_vec(field[None], disp)[0]


def tricubic_displace_vec(fields: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """``tricubic_displace`` of each field of ``fields`` (C, N1,N2,N3) at
    x + ``disp``, with the query points formed once."""
    shape3 = tuple(fields.shape[-3:])
    ct = torch.promote_types(disp.dtype, torch.float32)
    base = _home(shape3, fields.device).to(ct).reshape((3,) + shape3)
    return _points(fields, base + disp.to(ct))


def spectral_scale(spec_re: torch.Tensor, spec_im: torch.Tensor, scale: torch.Tensor):
    """Elementwise real scale of a complex spectrum held as two real planes."""
    return spec_re * scale, spec_im * scale
