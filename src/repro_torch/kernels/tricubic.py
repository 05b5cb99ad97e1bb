"""Wrappers of the hand-written CUDA tricubic kernels (``csrc/tricubic.cu``).

Counterpart of ``repro/kernels/tricubic.py``:

* ``tricubic_apply_cuda(fields, plan)`` replaces ``tricubic_apply_pallas``
  (body ``_kernel_planned``): the planned apply of every transport step and
  every Gauss-Newton Hessian matvec.  Plain version: ``ref.interp_apply``.
* ``tricubic_displace_many_cuda(fields, disp)`` replaces
  ``tricubic_displace_pallas_many`` (body ``_kernel_many``): the RK2
  departure solve.  Plain version: ``ref.tricubic_displace_many``.

  Both take a cohort of S subjects in one launch: fields (C, S, N..)
  against a cohort plan (``ib`` (S, 3, N..), ``w`` (S, 3, 4, N..)) or
  displacement (S, 3, N..), subject s of the fields paired with subject s
  of the plan; the TPU kernels are single-subject.
* ``tricubic_displace_cuda(field, disp)`` replaces
  ``tricubic_displace_pallas`` (body ``_kernel``): one field resampled at
  x + disp, e.g. the template through a returned deformation, or C fields
  one after another in one launch.  Plain version:
  ``ref.tricubic_displace`` (``ref.tricubic_displace_vec`` for C).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, raises
if the launch was refused, and adds one to its entry of ``LAUNCHES``.  The
choice between a kernel and its plain version is made by the caller from
the tensor's device (``kernels/ops.py``); nothing here falls back.

The three kernels work on output tiles of ``TILE`` points and stage a
tile's stencil box in shared memory when it is small enough; otherwise the
same block gathers from global memory (the design note at the head of
``csrc/tricubic.cu``).  ``staged_tiles`` is the plain model of that rule:
how many tiles a launch stages, for a given stencil base and the kernel's
box (``BOX_ROWS_OF``); ``warp_base`` is the single-field displace's base.
Inside a ``count_staged()`` block the wrappers have the kernel count the
tiles it stages, by kernel and grid shape, to hold against the model or to
show which branch a whole solve took; a cohort launch counts the tiles of
each of its subjects.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ref import InterpPlan

# the output tile of the three kernels, points along (x1, x2, x3), and the
# largest box of source voxels they stage: at most BOX_WIDTH along x3 and
# BOX_ROWS (x1, x2) rows for the planned apply and the batched displace,
# WARP_BOX_ROWS for the single-field displace.  The kTile*, kBoxWidth,
# kBoxRows and kWarpBoxRows of csrc/tricubic.cu.
TILE = (4, 8, 32)
BOX_WIDTH = 40
BOX_ROWS = 144
WARP_BOX_ROWS = 288

# launches per kernel since the last reset_launches(): a run reads these to
# show that its path went through the kernels
LAUNCHES = {"tricubic_apply": 0, "tricubic_displace_many": 0, "tricubic_displace": 0}
# the box rows of each kernel, by its key in LAUNCHES
BOX_ROWS_OF = {"tricubic_apply": BOX_ROWS, "tricubic_displace_many": BOX_ROWS,
               "tricubic_displace": WARP_BOX_ROWS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# (kernel, grid shape) -> [device staged-tile counter, tiles launched]
# while count_staged() is open, else None
_COUNTING: dict | None = None


@contextlib.contextmanager
def count_staged():
    """Count the tiles that the three kernels stage.

    Inside the block every launch of a wrapper adds its staged tiles
    to a device counter of its kernel and grid shape (one atomic add per
    staged tile), and its tiles to a host count.  Yields a dict that is filled on exit:
    ``{(name, (N1, N2, N3)): {"staged": s, "tiles": t}}``, ``name`` a key
    of ``LAUNCHES``.  Not reentrant.
    """
    global _COUNTING
    if _COUNTING is not None:
        raise RuntimeError("count_staged() is already open")
    _COUNTING, counts = {}, {}
    try:
        yield counts
    finally:
        counting, _COUNTING = _COUNTING, None
        for key, (counter, tiles) in counting.items():
            counts[key] = {"staged": int(counter.item()), "tiles": tiles}


def _path_counter(name: str, shape3: tuple, device, subjects: int = 1):
    """The device address of the ``count_staged()`` counter of ``name`` at
    ``shape3`` (made at its first launch), or None outside the block.  A
    launch over ``subjects`` subjects books that many times the tiles."""
    if _COUNTING is None:
        return None
    key = (name, shape3)
    if key not in _COUNTING:
        _COUNTING[key] = [torch.zeros(1, dtype=torch.int32, device=device), 0]
    _COUNTING[key][1] += subjects * n_tiles(shape3)
    return _COUNTING[key][0].data_ptr()


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


def _check_fields(fields: torch.Tensor, cohort: bool = False) -> tuple[int, ...]:
    """(C, N1, N2, N3) of single-subject fields, (C, S, N1, N2, N3) of a
    cohort's."""
    want = "(C, S, N1, N2, N3)" if cohort else "(C, N1, N2, N3)"
    if fields.ndim != (5 if cohort else 4):
        raise ValueError(f"fields must be {want}, got shape {tuple(fields.shape)}")
    if min(fields.shape) < 1:
        raise ValueError(f"fields shape {tuple(fields.shape)} has an empty axis")
    if math.prod(fields.shape[-3:]) >= 2**31:
        raise ValueError("grids of 2^31 points or more are not supported")
    if cohort and fields.shape[1] > 65535:  # the launch grid's y extent
        raise ValueError("cohorts of more than 65535 subjects are not supported")
    _check("fields", fields, torch.float32, fields.shape, fields.device)
    return tuple(fields.shape)


def n_tiles(shape3) -> int:
    """Output tiles of one launch of any of the three kernels."""
    return math.prod(-(-n // t) for n, t in zip(shape3, TILE))


def tile_extents(base: torch.Tensor) -> torch.Tensor:
    """(3, T1, T2, T3) int64: the voxels each output tile's stencils span per
    axis, for stencil bases ``base`` (3, N1, N2, N3).

    A point x with base b reaches the voxels ``x + b - 1 .. x + b + 2``
    (not wrapped), so a tile spans ``max(x + b) - min(x + b) + 4`` over its
    points; points beyond the grid's ragged edge do not count.
    """
    shape3 = tuple(base.shape[1:])
    tiles = [-(-n // t) for n, t in zip(shape3, TILE)]
    g = base.to(torch.int64) + ref._home(shape3, base.device).reshape((3,) + shape3)
    padded = (3,) + tuple(k * t for k, t in zip(tiles, TILE))
    box = []
    for fill, reduce in ((torch.iinfo(torch.int64).max, torch.amin),
                         (torch.iinfo(torch.int64).min, torch.amax)):
        full = torch.full(padded, fill, dtype=torch.int64, device=base.device)
        full[:, :shape3[0], :shape3[1], :shape3[2]] = g
        full = full.reshape(3, tiles[0], TILE[0], tiles[1], TILE[1], tiles[2], TILE[2])
        box.append(reduce(full, dim=(2, 4, 6)))
        del full
    return box[1] - box[0] + 4


def warp_base(disp: torch.Tensor) -> torch.Tensor:
    """(3, N1, N2, N3) int32: the single-field displace's stencil base,
    ``floor(x + disp) - x`` with ``x + disp`` formed in f32 first, as the
    kernel and ``ref.tricubic_displace`` form it.  Not ``floor(disp)``:
    the two differ where ``x + disp`` rounds up to an integer."""
    shape3 = tuple(disp.shape[1:])
    home = ref._home(shape3, disp.device).reshape((3,) + shape3)
    return torch.floor(home.to(torch.float32) + disp.to(torch.float32)).to(torch.int32) - home


def stencil_base(name: str, disp: torch.Tensor | None = None,
                 plan: InterpPlan | None = None) -> torch.Tensor:
    """The stencil base of one launch of kernel ``name`` (a key of
    ``LAUNCHES``): ``plan.ib`` for the apply, ``floor(disp)`` for the
    batched displace, ``warp_base(disp)`` for the single-field displace.
    (S, 3, N..) for a cohort launch of the apply or the batched displace."""
    if name == "tricubic_apply":
        return plan.ib
    if name == "tricubic_displace_many":
        return torch.floor(disp).to(torch.int32)
    return warp_base(disp)


def staged_tiles(base: torch.Tensor, box_rows: int = BOX_ROWS) -> int:
    """How many output tiles a kernel stages in shared memory, for stencil
    bases ``base`` (3, N1, N2, N3) (``stencil_base``).  A tile stages when
    its stencils span at most ``BOX_WIDTH`` voxels along x3 and at most
    ``box_rows`` (x1, x2) rows (``tile_extents``), the kernel's entry of
    ``BOX_ROWS_OF``.  A cohort's bases (S, 3, N1, N2, N3) count the staged
    tiles of every subject: each subject's tile stages as it would in a
    single-subject launch.
    """
    if base.ndim == 5:
        return sum(staged_tiles(b, box_rows) for b in base)
    extent = tile_extents(base)
    return int(((extent[2] <= BOX_WIDTH) & (extent[0] * extent[1] <= box_rows)).sum())


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaGetLastError() = {code}")


def tricubic_apply_cuda(fields: torch.Tensor, plan: InterpPlan) -> torch.Tensor:
    """Planned apply: ``fields`` (C, N1,N2,N3) f32 at the plan's points.

    ``plan.ib`` (3, N..) int32 and ``plan.w`` (3, 4, N..) f32, all on the
    fields' CUDA device and contiguous.  Returns (C, N1,N2,N3).  With a
    cohort plan (``ib`` (S, 3, N..), ``w`` (S, 3, 4, N..)) the fields are
    (C, S, N1,N2,N3), and so is the output.
    """
    cohort = plan.ib.ndim == 5
    shape = _check_fields(fields, cohort)
    c, s, shape3 = shape[0], shape[1] if cohort else 1, shape[-3:]
    lead = (s,) if cohort else ()
    _check("plan.ib", plan.ib, torch.int32, lead + (3,) + shape3, fields.device)
    _check("plan.w", plan.w, torch.float32, lead + (3, 4) + shape3, fields.device)
    counter = _path_counter("tricubic_apply", shape3, fields.device, s)
    lib = build.library()
    out = torch.empty_like(fields)
    with torch.cuda.device(fields.device):
        code = lib.tricubic_apply_f32(
            fields.data_ptr(), plan.ib.data_ptr(), plan.w.data_ptr(), out.data_ptr(),
            c, s, *shape3, counter, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "tricubic_apply_f32")
    LAUNCHES["tricubic_apply"] += 1
    return out


def tricubic_displace_many_cuda(fields: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Batched displace: ``fields`` (C, N1,N2,N3) f32 at x + ``disp`` (3, N..);
    a cohort's fields (C, S, N1,N2,N3) at x + its ``disp`` (S, 3, N..)."""
    cohort = disp.ndim == 5
    shape = _check_fields(fields, cohort)
    c, s, shape3 = shape[0], shape[1] if cohort else 1, shape[-3:]
    _check("disp", disp, torch.float32, ((s,) if cohort else ()) + (3,) + shape3,
           fields.device)
    counter = _path_counter("tricubic_displace_many", shape3, fields.device, s)
    lib = build.library()
    out = torch.empty_like(fields)
    with torch.cuda.device(fields.device):
        code = lib.tricubic_displace_many_f32(
            fields.data_ptr(), disp.data_ptr(), out.data_ptr(), c, s, *shape3, counter,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "tricubic_displace_many_f32")
    LAUNCHES["tricubic_displace_many"] += 1
    return out


def tricubic_displace_cuda(fields: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Single-field displace: ``fields`` (N1,N2,N3) f32 at x + ``disp``
    (3, N..); a stack (C, N1,N2,N3) takes one launch for its C fields.
    Returns the shape of ``fields``."""
    if fields.ndim not in (3, 4):
        raise ValueError(f"fields must be (N1, N2, N3) or (C, N1, N2, N3), got shape "
                         f"{tuple(fields.shape)}")
    stack = fields if fields.ndim == 4 else fields.unsqueeze(0)
    c, n1, n2, n3 = _check_fields(stack)
    _check("disp", disp, torch.float32, (3, n1, n2, n3), fields.device)
    counter = _path_counter("tricubic_displace", (n1, n2, n3), fields.device)
    lib = build.library()
    out = torch.empty_like(fields)
    with torch.cuda.device(fields.device):
        code = lib.tricubic_displace_f32(
            fields.data_ptr(), disp.data_ptr(), out.data_ptr(), c, n1, n2, n3, counter,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "tricubic_displace_f32")
    LAUNCHES["tricubic_displace"] += 1
    return out
