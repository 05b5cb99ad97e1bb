"""Spectral restriction/prolongation between periodic grids; counterpart of
``repro/multilevel/transfer.py`` on one device.

Grid transfer on the spectral discretization is exact Fourier mode
selection: restriction truncates the fine spectrum to the coarse grid's
modes, prolongation zero-pads the coarse spectrum into the fine layout.
With the grids' cell-volume inner products the two are exact adjoints, and
``restrict(prolong(g)) == g`` for every coarse field with no Nyquist
content (both drop the coarse Nyquist plane, see
``core.spectral.nyquist_mask``).

A coarse mode set is two contiguous runs per axis (positive head, negative
tail), so both directions are slices and ``torch.cat`` on the rfft layout
of ``LocalFFT``.  The pencil layout and its sharding hints
(``constrain_k``) belong to the distributed slice (ROADMAP Queue A item
13).  Leading batch axes (vector components, time series) pass through.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spectral import SpectralOps, nyquist_mask

_DIMS = (-3, -2, -1)


def _head_tail(n_fine: int, n_coarse: int, rfft: bool) -> tuple[int, int]:
    """Lengths of the two contiguous mode runs of a coarse axis inside a
    fine axis (positive head, negative tail; tail = 0 for rfft axes)."""
    if rfft:
        return n_coarse // 2 + 1, 0
    return n_coarse - n_coarse // 2, n_coarse // 2


def _scale_masked(spec: torch.Tensor, fine, coarse, scale: float) -> torch.Tensor:
    """``spec`` (coarse layout) times ``nyquist_mask * scale``: a scaled copy
    with the masked planes zeroed, so no mask array is built or copied."""
    out = spec * scale
    for a, axis in enumerate(_DIMS):
        for i in np.flatnonzero(nyquist_mask(fine[a], coarse[a], rfft=a == 2) == 0.0):
            out.select(axis, int(i)).zero_()
    return out


def _truncate_axis(spec, axis: int, n_fine: int, n_coarse: int, rfft: bool):
    if n_coarse == n_fine:
        return spec
    n_pos, n_neg = _head_tail(n_fine, n_coarse, rfft)
    head = spec.narrow(axis, 0, n_pos)
    if n_neg == 0:
        return head
    return torch.cat([head, spec.narrow(axis, n_fine - n_neg, n_neg)], dim=axis)


def _pad_axis(spec, axis: int, n_fine: int, n_coarse: int, rfft: bool):
    if n_coarse == n_fine:
        return spec
    n_pos, n_neg = _head_tail(n_fine, n_coarse, rfft)
    size_f = n_fine // 2 + 1 if rfft else n_fine
    gap = list(spec.shape)
    gap[axis] = size_f - n_pos - n_neg
    parts = [spec.narrow(axis, 0, n_pos), spec.new_zeros(gap)]
    if n_neg:
        parts.append(spec.narrow(axis, n_pos, n_neg))
    return torch.cat(parts, dim=axis)


def restrict_spec(spec: torch.Tensor, fine_ops: SpectralOps, coarse_ops: SpectralOps):
    """Truncate a fine-layout spectrum to the coarse layout (mask and the
    restriction normalization applied): ``restrict = coarse.inv o this o
    fine.fwd``."""
    fine, coarse = fine_ops.grid.shape, coarse_ops.grid.shape
    for a, axis in enumerate(_DIMS):
        spec = _truncate_axis(spec, axis, fine[a], coarse[a], a == 2)
    scale = coarse_ops.grid.num_points / fine_ops.grid.num_points
    return _scale_masked(spec, fine, coarse, scale)


def pad_spec(spec: torch.Tensor, coarse_ops: SpectralOps, fine_ops: SpectralOps):
    """Zero-pad a coarse-layout spectrum into the fine layout (mask and the
    prolongation normalization applied): ``prolong = fine.inv o this o
    coarse.fwd``."""
    fine, coarse = fine_ops.grid.shape, coarse_ops.grid.shape
    scale = fine_ops.grid.num_points / coarse_ops.grid.num_points
    spec = _scale_masked(spec, fine, coarse, scale)
    for a, axis in enumerate(_DIMS):
        spec = _pad_axis(spec, axis, fine[a], coarse[a], a == 2)
    return spec


def restrict(f: torch.Tensor, fine_ops: SpectralOps, coarse_ops: SpectralOps) -> torch.Tensor:
    """Sample ``f``'s band-limited interpolant on the coarse grid.

    ``f``: (..., N1, N2, N3) on ``fine_ops.grid``; returns (..., M1, M2, M3).
    """
    return coarse_ops.fft.inv(restrict_spec(fine_ops.fft.fwd(f), fine_ops, coarse_ops))


def prolong(g: torch.Tensor, coarse_ops: SpectralOps, fine_ops: SpectralOps) -> torch.Tensor:
    """Band-limited interpolation of a coarse field onto the fine grid.

    ``g``: (..., M1, M2, M3) on ``coarse_ops.grid``; returns (..., N1, N2, N3).
    """
    return fine_ops.fft.inv(pad_spec(coarse_ops.fft.fwd(g), coarse_ops, fine_ops))


def smooth_restrict(f: torch.Tensor, fine_ops: SpectralOps, coarse_ops: SpectralOps):
    """Gaussian pre-smoothing at one coarse cell width, then restrict: the
    Gaussian multiplier rides the restriction's own forward transform."""
    spec = fine_ops.fft.fwd(f) * fine_ops._smooth_scale(coarse_ops.grid.spacing)
    return coarse_ops.fft.inv(restrict_spec(spec, fine_ops, coarse_ops))
