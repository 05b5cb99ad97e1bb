"""Periodic Cartesian grid on Omega = [0, 2pi)^3 (paper §II, §III-B1).

Scalars have shape ``(N1, N2, N3)``; vector fields are stored
component-major as ``(3, N1, N2, N3)``; a cohort of S subjects stacks them
as ``(S, N..)`` and ``(S, 3, N..)``.  Counterpart of
``repro/core/grid.py``; the wavenumber helpers stay in numpy so both
packages build their k-space multipliers from the same integers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of the spatial grid."""

    shape: tuple[int, int, int]
    dtype: torch.dtype = torch.float32

    @property
    def num_points(self) -> int:
        n1, n2, n3 = self.shape
        return n1 * n2 * n3

    @property
    def spacing(self) -> tuple[float, float, float]:
        return tuple(TWO_PI / ni for ni in self.shape)

    @property
    def cell_volume(self) -> float:
        """Quadrature weight h1*h2*h3 for L2 inner products."""
        h1, h2, h3 = self.spacing
        return h1 * h2 * h3

    def coords(self, device, dtype=None) -> torch.Tensor:
        """Physical coordinates x_i = 2*pi*i/N, shape (3, N1, N2, N3), built
        in float64 on ``device`` and cast to ``dtype`` (default: the grid's)."""
        axes = [
            torch.arange(ni, dtype=torch.float64, device=device) * (TWO_PI / ni)
            for ni in self.shape
        ]
        x = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)
        return x.to(self.dtype if dtype is None else dtype)

    # --- wavenumbers (integer modes; spectral derivative is i*k) ---------
    def wavenumbers(self, axis: int) -> np.ndarray:
        n = self.shape[axis]
        return np.fft.fftfreq(n, d=1.0 / n)

    def wavenumbers_rfft(self) -> np.ndarray:
        n = self.shape[2]
        return np.fft.rfftfreq(n, d=1.0 / n)

    def k_grids(self, rfft_last: bool = True) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Broadcastable integer wavenumber grids (k1, k2, k3)."""
        k1 = self.wavenumbers(0).reshape(-1, 1, 1)
        k2 = self.wavenumbers(1).reshape(1, -1, 1)
        k3 = (self.wavenumbers_rfft() if rfft_last else self.wavenumbers(2)).reshape(1, 1, -1)
        return k1, k2, k3

    def k_deriv(self, rfft_last: bool = True) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wavenumbers for odd-order derivatives: Nyquist mode zeroed."""
        out = []
        for axis, k in enumerate(self.k_grids(rfft_last)):
            n = self.shape[axis]
            if n % 2 == 0:
                k = np.where(np.abs(k) == n // 2, 0.0, k)
            out.append(k)
        return tuple(out)

    def inner(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Weighted L2 inner product <a, b> = h^3 * sum(a*b), at least f32."""
        acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
        return torch.sum(a.to(acc) * b.to(acc)) * self.cell_volume

    def norm_sq(self, a: torch.Tensor) -> torch.Tensor:
        return self.inner(a, a)

    def inner_per(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per-subject inner product of cohort stacks ``a``, ``b`` (S, ...):
        every axis but the first reduced, at least f32.  Returns (S,)."""
        acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
        prod = (a.to(acc) * b.to(acc)).reshape(a.shape[0], -1)
        return torch.sum(prod, dim=1) * self.cell_volume

    def norm_sq_per(self, a: torch.Tensor) -> torch.Tensor:
        return self.inner_per(a, a)


def make_grid(n, dtype=torch.float32) -> Grid:
    if isinstance(n, int):
        n = (n, n, n)
    return Grid(shape=tuple(int(x) for x in n), dtype=dtype)
