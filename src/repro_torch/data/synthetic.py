"""Synthetic registration problems (paper §IV-A1) and NIREP-like brain
phantoms; counterpart of ``repro/data/synthetic.py``.

Paper's scaling-study problem:
    rho_T(x)  = (sin^2 x1 + sin^2 x2 + sin^2 x3) / 3
    v*(x)     = (cos x1 sin x2, cos x2 sin x1, cos x1 sin x3)
    rho_R     = solution of the state equation (2b) with v*.

``brain_like`` draws its blob layout from the same numpy seeds as the
reference, so both packages build the same images.  The images are
computed on ``device`` (each term in float64, added to a float32 image as
the reference's numpy does), which keeps a 256^3 phantom to seconds on the
card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import semilag
from repro_torch.core.grid import Grid, make_grid
from repro_torch.core.planner import make_plan
from repro_torch.core.spectral import SpectralOps
from repro_torch.device import resolve_device


def paper_template(grid: Grid, device="cuda") -> torch.Tensor:
    x = grid.coords(resolve_device(device))
    return (torch.sin(x[0]) ** 2 + torch.sin(x[1]) ** 2 + torch.sin(x[2]) ** 2) / 3.0


def paper_velocity(grid: Grid, amplitude: float = 1.0, device="cuda") -> torch.Tensor:
    x = grid.coords(resolve_device(device))
    return amplitude * torch.stack(
        [
            torch.cos(x[0]) * torch.sin(x[1]),
            torch.cos(x[1]) * torch.sin(x[0]),
            torch.cos(x[0]) * torch.sin(x[2]),
        ]
    )


def paper_velocity_divfree(grid: Grid, amplitude: float = 1.0, device="cuda") -> torch.Tensor:
    """div v = 0 analytically: each component independent of its own coord."""
    x = grid.coords(resolve_device(device))
    return amplitude * torch.stack(
        [
            torch.sin(x[1]) * torch.cos(x[2]),
            torch.sin(x[2]) * torch.cos(x[0]),
            torch.sin(x[0]) * torch.cos(x[1]),
        ]
    )


def synthetic_problem(
    n, n_t: int = 4, incompressible: bool = False, amplitude: float = 1.0, device="cuda"
):
    """Build (rho_R, rho_T, v_star, grid) with rho_R = forward-transported rho_T."""
    grid = make_grid(n)
    ops = SpectralOps(grid, device=device)
    rho_T = paper_template(grid, device=ops.device)
    make_v = paper_velocity_divfree if incompressible else paper_velocity
    v_star = make_v(grid, amplitude, device=ops.device)
    plan = make_plan(v_star, grid, ops, n_t, incompressible)
    rho_R = semilag.transport_state(rho_T, plan)[-1]
    return rho_R, rho_T, v_star, grid


def brain_like(n, seed: int = 0, n_blobs: int = 24, subject_jitter: float = 0.15, device="cuda"):
    """NIREP-like phantom pair: two 'individuals' built from the same blob
    layout with subject-specific jitter and a cortical shell, spectrally
    smoothed.  Returns (rho_R, rho_T, grid)."""
    grid = make_grid(n)
    ops = SpectralOps(grid, device=device)
    dev = ops.device
    rng = np.random.default_rng(seed)
    x = grid.coords(dev, torch.float64)

    centers = rng.uniform(np.pi * 0.4, np.pi * 1.6, (n_blobs, 3))
    widths = rng.uniform(0.15, 0.5, n_blobs)
    amps = rng.uniform(0.3, 1.0, n_blobs)

    def subject(jit_rng):
        img = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
        for c, w, a in zip(centers, widths, amps):
            cj = c + jit_rng.normal(0, subject_jitter, 3)
            d2 = 0.0
            for i in range(3):
                dist = torch.abs(x[i] - cj[i])
                d2 = d2 + torch.minimum(dist, 2 * np.pi - dist) ** 2
            img = (img + a * torch.exp(-d2 / (2 * w**2))).to(torch.float32)
        r = torch.sqrt(sum((x[i] - np.pi) ** 2 for i in range(3)))
        img = (img + 0.8 * torch.exp(-((r - 1.8) ** 2) / 0.08)).to(torch.float32)
        return img / img.max()

    ref = subject(np.random.default_rng(seed + 1))
    tmpl = subject(np.random.default_rng(seed + 2))
    return ops.smooth(ref), ops.smooth(tmpl), grid
