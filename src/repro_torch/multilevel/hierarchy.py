"""The level ladder: ``GridHierarchy`` + ``MultilevelConfig``; counterpart
of ``repro/multilevel/hierarchy.py``.

A hierarchy is an ordered coarse-to-fine tuple of ``Grid``s whose finest
entry is the problem grid (e.g. 64^3 -> 128^3 -> 256^3).  Each level gets
its own ``SpectralOps`` and a ``GNConfig`` assembled from the base solver
config plus per-level overrides; the beta-continuation schedule is spread
across the ladder so coarse levels absorb the large-beta warm-up solves and
the finest level runs the target beta.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import gauss_newton as gn
from repro_torch.core.grid import Grid, make_grid


@dataclasses.dataclass(frozen=True)
class MultilevelConfig:
    """Coarse-to-fine continuation settings (wraps a base ``GNConfig``);
    the fields and defaults are the reference's."""

    solver: gn.GNConfig = dataclasses.field(default_factory=gn.GNConfig)
    n_levels: int = 2  # used when shapes is None: halve per level
    min_size: int = 8  # don't auto-coarsen below this many points per axis
    shapes: tuple | None = None  # explicit coarse->fine ladder; last == fine grid
    presmooth: bool = True  # Gaussian at each level's bandwidth before restriction
    level_overrides: tuple = ()  # coarse->fine dicts of GNConfig field replacements
    # "none" | "two_level" (one coarse level) | "vcycle" (recursive cycle over
    # every coarser ladder level, Galerkin-consistent coarse Hessians);
    # applied at every warm-started level
    precond: str = "none"
    two_level_precond: bool = False  # alias for precond="two_level"
    precond_cg_iters: int = 4  # inner CG iterations per intermediate level
    precond_coarse_cg_iters: int = 10  # (near-)exact coarsest-level CG solve
    precond_min_size: int = 8  # V-cycle recursion floor (points per axis)
    # None resolves per scheme: "vcycle" restricts the Hessian's state fields
    # (Galerkin), "two_level" re-linearizes on restricted images
    galerkin_coarse: bool | None = None

    def __post_init__(self):
        if self.precond not in ("none", "two_level", "vcycle"):
            raise ValueError(
                f"unknown precond {self.precond!r}: choose 'none', 'two_level', "
                "or 'vcycle'"
            )

    @property
    def precond_kind(self) -> str:
        if self.precond == "none" and self.two_level_precond:
            return "two_level"
        return self.precond

    @property
    def galerkin_resolved(self) -> bool:
        if self.galerkin_coarse is None:
            return self.precond_kind == "vcycle"
        return self.galerkin_coarse


def _halved(shape: tuple[int, int, int], levels: int, min_size: int):
    ladder = [tuple(shape)]
    for _ in range(levels - 1):
        cand = tuple(n // 2 for n in ladder[-1])
        if min(cand) < min_size or any(n % 2 for n in ladder[-1]):
            break
        ladder.append(cand)
    return tuple(reversed(ladder))


class GridHierarchy:
    """Ordered coarse-to-fine grids with per-level solver configs."""

    def __init__(self, fine_grid: Grid, cfg: MultilevelConfig):
        if cfg.shapes is not None:
            shapes = tuple(tuple(int(x) for x in s) for s in cfg.shapes)
            if shapes[-1] != fine_grid.shape:
                raise ValueError(f"finest ladder entry {shapes[-1]} != grid {fine_grid.shape}")
        else:
            shapes = _halved(fine_grid.shape, cfg.n_levels, cfg.min_size)
        for lo, hi in zip(shapes, shapes[1:]):
            if any(a > b for a, b in zip(lo, hi)):
                raise ValueError(f"ladder not coarse-to-fine: {lo} -> {hi}")
        self.cfg = cfg
        self.grids = tuple(
            fine_grid if s == fine_grid.shape else make_grid(s, fine_grid.dtype)
            for s in shapes
        )
        self.betas = split_beta_schedule(
            tuple(cfg.solver.beta_continuation) + (cfg.solver.beta,), len(self.grids)
        )

    def __len__(self) -> int:
        return len(self.grids)

    @property
    def fine(self) -> Grid:
        return self.grids[-1]

    def level_config(self, level: int) -> gn.GNConfig:
        """Base GNConfig + this level's beta chunk + explicit overrides."""
        chunk = self.betas[level]
        cfg = dataclasses.replace(
            self.cfg.solver, beta=chunk[-1], beta_continuation=tuple(chunk[:-1])
        )
        overrides = (
            self.cfg.level_overrides[level] if level < len(self.cfg.level_overrides) else None
        )
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    def fine_equiv_weight(self, level: int) -> float:
        """Cost of this level's Hessian matvec in fine-grid-matvec units."""
        return self.grids[level].num_points / self.fine.num_points


def split_beta_schedule(schedule: tuple[float, ...], n_levels: int) -> tuple[tuple[float, ...], ...]:
    """Spread a beta-continuation schedule over the level ladder.

    Contiguous chunks, coarse levels first; when the schedule is shorter
    than the ladder, coarse levels repeat the leading (largest) beta so
    every level still runs a solve.  The finest level always ends on the
    target beta (the schedule's last entry).
    """
    schedule = tuple(float(b) for b in schedule)
    if n_levels <= 1:
        return (schedule,)
    if len(schedule) < n_levels:
        schedule = (schedule[0],) * (n_levels - len(schedule)) + schedule
    base, extra = divmod(len(schedule), n_levels)
    chunks, pos = [], 0
    for lv in range(n_levels):
        size = base + (1 if lv >= n_levels - extra else 0)
        chunks.append(schedule[pos : pos + size])
        pos += size
    return tuple(chunks)
