"""repro_torch.multilevel: coarse-to-fine grid continuation for the
Gauss-Newton-Krylov solver (counterpart of ``repro.multilevel``).

    transfer.py   spectral restriction/prolongation between Grids
    hierarchy.py  GridHierarchy / MultilevelConfig (the level ladder)
    driver.py     multilevel.solve(): restrict -> solve -> prolong warm start
    precond.py    the V-cycle with Galerkin-consistent coarse Hessians, and
                  the two-level scheme
"""
from repro_torch.multilevel.driver import solve
from repro_torch.multilevel.hierarchy import GridHierarchy, MultilevelConfig
from repro_torch.multilevel.precond import (
    make_two_level_precond,
    make_vcycle_precond,
    restrict_state,
)
from repro_torch.multilevel.transfer import prolong, restrict

__all__ = [
    "solve",
    "GridHierarchy",
    "MultilevelConfig",
    "make_two_level_precond",
    "make_vcycle_precond",
    "restrict_state",
    "prolong",
    "restrict",
]
