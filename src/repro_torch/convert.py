"""Carry state across from the reference package.

The registration has no weights: what crosses over is images, a warm-start
velocity, ``InterpPlan`` arrays and configs.  Arrays come in as numpy
arrays and configs as ``dataclasses.asdict`` of the reference's config
objects, so this module never imports the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gauss_newton import GNConfig
from repro_torch.core.registration import RegistrationConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import InterpPlan
from repro_torch.multilevel.hierarchy import MultilevelConfig

# reference interp methods and their counterparts here: "pallas" named the
# TPU kernel, whose counterpart is the CUDA kernel
_INTERP_METHODS = {"ref": "ref", "auto": "auto", "pallas": "cuda"}


def field_from_numpy(a, device="cuda") -> torch.Tensor:
    """A float32 field (any shape) on ``device``."""
    return torch.as_tensor(np.array(a, np.float32), device=resolve_device(device))


def plan_from_numpy(ib, w, halo_need, device="cuda") -> InterpPlan:
    """The port's ``InterpPlan`` from the reference plan's arrays."""
    dev = resolve_device(device)
    return InterpPlan(
        ib=torch.as_tensor(np.array(ib, np.int32), device=dev),
        w=torch.as_tensor(np.array(w, np.float32), device=dev),
        halo_need=torch.as_tensor(np.array(halo_need, np.float32), device=dev),
    )


def gn_config_from_dict(d: dict) -> GNConfig:
    """``GNConfig`` from ``dataclasses.asdict`` of the reference's ``GNConfig``.

    ``fused_elliptic`` is a no-op in the reference and is dropped; the
    reference's ``interp_method`` maps onto the port's methods.
    """
    d = dict(d)
    d.pop("fused_elliptic", None)
    d["beta_continuation"] = tuple(d.get("beta_continuation", ()))
    if "interp_method" in d:
        d["interp_method"] = _INTERP_METHODS[d["interp_method"]]
    return GNConfig(**d)


def multilevel_config_from_dict(d: dict) -> MultilevelConfig:
    """``MultilevelConfig`` from ``dataclasses.asdict`` of the reference's;
    an ``interp_method`` in ``level_overrides`` maps as in ``solver``."""
    d = dict(d)
    d["solver"] = gn_config_from_dict(d.get("solver", {}))
    overrides = []
    for o in d.get("level_overrides", ()):
        o = dict(o)
        if "interp_method" in o:
            o["interp_method"] = _INTERP_METHODS[o["interp_method"]]
        overrides.append(o)
    d["level_overrides"] = tuple(overrides)
    return MultilevelConfig(**d)


def registration_config_from_dict(d: dict) -> RegistrationConfig:
    """``RegistrationConfig`` from ``dataclasses.asdict`` of the reference's."""
    d = dict(d)
    solver = gn_config_from_dict(d.pop("solver", {}))
    if d.get("multilevel") is not None:
        d["multilevel"] = multilevel_config_from_dict(d["multilevel"])
    return RegistrationConfig(solver=solver, **d)
