"""Device resolution for the port's entry points.

There is no quiet move to the CPU: asking for CUDA where PyTorch sees no
CUDA device raises.  Callers that want the CPU (the parity tests) say so
with ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
