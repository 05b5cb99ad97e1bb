"""Command-line options and output shared by the examples."""
from __future__ import annotations

import argparse

import numpy as np


def parser(doc: str, n: int) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=n, help="grid points per axis")
    return ap


def save_slices(path: str, out: dict, rho_R, rho_T) -> None:
    """Axial mid-slices of the reference, template, deformed template and
    det(grad y) as an ``.npz`` at ``path``."""
    mid = rho_R.shape[0] // 2
    np.savez(path, ref=np.asarray(rho_R[mid].cpu()), template=np.asarray(rho_T[mid].cpu()),
             deformed=out["rho_deformed"][mid].cpu().numpy(),
             det=out["det_grad_y"][mid].cpu().numpy())
    print(f"axial slices written to {path}")
