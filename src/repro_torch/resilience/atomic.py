"""Crash-safe JSON writes: unique temp file + fsync + ``os.replace``;
the port's copy of ``repro/resilience/atomic.py`` (stdlib only).

A naive ``open(path, "w")`` lets a killed process leave a torn file, and a
fixed temp name lets two writers promote each other's half-written bytes;
a rename without ``fsync`` may land before the data after a power cut.
``atomic_write_json`` writes a pid-unique temp file, fsyncs it, renames it
over ``path`` and unlinks the temp on any failure.
"""
from __future__ import annotations

import json
import os


def atomic_write_json(
    path: str,
    payload,
    *,
    indent: int | None = 2,
    sort_keys: bool = False,
    default=None,
    trailing_newline: bool = False,
) -> None:
    """Serialize ``payload`` to ``path`` so that ``path`` always holds
    either its previous contents or the complete new JSON."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=indent, sort_keys=sort_keys, default=default)
            if trailing_newline:
                fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
