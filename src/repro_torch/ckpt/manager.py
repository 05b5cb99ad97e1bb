"""Fault-tolerant checkpoints: atomic, keep-k, async, verified; counterpart
of ``repro/ckpt/manager.py`` for trees of torch tensors and numpy arrays.

* **Atomic**: a save writes ``<dir>/tmp.<step>.<pid>`` and renames it to
  ``step_<n>`` with ``os.replace``, so a crash mid-save never corrupts the
  latest checkpoint; saving a step that exists replaces it.
* **Keep-k**: older steps are removed after a successful save.
* **Async**: ``save(..., blocking=False)`` copies every leaf to the host
  when it is called and writes on a daemon thread.  Saves serialize on a
  lock, and ``close()`` (or the context manager) joins the writer.
* **Verified**: each leaf's CRC-32 is stored in ``meta.json`` and checked
  on ``restore``; a corrupt newest step falls back to the newest intact
  one (``ckpt.corrupt_step`` and a ``RecoveryEvent(action="ckpt_fallback")``).
  A step written without checksums loads unverified.

The layout is the reference's, ``step_<n>/arrays.npz`` and ``meta.json``,
except for the tree structure: the reference pickles a JAX treedef, the
port writes ``tree.json``, the nested dicts, lists and tuples with each
leaf's index and kind.  The two packages' checkpoints are therefore not
interchangeable (ROADMAP Queue C).  Torch leaves come back as tensors on
``restore``'s ``device``, numpy leaves as numpy arrays.  The elastic
re-shard (``restore(mesh=..., specs=...)``) is ROADMAP Queue A item 13.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.device import resolve_device

ARRAYS, META, TREE = "arrays.npz", "meta.json", "tree.json"


class CheckpointCorrupt(RuntimeError):
    """A step directory failed checksum verification or did not load."""


def _leaf_crc(a: np.ndarray) -> int:
    """CRC-32 of the leaf's bytes in C order."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _flatten(tree, leaves: list):
    """(structure, leaves): the JSON structure of ``tree``, whose leaves
    (torch tensors copied to host, numpy arrays) are appended to ``leaves``."""
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError(f"checkpoint dict keys must be str, got {list(tree)}")
        return {"dict": {k: _flatten(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, torch.Tensor):
        # a copy even of a CPU tensor: the caller may change it in place
        # while an async save writes
        leaves.append(tree.detach().to("cpu", copy=True).numpy())
        return {"leaf": len(leaves) - 1, "kind": "torch"}
    if isinstance(tree, np.ndarray):
        leaves.append(np.array(tree))
        return {"leaf": len(leaves) - 1, "kind": "numpy"}
    raise TypeError(f"checkpoint leaves are torch tensors or numpy arrays, got {type(tree)}")


def _unflatten(struct, leaves: list, device):
    if "dict" in struct:
        return {k: _unflatten(v, leaves, device) for k, v in struct["dict"].items()}
    if "list" in struct:
        return [_unflatten(v, leaves, device) for v in struct["list"]]
    if "tuple" in struct:
        return tuple(_unflatten(v, leaves, device) for v in struct["tuple"])
    a = leaves[struct["leaf"]]
    return torch.from_numpy(a).to(device) if struct["kind"] == "torch" else a


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ #
    def _step_dirs(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        return sorted(out)

    def latest_step(self) -> int | None:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def wait(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()

    def close(self) -> None:
        """Join any in-flight async writer.  Idempotent."""
        self.wait()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, metadata: dict | None = None, blocking: bool = True):
        """Save ``tree`` (nested dicts, lists and tuples of torch tensors and
        numpy arrays) as ``step``.  Every leaf is copied to the host before
        this returns; ``blocking=False`` writes the files on a thread."""
        with self._lock:
            self.wait()
            leaves: list = []
            struct = _flatten(tree, leaves)

            def _write():
                tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, ARRAYS), *leaves)
                with open(os.path.join(tmp, TREE), "w") as f:
                    json.dump(struct, f)
                meta = {"step": step, "time": time.time(),
                        "checksums": [_leaf_crc(a) for a in leaves], **(metadata or {})}
                with open(os.path.join(tmp, META), "w") as f:
                    json.dump(meta, f)
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(final):  # a step saved again replaces it
                    os.replace(final, final + ".old")
                os.replace(tmp, final)
                self._gc()

            if blocking:
                _write()
            else:
                self._thread = threading.Thread(target=_write, daemon=True)
                self._thread.start()

    def _gc(self) -> None:
        dirs = self._step_dirs()
        for _, path in dirs[: -self.keep] if self.keep else []:
            shutil.rmtree(path, ignore_errors=True)
        for name in os.listdir(self.dir):
            if name.endswith(".old"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def _load_step(self, step: int, device):
        """Load and verify one step directory; raises CheckpointCorrupt."""
        path = os.path.join(self.dir, f"step_{step}")
        try:
            with np.load(os.path.join(path, ARRAYS)) as data:
                leaves = [data[f"arr_{i}"] for i in range(len(data.files))]
            with open(os.path.join(path, TREE)) as f:
                struct = json.load(f)
            with open(os.path.join(path, META)) as f:
                meta = json.load(f)
        except Exception as e:  # an unreadable npz or JSON is corruption
            raise CheckpointCorrupt(f"step_{step}: unreadable ({e})") from e
        sums = meta.get("checksums")
        if sums is not None:  # steps written without checksums load unverified
            if len(sums) != len(leaves):
                raise CheckpointCorrupt(
                    f"step_{step}: {len(leaves)} leaves vs {len(sums)} checksums")
            for i, (a, want) in enumerate(zip(leaves, sums)):
                got = _leaf_crc(a)
                if got != want:
                    raise CheckpointCorrupt(
                        f"step_{step}: leaf {i} crc32 {got:#010x} != {want:#010x}")
        return _unflatten(struct, leaves, device), meta

    def restore(self, step: int | None = None, mesh=None, specs=None, device="cuda"):
        """Returns ``(tree, meta)``, torch leaves on ``device``.

        An explicit ``step`` is verified and raises ``CheckpointCorrupt`` on
        a mismatch.  With ``step=None`` the newest step is tried first, and
        a corrupt one falls back to the next-newest intact step, each skip
        counted (``ckpt.corrupt_step``) and emitted as a ``RecoveryEvent``.
        ``(None, None)`` when the directory holds no checkpoint; every step
        corrupt raises.
        """
        if mesh is not None or specs is not None:
            raise NotImplementedError(
                "CheckpointManager.restore(mesh=..., specs=...), the elastic re-shard, "
                "is not ported (ROADMAP Queue A item 13)"
            )
        device = resolve_device(device)
        self.wait()
        if step is not None:
            return self._load_step(step, device)
        dirs = self._step_dirs()
        if not dirs:
            return None, None
        errors = []
        for st, _path in reversed(dirs):
            try:
                return self._load_step(st, device)
            except CheckpointCorrupt as e:
                errors.append(str(e))
                telemetry.counter("ckpt.corrupt_step")
                telemetry.emit(telemetry.RecoveryEvent(action="ckpt_fallback", step=st,
                                                       attrs={"error": str(e)}))
        raise CheckpointCorrupt("every checkpoint failed verification: " + "; ".join(errors))
