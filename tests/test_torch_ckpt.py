"""The port's checkpoint manager (``repro_torch.ckpt.manager``) on trees of
torch tensors and numpy arrays: the reference's cases
(``tests/test_ckpt.py``) of atomicity, keep-k, async saves, checksums and
the fallback over corrupt steps, plus the port's own: the tree structure
in ``tree.json`` (no pickle), the caller's device on restore, and a
bit-exact resume of a cohort server from its snapshot.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.ckpt.manager import CheckpointCorrupt, CheckpointManager
from repro_torch.core import gauss_newton as gn
from repro_torch.core.grid import make_grid
from repro_torch.launch.reg_serve import CohortServer, RegJob

CPU = dict(device="cpu")


def _tree(rng):
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        "b": {"c": torch.arange(7), "d": torch.from_numpy(rng.standard_normal(3).astype(np.float32))},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def test_roundtrip(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree(rng)
    mgr.save(5, tree, metadata={"note": "x"})
    out, meta = mgr.restore(**CPU)
    assert meta["step"] == 5 and meta["note"] == "x"
    _assert_same(tree, out)


def test_mixed_tree_keeps_structure_and_kinds(tmp_path, rng):
    """Nested dicts, lists and tuples; torch leaves come back as tensors on
    the device asked for, numpy leaves as numpy arrays; the structure is
    JSON, and no file of the step is a pickle."""
    tree = {"t": (torch.ones(2, dtype=torch.int32), np.arange(3.0)),
            "l": [torch.tensor(1.5), {"z": np.zeros((2, 2), bool)}], "e": []}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    out, _ = mgr.restore(1, **CPU)
    assert isinstance(out["t"], tuple) and isinstance(out["l"], list) and out["e"] == []
    _assert_same(tree, out)
    step = tmp_path / "step_1"
    assert sorted(os.listdir(step)) == ["arrays.npz", "meta.json", "tree.json"]
    json.load(open(step / "tree.json"))


def test_restore_goes_to_the_callers_device(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(rng))
    if torch.cuda.is_available():
        out, _ = mgr.restore()
        assert out["a"].device.type == "cuda"
    else:  # no quiet landing on the CPU: the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            mgr.restore()
    out, _ = mgr.restore(**CPU)
    assert out["a"].device.type == "cpu"


def test_unsupported_leaves_and_keys_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="leaves"):
        mgr.save(1, {"x": 3})
    with pytest.raises(TypeError, match="keys"):
        mgr.save(1, {1: torch.zeros(1)})


def test_keep_k_gc(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(rng))
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree(rng)
    mgr.save(1, tree, blocking=False)
    mgr.wait()
    out, _ = mgr.restore(1, **CPU)
    assert torch.equal(out["a"], tree["a"])


def test_async_save_copies_to_host_at_call(tmp_path, monkeypatch):
    """``save`` takes its copy of every leaf before it returns: a later
    in-place change of the tensor does not reach the checkpoint, even when
    the writer runs after it (here held back until the change is made)."""
    import threading

    from repro_torch.ckpt import manager

    changed = threading.Event()
    savez = np.savez

    def late_savez(*args, **kwargs):
        assert changed.wait(timeout=30)
        return savez(*args, **kwargs)

    monkeypatch.setattr(manager.np, "savez", late_savez)
    mgr = CheckpointManager(str(tmp_path))
    x = torch.zeros(1000)
    mgr.save(1, {"x": x}, blocking=False)
    x.fill_(7.0)
    changed.set()
    mgr.close()
    out, _ = mgr.restore(1, **CPU)
    assert torch.equal(out["x"], torch.zeros(1000))


def test_elastic_restore_is_refused(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(rng))
    with pytest.raises(NotImplementedError, match="item 13"):
        mgr.restore(1, mesh=object(), specs={"a": None}, **CPU)


def test_close_joins_async_writer(tmp_path, rng):
    tree = _tree(rng)
    with CheckpointManager(str(tmp_path), keep=3) as mgr:
        mgr.save(1, tree, blocking=False)
    assert mgr.latest_step() == 1
    out, _ = CheckpointManager(str(tmp_path)).restore(**CPU)
    assert torch.equal(out["a"], tree["a"])
    mgr.close()  # idempotent


def test_overlapping_async_saves_serialize(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    trees = {s: _tree(rng) for s in range(1, 6)}
    for s, tree in trees.items():
        mgr.save(s, tree, blocking=False)
    mgr.close()
    for s, tree in trees.items():
        out, meta = mgr.restore(s, **CPU)
        assert meta["step"] == s
        _assert_same(tree, out)


def _corrupt_step(tmp_path, step):
    """Flip bytes inside the npz payload of a step directory."""
    path = os.path.join(str(tmp_path), f"step_{step}", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef\xde\xad\xbe\xef")


def test_checksum_detects_corruption(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    mgr.save(1, _tree(rng))
    meta = json.load(open(os.path.join(str(tmp_path), "step_1", "meta.json")))
    assert "checksums" in meta and len(meta["checksums"]) == 3
    _corrupt_step(tmp_path, 1)
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(1, **CPU)


def test_checksums_are_crc32_of_the_leaf_bytes(tmp_path, rng):
    import zlib

    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    meta = json.load(open(tmp_path / "step_1" / "meta.json"))
    want = [zlib.crc32(x.numpy().tobytes()) for x in _leaves(tree)]
    assert meta["checksums"] == want


def test_restore_falls_back_over_corrupt_steps(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    trees = {s: _tree(rng) for s in (1, 2, 3)}
    for s, tree in trees.items():
        mgr.save(s, tree)
    _corrupt_step(tmp_path, 3)
    before = telemetry.counters().get("ckpt.corrupt_step", 0)
    with telemetry.ListSink() as sink:
        out, meta = mgr.restore(**CPU)
    assert meta["step"] == 2
    _assert_same(trees[2], out)
    assert telemetry.counters().get("ckpt.corrupt_step", 0) == before + 1
    recov = [r for r in sink.records if r["kind"] == "recovery"]
    assert recov and recov[0]["action"] == "ckpt_fallback" and recov[0]["step"] == 3
    _corrupt_step(tmp_path, 1)
    _corrupt_step(tmp_path, 2)
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(**CPU)


def test_restore_of_an_empty_directory(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore(**CPU) == (None, None)


def test_pre_checksum_checkpoints_load_unverified(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    tree = _tree(rng)
    mgr.save(1, tree)
    meta_path = os.path.join(str(tmp_path), "step_1", "meta.json")
    meta = json.load(open(meta_path))
    del meta["checksums"]
    json.dump(meta, open(meta_path, "w"))
    out, _ = mgr.restore(**CPU)
    assert torch.equal(out["a"], tree["a"])


def test_same_step_overwrite(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(2, {"x": torch.zeros(3)})
    tree = {"x": torch.arange(3.0)}
    mgr.save(2, tree)
    out, _ = mgr.restore(2, **CPU)
    assert torch.equal(out["x"], tree["x"])
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".old") or d.startswith("tmp.")]


def test_bit_exact_server_resume(tmp_path):
    """Serve 2 steps, snapshot, restore into a new server, serve on: every
    job's velocity and billing equal those of the uninterrupted server."""
    from repro.data.synthetic import synthetic_problem

    cfg = gn.GNConfig(beta=1e-2, n_t=2, max_newton=6, gtol=1e-2, max_cg=20)
    grid = make_grid(8)
    probs = [synthetic_problem(8, n_t=2, amplitude=a) for a in (0.3, 0.8, 1.2)]

    def jobs():
        return [RegJob(job_id=f"j{s}", rho_R=torch.from_numpy(np.array(p[0])),
                       rho_T=torch.from_numpy(np.array(p[1])),
                       v0=torch.full((3, 8, 8, 8), 0.01) if s == 2 else None,
                       g0_ref=0.5 if s == 1 else None, block=(s, 0))
                for s, p in enumerate(probs)]

    straight = CohortServer(grid, cfg, slots=2, **CPU)
    straight.admit(*jobs())
    want = {r.job_id: r for r in straight.run()}

    first = CohortServer(grid, cfg, slots=2, **CPU)
    first.admit(*jobs())
    done = first.step() + first.step()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, *first.snapshot())
    tree, meta = mgr.restore(2, **CPU)
    second = CohortServer.restore(grid, cfg, tree, meta, **CPU)
    assert second.iterations == 2 and len(second.queue) == len(first.queue)
    got = {r.job_id: r for r in done + second.run()}
    assert set(got) == set(want)
    for jid, r in want.items():
        assert torch.equal(got[jid].v, r.v), jid
        assert (got[jid].newton_iters, got[jid].hessian_matvecs, got[jid].status,
                got[jid].rel_gnorm) == (r.newton_iters, r.hessian_matvecs, r.status,
                                        r.rel_gnorm), jid
