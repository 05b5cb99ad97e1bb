"""The port's examples (``python -m repro_torch.examples.<name>``) run on the
CPU at a small size, give sound registrations, and the quickstart and
incompressible ones solve as the repo's JAX examples' solver does on the
same images.  The multilevel example's ladder is the configuration
``chip_smoke.py``'s ``multilevel_path`` runs."""
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.examples import (  # noqa: E402
    brain_registration,
    incompressible_registration,
    multilevel_registration,
    quickstart,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sound(out):
    assert torch.isfinite(out["v"]).all()
    assert out["det_min"] > 0
    assert out["residual_rel"] < 1.0


def _jax_register(rho_R, rho_T, grid, solver_kw):
    from repro.core import gauss_newton as jgn
    from repro.core.registration import RegistrationConfig, register

    return register(rho_R, rho_T, RegistrationConfig(solver=jgn.GNConfig(**solver_kw)),
                    grid=grid)


def test_quickstart_runs_and_matches_jax(capsys):
    from repro.data import synthetic

    out = quickstart.main(["--device", "cpu", "--n", str(N)])
    _sound(out)
    assert "diffeomorphic" in capsys.readouterr().out
    rho_R, rho_T, _, grid = synthetic.synthetic_problem(N)
    want = _jax_register(rho_R, rho_T, grid,
                         dict(beta=1e-2, n_t=4, max_newton=20, gtol=1e-2, max_cg=50))
    assert [h["cg_iters"] for h in out["history"]] == [h["cg_iters"] for h in want["history"]]
    assert abs(out["residual_rel"] - want["residual_rel"]) < 1e-4


def test_incompressible_runs_and_matches_jax():
    from repro.data import synthetic

    out = incompressible_registration.main(["--device", "cpu", "--n", str(N)])
    _sound(out)
    assert abs(out["det_min"] - 1) < 0.2 and abs(out["det_max"] - 1) < 0.2
    rho_R, rho_T, _, grid = synthetic.synthetic_problem(N, incompressible=True, amplitude=0.5)
    want = _jax_register(rho_R, rho_T, grid,
                         dict(beta=1e-2, n_t=4, incompressible=True, max_newton=10, gtol=1e-2))
    assert [h["cg_iters"] for h in out["history"]] == [h["cg_iters"] for h in want["history"]]


def test_brain_registration_runs_and_writes_slices(tmp_path):
    path = str(tmp_path / "slices.npz")
    out = brain_registration.main(["--device", "cpu", "--n", str(N), "--out", path])
    _sound(out)
    assert [h["beta"] for h in out["history"]][0] == pytest.approx(1e-1)
    with np.load(path) as z:
        assert sorted(z.files) == ["deformed", "det", "ref", "template"]
        assert z["det"].shape == (N, N)


def test_multilevel_registration_runs():
    out = multilevel_registration.main(["--device", "cpu", "--n", "32"])
    _sound(out)
    assert len(out["levels"]) == multilevel_registration.N_LEVELS
    assert [lv["shape"][0] for lv in out["levels"]] == [8, 16, 32]
    assert out["hessian_matvecs"] > 0 and out["single"]["hessian_matvecs"] > 0


def test_chip_smoke_runs_the_multilevel_examples_config(monkeypatch):
    """chip_smoke.py's coarse-to-fine ``register()`` gets the example's
    config, with the interpolation it asks for."""
    from repro_torch.core import registration

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    seen = []
    monkeypatch.setattr(registration, "register", lambda *a, **kw: seen.append(a[2]) or {})
    for method in ("auto", "ref"):
        _, mcfg, _ = chip_smoke._register_ml(8, method, "cpu")
        assert seen[-1] == multilevel_registration.config(method)
        assert mcfg == seen[-1].multilevel
    assert multilevel_registration.config("ref").multilevel.precond == "vcycle"


def test_examples_run_as_modules():
    """``python -m repro_torch.examples.<name>`` with ``--device cpu``; the
    default device is the card, which this machine may not have."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.incompressible_registration",
         "--device", "cpu", "--n", "8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "volume preserving" in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.quickstart", "--n", "8"],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
