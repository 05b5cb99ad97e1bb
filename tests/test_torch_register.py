"""Port parity of the whole main path: ``register()`` on the paper's
synthetic problem (compressible and incompressible) and on the brain
phantom at 16^3 against ``repro.core.registration.register``, plus the
data generators, the carried configs, the health codes, the telemetry
records and ``chip_smoke.py``'s refusal to run without a card.

The bar is the one the reference holds its distributed solve to against
the local one: the same Newton count, the same ``cg_iters`` in every
iteration, ``max|v_port - v_jax| < 1e-4``; the diagnostics agree at 1e-4
relative.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import telemetry as jtelemetry  # noqa: E402
from repro.core import gauss_newton as jgn  # noqa: E402
from repro.core.registration import RegistrationConfig as JConfig  # noqa: E402
from repro.core.registration import register as jregister  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.resilience import health as jhealth  # noqa: E402
from repro_torch import convert, multilevel, telemetry  # noqa: E402
from repro_torch.core import gauss_newton as gn  # noqa: E402
from repro_torch.core.grid import make_grid  # noqa: E402
from repro_torch.core.registration import RegistrationConfig, register  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.multilevel import MultilevelConfig  # noqa: E402
from repro_torch.resilience import health  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The fields here are 16^3 at most: intra-op threads only contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_problem(name):
    if name == "brain":
        rho_R, rho_T, grid = jsyn.brain_like(N)
        return rho_R, rho_T, grid, False
    incompressible = name == "incompressible"
    rho_R, rho_T, _, grid = jsyn.synthetic_problem(N, incompressible=incompressible)
    return rho_R, rho_T, grid, incompressible


@pytest.fixture(scope="module", params=["compressible", "incompressible", "brain"])
def solved(request):
    rho_R, rho_T, grid, incompressible = _jax_problem(request.param)
    jcfg = JConfig(solver=jgn.GNConfig(incompressible=incompressible, autotune="off"))
    jout = jregister(rho_R, rho_T, jcfg, grid=grid)
    cfg = convert.registration_config_from_dict(dataclasses.asdict(jcfg))
    with telemetry.ListSink() as sink:
        out = register(
            convert.field_from_numpy(rho_R, device="cpu"),
            convert.field_from_numpy(rho_T, device="cpu"),
            cfg, device="cpu",
        )
    return jout, out, sink.records


def test_same_newton_and_cg_counts(solved):
    jout, out, _ = solved
    assert out["newton_iters"] == jout["newton_iters"]
    assert [h["cg_iters"] for h in out["history"]] == [h["cg_iters"] for h in jout["history"]]
    assert [h["armijo_trials"] for h in out["history"]] == [
        h["armijo_trials"] for h in jout["history"]
    ]
    assert out["hessian_matvecs"] == jout["hessian_matvecs"]
    assert out["status"] == jout["status"] == "converged"


def test_same_velocity(solved):
    jout, out, _ = solved
    assert float(np.abs(out["v"].numpy() - np.asarray(jout["v"])).max()) < 1e-4


def test_same_diagnostics(solved):
    jout, out, _ = solved
    for key in ("det_min", "det_max", "residual_rel", "residual_rel_smoothed"):
        assert out[key] == pytest.approx(jout[key], rel=1e-4), key
    assert out["det_min"] > 0
    # per iteration, to 1e-4 of the first iteration's value: the last
    # gradient norms are small residuals of O(1e-2) of the first
    first = jout["history"][0]
    for h, jh in zip(out["history"], jout["history"]):
        for key in ("J", "gnorm"):
            assert abs(h[key] - jh[key]) <= 1e-4 * first[key], key


def test_telemetry_records_follow_schema_v1(solved):
    _, out, records = solved
    kinds = [r["kind"] for r in records]
    assert kinds.count("newton_iter") == out["newton_iters"]
    assert kinds.count("solve") == 1
    for rec in records:
        assert jtelemetry.validate_record(rec) == [], rec
    iters = [r for r in records if r["kind"] == "newton_iter"]
    assert all(r["wall_s"] > 0 for r in iters)
    assert [r["cg_iters"] for r in iters] == [h["cg_iters"] for h in out["history"]]


@pytest.mark.parametrize("incompressible", [False, True])
def test_synthetic_problem_matches_jax(incompressible):
    jR, jT, jv, _ = jsyn.synthetic_problem(N, incompressible=incompressible)
    R, T, v, grid = synthetic.synthetic_problem(N, incompressible=incompressible, device="cpu")
    assert grid.shape == (N, N, N)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-6, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-4, rtol=1e-4)


def test_brain_like_matches_jax():
    jR, jT, _ = jsyn.brain_like(N, seed=3)
    R, T, _ = synthetic.brain_like(N, seed=3, device="cpu")
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6, rtol=0)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-6, rtol=0)


def test_configs_carry_across():
    cfg = convert.gn_config_from_dict(dataclasses.asdict(jgn.GNConfig()))
    assert cfg.interp_method == "ref"  # the reference's default, carried as is
    assert gn.GNConfig().interp_method == "auto"  # the port's default
    want = {f.name for f in dataclasses.fields(jgn.GNConfig)} - {"fused_elliptic"}
    assert {f.name for f in dataclasses.fields(gn.GNConfig)} == want
    jcfg = jgn.GNConfig(beta=1e-3, beta_continuation=(1e-1, 1e-2), interp_method="pallas")
    cfg = convert.gn_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.beta_continuation == (1e-1, 1e-2) and cfg.interp_method == "cuda"
    rcfg = convert.registration_config_from_dict(dataclasses.asdict(JConfig(presmooth=False)))
    assert rcfg.presmooth is False and rcfg.solver.beta == jgn.GNConfig().beta


@pytest.mark.parametrize(
    "kw",
    [{"plan_dtype": "bfloat16"}, {"field_dtype": "bfloat16"}, {"autotune": "sweep"},
     {"field_dtype": "float16"}],
)
def test_unported_options_raise(kw):
    """ROADMAP Queue A item 12's knobs; ``gauss_newton=False`` (the fourth
    case until the full Newton Hessian was ported) solves now
    (tests/test_torch_full_newton.py)."""
    with pytest.raises(NotImplementedError):
        gn.GNConfig(**kw)


def test_unported_registration_modes_raise():
    """``blocks`` and the mesh are not ported; ``multilevel`` is
    (tests/test_torch_multilevel.py), and with ``blocks`` it is refused as
    in the reference."""
    with pytest.raises(NotImplementedError, match="item 11"):
        RegistrationConfig(blocks=object())
    with pytest.raises(ValueError, match="mutually exclusive"):
        RegistrationConfig(multilevel=MultilevelConfig(), blocks=object())
    with pytest.raises(NotImplementedError, match="item 13"):
        multilevel.solve(None, None, make_grid(8), MultilevelConfig(), ctx=object())
    with pytest.raises(ValueError, match="interp_method"):
        gn.GNConfig(interp_method="pallas")


@pytest.mark.parametrize(
    "case",
    [
        dict(j_new=0.5, accepted=True),
        dict(j_new=1.2, accepted=False),
        dict(j_new=1.0000001, accepted=False),
        dict(j_new=float("nan"), accepted=True),
        dict(j_new=0.5, accepted=True, pcg_rel=float("inf")),
        dict(j_new=0.5, accepted=True, v_out_nan=True),
    ],
)
def test_health_codes_match_jax(case):
    v = np.ones((3, 4, 4, 4), np.float32)
    v_out = v.copy()
    if case.get("v_out_nan"):
        v_out[0, 0, 0, 0] = np.nan
    kw = dict(j_val=1.0, j_new=case["j_new"], gnorm=2.0, pcg_rel=case.get("pcg_rel", 0.1),
              accepted=case["accepted"])
    want = jhealth.classify(v_in=jnp.asarray(v), v_out=jnp.asarray(v_out),
                            pcg_x=jnp.asarray(v), **{k: jnp.asarray(x) for k, x in kw.items()})
    got = health.classify(
        v_in=torch.from_numpy(v), v_out=torch.from_numpy(v_out), pcg_x=torch.from_numpy(v),
        **{k: torch.tensor(x) for k, x in kw.items()},
    )
    assert int(got) == int(want)
    assert health.status_name(got) == jhealth.status_name(want)
    frozen = health.freeze(torch.from_numpy(v_out), torch.from_numpy(v), got)
    keep = v if int(got) == health.NONFINITE else v_out
    np.testing.assert_array_equal(frozen.numpy(), keep)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory without the package, it exits
    nonzero and prints no result line."""
    script = shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
