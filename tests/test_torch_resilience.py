"""Port parity of the fault-tolerant server (``repro_torch.resilience`` and
``serve_jobs(retry=, checkpoint=, resume=, faults=)``) on the CPU.

The problems are the reference test's (``tests/test_resilience.py``): four
``synthetic_problem(12, n_t=2, amplitude=a)`` pairs, a = 0.2, 0.6, 1.0,
1.4, with its ``CFG``, served through 2 slots.  Held:

* the health guard on a poisoned solve and a poisoned cohort subject;
* the retry policy: pure in (cfg, attempt), the reference's ladder, a
  beta-only rung keeping ``static_key``, and ``field_dtype="float32"`` as
  the identity (a narrower dtype still raises);
* NaN injected into one job mid-serve: caught, retried under the ladder and
  finished, the other jobs bit for bit the un-faulted run's, one step
  signature, a trace of fault, recovery and per-attempt job records; and
  the same per-job statuses, attempts and Newton counts as the JAX
  package's injected run (its matvecs part as ROADMAP Queue C 7 says);
* kill and resume: the resumed stream bit for bit the uninterrupted one,
  only the unfinished jobs served again, the reference's counts; resuming
  a finished stream serves nothing;
* the crash-safe JSON writer.
"""
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import resilience as jresilience  # noqa: E402
from repro.core import gauss_newton as jgn  # noqa: E402
from repro.data.synthetic import synthetic_problem  # noqa: E402
from repro.launch import reg_serve as jserve  # noqa: E402
from repro.telemetry.events import validate_record  # noqa: E402
from repro_torch import resilience, telemetry  # noqa: E402
from repro_torch.core import gauss_newton as gn  # noqa: E402
from repro_torch.core.grid import make_grid  # noqa: E402
from repro_torch.launch.reg_serve import RegJob, serve_jobs  # noqa: E402
from repro_torch.resilience import health  # noqa: E402
from repro_torch.resilience.atomic import atomic_write_json  # noqa: E402
from repro_torch.resilience.faults import KillAt, NaNInjector, SimulatedCrash  # noqa: E402
from repro_torch.resilience.policy import DEFAULT_LADDER, RetryPolicy, static_key  # noqa: E402

N = 12
AMPS = (0.2, 0.6, 1.0, 1.4)
CFG_KW = dict(beta=1e-2, n_t=2, max_newton=8, gtol=1e-2, max_cg=20)
CFG = gn.GNConfig(**CFG_KW)
JCFG = jgn.GNConfig(**CFG_KW)
# ROADMAP Queue C 7: these jobs' matvecs part from the reference's (the
# cohort's PCG residual test sits at its threshold at one Newton iteration)
PARTED_MATVECS = {"job1", "job2"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def problems():
    return [synthetic_problem(N, n_t=2, amplitude=a) for a in AMPS]


def _jobs(probs):
    return [RegJob(job_id=f"job{s}", rho_R=_t(p[0]), rho_T=_t(p[1])) for s, p in enumerate(probs)]


def _jjobs(probs):
    return [jserve.RegJob(job_id=f"job{s}", rho_R=p[0], rho_T=p[1]) for s, p in enumerate(probs)]


def _serve(jobs, **kw):
    return serve_jobs(jobs, CFG, slots=2, device="cpu", **kw)


@pytest.fixture(scope="module")
def baseline(problems):
    return _serve(_jobs(problems))


def _by_id(out):
    return {r.job_id: r for r in out["results"]}


def _counts(out):
    return {r.job_id: (r.status, r.attempts, r.newton_iters, r.hessian_matvecs)
            for r in out["results"]}


def _assert_counts_match_jax(got, want):
    """Statuses, attempts and Newton counts equal; matvecs equal but for
    the jobs of ROADMAP Queue C 7."""
    got, want = _counts(got), _counts(want)
    assert set(got) == set(want)
    for jid in got:
        assert got[jid][:3] == want[jid][:3], jid
        if jid not in PARTED_MATVECS:
            assert got[jid][3] == want[jid][3], jid


# --------------------------------------------------------------------------- #
# the health guard
# --------------------------------------------------------------------------- #
def test_guard_flags_nan_input_and_freezes(problems):
    rho_R, rho_T = _t(problems[0][0]), _t(problems[0][1]).clone()
    rho_T[0, 0, 0] = float("nan")
    out = gn.solve(rho_R, rho_T, make_grid(N), CFG, device="cpu")
    assert out["status"] == "nonfinite"
    assert len(out["history"]) == 1
    assert torch.isfinite(out["v"]).all()


def test_guard_cohort_isolates_sick_subject(problems):
    R = torch.stack([_t(problems[0][0]), _t(problems[1][0])])
    good_T = torch.stack([_t(problems[0][1]), _t(problems[1][1])])
    bad_T = good_T.clone()
    bad_T[1] = float("nan")
    good = gn.solve_cohort(R, good_T, make_grid(N), CFG, device="cpu")
    bad = gn.solve_cohort(R, bad_T, make_grid(N), CFG, device="cpu")
    assert bad["status"][1] == "nonfinite"
    assert torch.isfinite(bad["v"]).all()
    assert torch.equal(bad["v"][0], good["v"][0])
    assert bad["newton_iters"][0] == good["newton_iters"][0]
    assert bad["hessian_matvecs"][0] == good["hessian_matvecs"][0]


# --------------------------------------------------------------------------- #
# the retry policy
# --------------------------------------------------------------------------- #
def test_policy_beta_rung_shares_executable_key():
    d2 = RetryPolicy().degraded(CFG, 2)
    assert d2.beta == pytest.approx(CFG.beta * DEFAULT_LADDER[0].beta_scale)
    assert static_key(d2) == static_key(CFG)
    d3 = RetryPolicy().degraded(CFG, 3)
    assert d3.field_dtype == "float32" and d3.interp_method == CFG.interp_method
    assert d3.max_line_search >= 20
    assert static_key(d3) != static_key(CFG)
    assert RetryPolicy().degraded(CFG, 3) == d3
    assert RetryPolicy().degraded(CFG, 1) is CFG
    with pytest.raises(ValueError, match="not a retry"):
        RetryPolicy().rung(1)


def test_policy_is_the_references():
    """The reference's ladder, but for its last rung's ``interp_method="ref"``
    (an escape from its halo budget; the port's kernels have none), which
    the port leaves to the job's config (ROADMAP Queue C 10)."""
    theirs_ladder = [vars(r) | {"interp_method": None} for r in jresilience.DEFAULT_LADDER]
    assert [vars(r) for r in DEFAULT_LADDER] == theirs_ladder
    assert [r.interp_method for r in jresilience.DEFAULT_LADDER] == [None, "ref"]
    mine, theirs = RetryPolicy(), jresilience.RetryPolicy()
    assert (mine.max_attempts, mine.retry_on, mine.warm_start) == (
        theirs.max_attempts, theirs.retry_on, theirs.warm_start)
    assert sorted(resilience.__all__) == sorted(jresilience.__all__)
    for attempt in (2, 3, 4):
        want = jresilience.RetryPolicy().degraded(JCFG, attempt)
        got = RetryPolicy().degraded(CFG, attempt)
        for field in ("beta", "field_dtype", "max_line_search", "max_cg", "beta_continuation"):
            assert getattr(got, field) == getattr(want, field), (attempt, field)
        assert got.interp_method == CFG.interp_method


@pytest.mark.parametrize("dtype", ["float32", torch.float32, np.float32])
def test_field_dtype_float32_is_the_identity(problems, dtype):
    """The ladder's last rung sets ``field_dtype="float32"``: the port's
    fields are f32, so it solves exactly as ``None`` does."""
    rho_R, rho_T = _t(problems[1][0]), _t(problems[1][1])
    kw = dict(CFG_KW, max_newton=2)
    want = gn.solve(rho_R, rho_T, make_grid(N), gn.GNConfig(**kw), device="cpu")
    got = gn.solve(rho_R, rho_T, make_grid(N), gn.GNConfig(**kw, field_dtype=dtype),
                   device="cpu")
    assert torch.equal(got["v"], want["v"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", torch.bfloat16, "float64"])
def test_field_dtype_narrower_still_raises(dtype):
    with pytest.raises(NotImplementedError, match="item 12"):
        gn.GNConfig(field_dtype=dtype)


# --------------------------------------------------------------------------- #
# NaN injection mid-serve
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def injected(problems):
    fault = NaNInjector(job_id="job1", field="v", at_iteration=1)
    with telemetry.ListSink() as sink:
        out = _serve(_jobs(problems), retry=RetryPolicy(max_attempts=2), faults=[fault])
    return fault, out, sink.records


def test_nan_injection_isolated_retried_one_executable(injected, baseline):
    fault, out, records = injected
    assert fault.fired
    res, ref = _by_id(out), _by_id(baseline)
    assert set(res) == set(ref)
    assert res["job1"].attempts == 2
    assert res["job1"].status not in health.FAILED_NAMES
    assert torch.isfinite(res["job1"].v).all()
    for jid in ("job0", "job2", "job3"):
        assert torch.equal(res[jid].v, ref[jid].v), jid
        assert res[jid].newton_iters == ref[jid].newton_iters, jid
        assert res[jid].hessian_matvecs == ref[jid].hessian_matvecs, jid
        assert res[jid].status == ref[jid].status, jid
        assert res[jid].attempts == 1, jid
    assert out["compiled_executables"] == 1
    retry_keys = [k for k, st in out["buckets"].items() if st["attempt"] > 1]
    assert retry_keys == [(N, N, N, "retry2")]
    assert out["buckets"][retry_keys[0]]["jobs"] == 1


def test_nan_injection_trace(injected):
    _, _, records = injected
    faults = [r for r in records if r["kind"] == "fault"]
    assert len(faults) == 1
    assert faults[0]["fault"] == "nan_injection" and faults[0]["target"] == "job1"
    recov = [r for r in records if r["kind"] == "recovery"]
    assert recov[0]["action"] == "retry_degraded" and recov[0]["attempts"] == 2
    # the poisoned iterate is the one the guard froze, so the retry starts
    # from the job's v0, as the reference's does
    assert recov[0]["attrs"]["warm_start"] is False
    job_evts = [r for r in records if r["kind"] == "job" and r["job_id"] == "job1"]
    assert [e["attempts"] for e in job_evts] == [1, 2]
    assert job_evts[0]["status"] == "nonfinite"
    counters = {r["name"] for r in records if r["kind"] == "counter"}
    assert {"resilience.faults_injected", "resilience.retries",
            "resilience.guard_tripped"} <= counters
    for rec in records:
        assert validate_record(rec) == [], rec["kind"]


def test_nan_injection_matches_jax(problems, injected):
    _, out, _ = injected
    want = jserve.serve_jobs(_jjobs(problems), JCFG, slots=2,
                             retry=jresilience.RetryPolicy(max_attempts=2),
                             faults=[jresilience.NaNInjector(job_id="job1", field="v",
                                                             at_iteration=1)])
    _assert_counts_match_jax(out, want)
    assert out["compiled_executables"] == want["compiled_executables"] == 1
    assert {k: (st["jobs"], st["cohort_iterations"]) for k, st in out["buckets"].items()} == \
        {k: (st["jobs"], st["cohort_iterations"]) for k, st in want["buckets"].items()}


@pytest.mark.parametrize("field", ["rho_T", "rho_R"])
def test_nan_image_injection_isolated(problems, baseline, field):
    """One poisoned voxel of an input image retires its job (no retry
    policy); every other job is bit for bit the un-faulted run's."""
    fault = NaNInjector(job_id="job1", field=field, at_iteration=2, element=(3, 4, 5))
    out = _serve(_jobs(problems), faults=[fault])
    assert fault.fired
    res, ref = _by_id(out), _by_id(baseline)
    assert res["job1"].status == "nonfinite"
    assert torch.isfinite(res["job1"].v).all()
    for jid in ("job0", "job2", "job3"):
        assert torch.equal(res[jid].v, ref[jid].v), jid
        assert res[jid].hessian_matvecs == ref[jid].hessian_matvecs, jid


# --------------------------------------------------------------------------- #
# kill and resume
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def killed(problems, tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    ref_out = _serve(_jobs(problems), checkpoint=str(root / "ref"), checkpoint_every=2)
    ck = str(root / "ck")
    kill = KillAt(at_iteration=4)
    with pytest.raises(SimulatedCrash):
        _serve(_jobs(problems), checkpoint=ck, checkpoint_every=2, faults=[kill])
    assert kill.fired
    with telemetry.ListSink() as sink:
        out = _serve([], checkpoint=ck, checkpoint_every=2, resume=True)
    return ref_out, out, sink.records, ck


def test_kill_and_resume_reserves_only_unfinished(killed, baseline):
    ref_out, out, records, _ = killed
    res, ref = _by_id(out), _by_id(ref_out)
    assert set(res) == set(ref)
    for jid, r in ref.items():
        assert torch.equal(res[jid].v, r.v), jid
        assert torch.equal(res[jid].v, _by_id(baseline)[jid].v), jid
        assert (res[jid].newton_iters, res[jid].hessian_matvecs, res[jid].status) == (
            r.newton_iters, r.hessian_matvecs, r.status), jid
    recov = [r for r in records if r["kind"] == "recovery"]
    assert recov and recov[0]["action"] == "resume_from_checkpoint"
    assert recov[0]["attrs"]["completed"] + recov[0]["attrs"]["unfinished"] == len(AMPS)
    assert 0 < recov[0]["attrs"]["unfinished"] < len(AMPS)
    key = (N, N, N)
    assert out["buckets"][key]["cohort_iterations"] == ref_out["buckets"][key]["cohort_iterations"]
    served = {r["job_id"] for r in records if r["kind"] == "job"}
    assert len(served) == recov[0]["attrs"]["unfinished"]
    assert {r["name"] for r in records if r["kind"] == "counter"} >= {"resilience.resumes"}
    for rec in records:
        assert validate_record(rec) == [], rec["kind"]


def test_kill_and_resume_matches_jax(problems, killed, tmp_path):
    _, out, records, _ = killed
    ck = str(tmp_path / "jck")
    with pytest.raises(jresilience.SimulatedCrash):
        jserve.serve_jobs(_jjobs(problems), JCFG, slots=2, checkpoint=ck, checkpoint_every=2,
                          faults=[jresilience.KillAt(at_iteration=4)])
    want = jserve.serve_jobs([], JCFG, slots=2, checkpoint=ck, checkpoint_every=2, resume=True)
    _assert_counts_match_jax(out, want)
    key = (N, N, N)
    assert out["buckets"][key]["cohort_iterations"] == want["buckets"][key]["cohort_iterations"]


def test_resuming_a_finished_stream_serves_nothing(killed):
    ref_out, _, _, ck = killed
    with telemetry.ListSink() as sink:
        out = _serve([], checkpoint=ck, resume=True)
    assert {r.job_id for r in out["results"]} == set(_by_id(ref_out))
    assert not [r for r in sink.records if r["kind"] == "job"]
    for jid, r in _by_id(ref_out).items():
        assert torch.equal(_by_id(out)[jid].v, r.v), jid


def test_resume_without_a_snapshot_serves_the_jobs(problems, baseline, tmp_path):
    out = _serve(_jobs(problems), checkpoint=str(tmp_path / "empty"), resume=True)
    assert _counts(out) == _counts(baseline)


# --------------------------------------------------------------------------- #
# chip_smoke.py's launch counts of the served paths
# --------------------------------------------------------------------------- #
def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


# chip_smoke.py counts launches for the solver's default n_t = 4
CFG_NT4 = gn.GNConfig(**dict(CFG_KW, n_t=4))


def _serve_nt4(jobs, **kw):
    return serve_jobs(jobs, CFG_NT4, slots=2, device="cpu", **kw)


def _serve_injected(jobs):
    return _serve_nt4(jobs, retry=RetryPolicy(max_attempts=3),
                      faults=[NaNInjector(job_id="job1", field="v", at_iteration=1)])


def _serve_killed_and_resumed(jobs, tmp_path):
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedCrash):
        _serve_nt4(jobs, checkpoint=ck, checkpoint_every=2, faults=[KillAt(at_iteration=4)])
    return _serve_nt4([], checkpoint=ck, checkpoint_every=2, resume=True)


@pytest.mark.parametrize("run", ["plain", "injected", "killed_and_resumed"])
def test_chip_smoke_counts_the_served_launches(problems, tmp_path, monkeypatch, run):
    """On a card every planned apply is one K1 launch and every unplanned
    displace one K2 launch: counted here on their plain versions, the
    served run makes as many as chip_smoke.py derives from the steps'
    calls (the gate of its serve_path, resilience_path and resume_path)."""
    from repro_torch.kernels import ops as kops

    smoke = _chip_smoke()
    calls = {"tricubic_apply": 0, "tricubic_displace_many": 0}
    apply_plan, displace_many = kops.Interp.apply_plan, kops.tricubic_displace_many

    def counted_apply(self, fields, plan):
        calls["tricubic_apply"] += 1
        return apply_plan(self, fields, plan)

    def counted_displace(fields, disp, **kw):
        calls["tricubic_displace_many"] += 1
        return displace_many(fields, disp, **kw)

    monkeypatch.setattr(kops.Interp, "apply_plan", counted_apply)
    monkeypatch.setattr(kops, "tricubic_displace_many", counted_displace)
    jobs = _jobs(problems)
    with smoke._recording_steps() as steps:
        if run == "plain":
            _serve_nt4(jobs)
        elif run == "injected":
            _serve_injected(jobs)
        else:
            _serve_killed_and_resumed(jobs, tmp_path)
    expected = smoke._expected_served_launches(steps)
    assert {k: expected[k] for k in calls} == calls
    assert expected["tricubic_displace"] == expected["biharmonic_scale"] == 0
    assert sum(len(step.calls) for step in steps) > 0


# --------------------------------------------------------------------------- #
# crash-safe JSON writes
# --------------------------------------------------------------------------- #
def test_atomic_write_json_roundtrip_and_failure_keeps_old(tmp_path):
    path = str(tmp_path / "nested" / "out.json")
    atomic_write_json(path, {"a": 1})
    assert json.load(open(path)) == {"a": 1}
    with pytest.raises(TypeError):
        atomic_write_json(path, {"bad": object()})
    assert json.load(open(path)) == {"a": 1}
    assert os.listdir(os.path.dirname(path)) == ["out.json"]


def test_atomic_write_json_temp_is_pid_unique(tmp_path, monkeypatch):
    seen = {}
    real_replace = os.replace

    def spy(src, dst):
        seen["tmp"] = os.path.basename(src)
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    atomic_write_json(str(tmp_path / "x.json"), [1, 2], trailing_newline=True)
    assert seen["tmp"] == f"x.json.tmp.{os.getpid()}"
    assert open(tmp_path / "x.json").read().endswith("]\n")


def test_overflow_displacement_is_the_references():
    got = resilience.overflow_displacement((4, 5, 6), halo=3)
    want = jresilience.overflow_displacement((4, 5, 6), halo=3)
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(want)))


def test_port_schema_check_is_the_references(injected):
    """``repro_torch.telemetry.validate_record`` (what ``chip_smoke.py``
    runs, without JAX) finds what the reference's finds, on the chaos
    trace and on broken records."""
    _, _, records = injected
    fault = next(r for r in records if r["kind"] == "fault")
    broken = [dict(fault, v=2), {k: v for k, v in fault.items() if k != "fault"},
              dict(fault, kind="nope"), dict(fault, ts="now"), ["not", "a", "dict"]]
    for rec in records + broken:
        assert telemetry.validate_record(rec) == validate_record(rec), rec
    assert all(telemetry.validate_record(r) for r in broken)
