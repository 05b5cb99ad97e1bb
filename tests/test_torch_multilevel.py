"""Port parity of ``repro_torch.multilevel`` against ``repro.multilevel``:
the spectral transfer operators, the level ladder, the Galerkin coarse
state, the V-cycle and the coarse-to-fine solve through ``register()``.

The same numpy inputs go to both packages (the port on the CPU, so its
plain interpolation runs; the reference with its oracle).  Bars: transfers
at 1e-5 of the largest value (``tests/test_multilevel.py``), restricted
displacements at 1e-5 and gradient series at 1e-4, one V-cycle application
at 1e-4 relative, and for whole solves the same per-level Newton counts,
Hessian matvecs, per-iteration ``cg_iters`` and preconditioner charges with
``max|v_port - v_jax| < 1e-4`` (the bar of ``tests/test_torch_register.py``).
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import multilevel as jml  # noqa: E402
from repro import telemetry as jtelemetry  # noqa: E402
from repro.core import gauss_newton as jgn  # noqa: E402
from repro.core import objective as jobj  # noqa: E402
from repro.core.grid import make_grid as jmake_grid  # noqa: E402
from repro.core.registration import RegistrationConfig as JConfig  # noqa: E402
from repro.core.registration import register as jregister  # noqa: E402
from repro.core.spectral import SpectralOps as JOps  # noqa: E402
from repro.core.spectral import mode_indices as jmode_indices  # noqa: E402
from repro.core.spectral import nyquist_mask as jnyquist_mask  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.multilevel import hierarchy as jhier  # noqa: E402
from repro.multilevel import precond as jprecond  # noqa: E402
from repro.multilevel import transfer as jtransfer  # noqa: E402
from repro_torch import convert, multilevel, telemetry  # noqa: E402
from repro_torch.core import objective as obj  # noqa: E402
from repro_torch.core.grid import make_grid  # noqa: E402
from repro_torch.core.registration import register  # noqa: E402
from repro_torch.core.spectral import SpectralOps, mode_indices, nyquist_mask  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import spectral_diag, tricubic  # noqa: E402
from repro_torch.multilevel import hierarchy, precond, transfer  # noqa: E402

N = 16
# the example's solver (examples/multilevel_registration.py): on a 3-level
# ladder each level solves at one beta
SOLVER = dict(beta=1e-3, beta_continuation=(1e-1, 1e-2), max_newton=8, max_cg=40,
              autotune="off")
# the same with one beta per level of a 2-level ladder
SOLVER_2 = dict(SOLVER, beta=1e-2, beta_continuation=(1e-1,))
PAIRS = [((16, 12, 24), (8, 6, 12)), ((12, 10, 9), (7, 5, 6))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The fields here are 16^3 at most: intra-op threads only contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    """Agreement to ``rel`` of the reference's largest absolute value."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def _ops_pair(shape):
    return JOps(jmake_grid(shape)), SpectralOps(make_grid(shape), device="cpu")


# --------------------------------------------------------------------------- #
# transfer
# --------------------------------------------------------------------------- #
def test_mode_indices_and_mask_match_jax():
    for nf, nc in ((16, 8), (16, 16), (9, 6), (12, 7), (24, 12)):
        for rfft in (False, True):
            np.testing.assert_array_equal(mode_indices(nf, nc, rfft), jmode_indices(nf, nc, rfft))
            np.testing.assert_array_equal(nyquist_mask(nf, nc, rfft), jnyquist_mask(nf, nc, rfft))
    with pytest.raises(ValueError):
        mode_indices(8, 16)


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("lead", [(), (3,)])
def test_transfers_match_jax(rng, pair, lead):
    (jf, f), (jc, c) = _ops_pair(pair[0]), _ops_pair(pair[1])
    x = rng.standard_normal(lead + pair[0]).astype(np.float32)
    y = rng.standard_normal(lead + pair[1]).astype(np.float32)
    for name in ("restrict", "smooth_restrict"):
        want = getattr(jtransfer, name)(jnp.asarray(x), jf, jc)
        got = getattr(transfer, name)(_t(x), f, c)
        assert got.shape == lead + pair[1], name
        _close(got, want, 1e-5)
    want = jtransfer.prolong(jnp.asarray(y), jc, jf)
    got = transfer.prolong(_t(y), c, f)
    assert got.shape == lead + pair[0]
    _close(got, want, 1e-5)


@pytest.mark.parametrize("pair", PAIRS)
def test_spectrum_transfers_match_jax(rng, pair):
    """``restrict_spec`` and ``pad_spec`` on the same complex spectra."""
    (jf, f), (jc, c) = _ops_pair(pair[0]), _ops_pair(pair[1])
    kf = pair[0][:2] + (pair[0][2] // 2 + 1,)
    kc = pair[1][:2] + (pair[1][2] // 2 + 1,)
    sf = (rng.standard_normal((3,) + kf) + 1j * rng.standard_normal((3,) + kf)).astype(np.complex64)
    sc = (rng.standard_normal((3,) + kc) + 1j * rng.standard_normal((3,) + kc)).astype(np.complex64)
    _close(transfer.restrict_spec(_t(sf), f, c), jtransfer.restrict_spec(jnp.asarray(sf), jf, jc),
           1e-5)
    _close(transfer.pad_spec(_t(sc), c, f), jtransfer.pad_spec(jnp.asarray(sc), jc, jf), 1e-5)


def test_restrict_prolong_adjoint_and_roundtrip(rng):
    """<R x, y>_coarse == <x, P y>_fine, and R P == I on Nyquist-free fields."""
    (_, f), (_, c) = _ops_pair(PAIRS[0][0]), _ops_pair(PAIRS[0][1])
    x = _t(rng.standard_normal(PAIRS[0][0]).astype(np.float32))
    y = transfer.restrict(_t(rng.standard_normal(PAIRS[0][0]).astype(np.float32)), f, c)
    a = float(c.grid.inner(transfer.restrict(x, f, c), y))
    b = float(f.grid.inner(x, transfer.prolong(y, c, f)))
    assert abs(a - b) < 1e-5 * max(1.0, abs(a))
    rt = transfer.restrict(transfer.prolong(y, c, f), f, c)
    assert float((rt - y).abs().max()) < 1e-5


# --------------------------------------------------------------------------- #
# hierarchy
# --------------------------------------------------------------------------- #
def test_beta_schedule_and_halving_match_jax():
    for sched in ((1e-1, 1e-2, 1e-3), (1e-2,), (1e-1, 1e-2, 1e-3, 1e-4, 1e-5)):
        for n in (1, 2, 3, 4):
            assert hierarchy.split_beta_schedule(sched, n) == jhier.split_beta_schedule(sched, n)
    for shape, levels, floor in (((32,) * 3, 3, 8), ((16,) * 3, 4, 8), ((64, 48, 20), 4, 4),
                                 ((18, 16, 16), 3, 4)):
        assert hierarchy._halved(shape, levels, floor) == jhier._halved(shape, levels, floor)


@pytest.mark.parametrize(
    "kw",
    [dict(n_levels=3, min_size=4), dict(shapes=((8,) * 3, (12,) * 3, (16,) * 3)),
     dict(n_levels=2, level_overrides=({"max_cg": 10}, {"interp_method": "ref"}))],
)
def test_level_configs_match_jax(kw):
    jcfg = jhier.MultilevelConfig(solver=jgn.GNConfig(**SOLVER), **kw)
    cfg = convert.multilevel_config_from_dict(dataclasses.asdict(jcfg))
    jh = jhier.GridHierarchy(jmake_grid(N), jcfg)
    h = hierarchy.GridHierarchy(make_grid(N), cfg)
    assert [g.shape for g in h.grids] == [g.shape for g in jh.grids]
    assert h.betas == jh.betas and len(h) == len(jh)
    for lv in range(len(h)):
        want = convert.gn_config_from_dict(dataclasses.asdict(jh.level_config(lv)))
        assert h.level_config(lv) == want
        assert h.fine_equiv_weight(lv) == jh.fine_equiv_weight(lv)


def test_validation_errors_match_jax():
    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    assert message(lambda: hierarchy.MultilevelConfig(precond="spectral")) == message(
        lambda: jhier.MultilevelConfig(precond="spectral")
    )
    for shapes in (((16,) * 3, (24,) * 3), ((64,) * 3, (32,) * 3)):
        assert message(
            lambda: hierarchy.GridHierarchy(make_grid(32), hierarchy.MultilevelConfig(shapes=shapes))
        ) == message(
            lambda: jhier.GridHierarchy(jmake_grid(32), jhier.MultilevelConfig(shapes=shapes))
        )
    for kw in (dict(two_level_precond=True), dict(precond="vcycle"), dict(precond="two_level")):
        jcfg, cfg = jhier.MultilevelConfig(**kw), hierarchy.MultilevelConfig(**kw)
        assert (cfg.precond_kind, cfg.galerkin_resolved) == (
            jcfg.precond_kind, jcfg.galerkin_resolved
        )


# --------------------------------------------------------------------------- #
# Galerkin coarse state and the V-cycle
# --------------------------------------------------------------------------- #
class Ladder:
    """A Newton state at 16^3 on both sides and the ladder 4 -> 8 -> 16."""

    def __init__(self, incompressible):
        rho_R, rho_T, jgrid = jsyn.brain_like(N)
        make_v = jsyn.paper_velocity_divfree if incompressible else jsyn.paper_velocity
        v = np.asarray(make_v(jgrid, 0.5))
        self.shapes = [(4,) * 3, (8,) * 3, (N,) * 3]
        pairs = [_ops_pair(s) for s in self.shapes]
        self.jops, self.ops = [p[0] for p in pairs], [p[1] for p in pairs]
        self.jinterp, self.interp = jkops.make_interp("ref"), kops.make_interp("ref")
        self.jprob = jobj.Problem(jgrid, rho_R, rho_T, 1e-3, 4, incompressible)
        self.prob = obj.Problem(self.ops[-1].grid, _t(rho_R), _t(rho_T), 1e-3, 4,
                                incompressible)
        self.jstate = jobj.newton_state(jnp.asarray(v), self.jprob, self.jops[-1], self.jinterp)
        self.state = obj.newton_state(_t(v), self.prob, self.ops[-1], self.interp)


@pytest.fixture(scope="module", params=[False, True], ids=["compressible", "incompressible"])
def ladder(request):
    return Ladder(request.param)


def test_restrict_state_matches_jax(ladder):
    js, jp = jprecond.restrict_state(ladder.jstate, ladder.jprob, ladder.jops[-1], ladder.jops[1])
    s, p = precond.restrict_state(ladder.state, ladder.prob, ladder.ops[-1], ladder.ops[1],
                                  ladder.interp)
    assert p.grid.shape == jp.grid.shape and (p.beta, p.n_t) == (jp.beta, jp.n_t)
    np.testing.assert_allclose(s.plan.disp_fwd.numpy(), np.asarray(js.plan.disp_fwd), atol=1e-5)
    np.testing.assert_allclose(s.plan.disp_adj.numpy(), np.asarray(js.plan.disp_adj), atol=1e-5)
    np.testing.assert_allclose(s.grad_rho_series.numpy(), np.asarray(js.grad_rho_series),
                               atol=1e-4)
    if ladder.prob.incompressible:
        assert s.plan.divv is None and js.plan.divv is None
    else:
        np.testing.assert_allclose(s.plan.divv.numpy(), np.asarray(js.plan.divv), atol=1e-4)
    # the coarse operators are rebuilt from the restricted displacements
    np.testing.assert_array_equal(s.plan.iplan_fwd.ib.numpy(),
                                  np.floor(s.plan.disp_fwd.numpy()).astype(np.int32))


@pytest.mark.parametrize("n_cg,n_cg_coarse,min_size", [(4, 10, 4), (2, 5, 4), (4, 10, 8)])
def test_fine_equiv_cost_matches_jax(ladder, n_cg, n_cg_coarse, min_size):
    kw = dict(n_cg=n_cg, n_cg_coarse=n_cg_coarse, min_size=min_size)
    jf = jprecond.make_vcycle_precond(ladder.jprob, ladder.jops, **kw)
    f = precond.make_vcycle_precond(ladder.prob, ladder.ops, **kw)
    assert f.fine_equiv_cost == jf.fine_equiv_cost
    assert f.n_levels == jf.n_levels
    jf = jprecond.make_two_level_precond(ladder.jprob, ladder.jops[-1], ladder.jops[1], n_cg=n_cg)
    f = precond.make_two_level_precond(ladder.prob, ladder.ops[-1], ladder.ops[1], n_cg=n_cg)
    assert f.fine_equiv_cost == jf.fine_equiv_cost


def test_vcycle_application_matches_jax(ladder, rng):
    """One application of the 3-level V-cycle to a fixed residual."""
    r = rng.standard_normal((3,) + (N,) * 3).astype(np.float32)
    kw = dict(n_cg=4, n_cg_coarse=10, min_size=4)
    jz = jprecond.make_vcycle_precond(ladder.jprob, ladder.jops, **kw)(
        ladder.jstate, ladder.jprob
    )(jnp.asarray(r))
    z = precond.make_vcycle_precond(
        ladder.prob, ladder.ops, level_interp=[ladder.interp] * 3, **kw
    )(ladder.state, ladder.prob)(_t(r))
    _close(z, jz, 1e-4)


def test_vcycle_frees_its_states_without_gc(ladder, rng, monkeypatch):
    """Dropping the preconditioner frees its coarse states at once: no
    reference cycle keeps one Newton iteration's states alive until the
    cyclic collector runs (at 256^3 a state is gigabytes on the card)."""
    import gc
    import weakref

    refs = []
    restrict = precond.restrict_state

    def spy(*args, **kw):
        state_c, prob_c = restrict(*args, **kw)
        refs.append(weakref.ref(state_c.grad_rho_series))
        return state_c, prob_c

    monkeypatch.setattr(precond, "restrict_state", spy)
    factory = precond.make_vcycle_precond(ladder.prob, ladder.ops,
                                          level_interp=[ladder.interp] * 3, min_size=4)
    r = _t(rng.standard_normal((3,) + (N,) * 3).astype(np.float32))
    gc.collect()
    gc.disable()
    try:
        apply = factory(ladder.state, ladder.prob)
        apply(r)
        assert len(refs) == 2 and all(ref() is not None for ref in refs)
        del apply
        assert all(ref() is None for ref in refs)
    finally:
        gc.enable()


# --------------------------------------------------------------------------- #
# coarse-to-fine solves
# --------------------------------------------------------------------------- #
def _solve_pair(precond_kind):
    rho_R, rho_T, jgrid = jsyn.brain_like(N)
    jcfg = jhier.MultilevelConfig(solver=jgn.GNConfig(**SOLVER_2), n_levels=2,
                                  precond=precond_kind)
    jout = jml.solve(rho_R, rho_T, jgrid, jcfg)
    cfg = convert.multilevel_config_from_dict(dataclasses.asdict(jcfg))
    out = multilevel.solve(_t(rho_R), _t(rho_T), make_grid(N), cfg, device="cpu")
    return jout, out


@pytest.fixture(scope="module", params=["none", "two_level", "vcycle"])
def solved(request):
    return _solve_pair(request.param)


def _same_counts(jout, out):
    keys = ("newton_iters", "hessian_matvecs", "precond_fine_equiv_matvecs", "shape", "betas",
            "warm_start", "fine_equiv_matvecs")
    assert [{k: lv[k] for k in keys} for lv in out["levels"]] == [
        {k: lv[k] for k in keys} for lv in jout["levels"]
    ]
    assert [h["cg_iters"] for h in out["history"]] == [h["cg_iters"] for h in jout["history"]]
    assert [(h["level"], h["shape"]) for h in out["history"]] == [
        (h["level"], h["shape"]) for h in jout["history"]
    ]
    for key in ("newton_iters", "hessian_matvecs", "fine_matvecs", "fine_equiv_matvecs",
                "precond_fine_equiv_matvecs", "total_fine_equiv_matvecs", "grids"):
        assert out[key] == jout[key], key
    assert float(np.abs(out["v"].numpy() - np.asarray(jout["v"])).max()) < 1e-4


def test_two_level_solves_match_jax(solved):
    jout, out = solved
    _same_counts(jout, out)


def test_register_multilevel_vcycle_matches_jax():
    """The example's V-cycle on a 3-level ladder through ``register()``,
    with the schema-v1 telemetry of the ladder."""
    rho_R, rho_T, jgrid = jsyn.brain_like(N)
    jcfg = JConfig(multilevel=jhier.MultilevelConfig(
        solver=jgn.GNConfig(**SOLVER), shapes=((8,) * 3, (12,) * 3, (16,) * 3), precond="vcycle",
    ))
    jout = jregister(rho_R, rho_T, jcfg, grid=jgrid)
    cfg = convert.registration_config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.multilevel.solver.interp_method == "ref"
    tricubic.reset_launches()
    with telemetry.ListSink() as sink:
        out = register(_t(rho_R), _t(rho_T), cfg, device="cpu")
    assert all(n == 0 for n in tricubic.LAUNCHES.values())
    assert all(n == 0 for n in spectral_diag.LAUNCHES.values())
    _same_counts(jout, out)
    for key in ("det_min", "det_max", "residual_rel", "residual_rel_smoothed"):
        assert out[key] == pytest.approx(jout[key], rel=1e-4), key
    assert out["det_min"] > 0
    kinds = [r["kind"] for r in sink.records]
    assert kinds.count("level_start") == kinds.count("level") == 3
    assert kinds.count("solve") == 4  # one per level, one for the ladder
    assert sum(1 for r in sink.records if r["kind"] == "span"
               and r["name"] == "multilevel.level") == 3
    for rec in sink.records:
        assert jtelemetry.validate_record(rec) == [], rec
