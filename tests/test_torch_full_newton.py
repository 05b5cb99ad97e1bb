"""Port parity of the full Newton Hessian and of what the earlier slices
left out of ``core/spectral.py`` and ``kernels/``, against the JAX package
on the CPU.

* ``semilag.transport_inc_state_series``, ``transport_inc_adjoint_newton``
  and ``objective.full_hessian_matvec`` against ``repro.core`` on the
  reference test's problem (``tests/test_gradient.py``:
  ``synthetic_problem(16, amplitude=0.5)``, compressible and
  incompressible, ``beta=1e-2``, ``n_t=4``), at 1e-4;
* the reference's properties of the full Hessian, run on the port at the
  reference's tolerances: the FD second derivative, symmetry, and equality
  with Gauss-Newton at a perfect match;
* a whole ``gn.solve(gauss_newton=False)`` at 16^3 against the reference's:
  the same Newton and per-iteration PCG counts and statuses, max|dv| < 1e-4
  incompressible; compressible, both packages' solves amplify roundoff at
  one Newton iteration (ROADMAP Queue C 8), so the velocities are held to
  a bound of their own there, and every step, from the reference's own
  iterate, to 5e-5;
* the cohort refusal, as the reference's;
* every ``SpectralOps`` and ``SpectralBatch`` operator, and the plain
  helpers ``tricubic_points[_chunked]``, ``max_displacement`` and
  ``spectral_scale``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import gauss_newton as jgn  # noqa: E402
from repro.core import objective as jobj  # noqa: E402
from repro.core import semilag as jsemilag  # noqa: E402
from repro.core.grid import make_grid as jmake_grid  # noqa: E402
from repro.core.spectral import SpectralOps as JOps  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import gauss_newton as gn  # noqa: E402
from repro_torch.core import objective as obj  # noqa: E402
from repro_torch.core import semilag  # noqa: E402
from repro_torch.core.grid import make_grid  # noqa: E402
from repro_torch.core.spectral import SpectralOps  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

N = 16
N_T = 4
BETA = 1e-2
REL = 1e-4  # tests/test_interp_plan.py
SPECTRAL_RTOL = 2e-5  # tests/test_kernels.py
V_TOL = 1e-4  # a whole solve (ROADMAP "Ground rules")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=REL):
    """Agreement to ``rel`` of the reference's largest value."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel, atol=rel * scale)


class Both:
    """The reference test's problem on both sides, with one random v0."""

    def __init__(self, incompressible, seed):
        rng = np.random.default_rng(seed + 1)  # tests/test_gradient.py's offset
        rho_R, rho_T, _, jgrid = jsyn.synthetic_problem(N, amplitude=0.5,
                                                         incompressible=incompressible)
        self.incompressible = incompressible
        self.jgrid, self.grid = jgrid, make_grid(N)
        self.jops, self.ops = JOps(jgrid), SpectralOps(self.grid, device="cpu")
        v0 = jnp.asarray(rng.standard_normal((3,) + jgrid.shape) * 0.1, jnp.float32)
        if incompressible:
            v0 = self.jops.leray(v0)
        self.v0 = np.asarray(v0)
        self.rho_R, self.rho_T = np.asarray(rho_R), np.asarray(rho_T)
        self.jprob = jobj.Problem(jgrid, rho_R, rho_T, BETA, N_T, incompressible)
        self.prob = obj.Problem(self.grid, _t(self.rho_R), _t(self.rho_T), BETA, N_T,
                                incompressible)
        self.jstate = jobj.newton_state(jnp.asarray(self.v0), self.jprob, self.jops)
        self.state = obj.newton_state(_t(self.v0), self.prob, self.ops)

    def field(self, rng):
        w = rng.standard_normal((3,) + self.jgrid.shape).astype(np.float32) * 0.1
        return np.asarray(self.jops.leray(jnp.asarray(w))) if self.incompressible else w


@pytest.fixture(scope="module", params=[False, True], ids=["compressible", "incompressible"])
def both(request, test_seed):
    return Both(request.param, test_seed)


# --------------------------------------------------------------------------- #
# the series transports and the full Hessian matvec against JAX
# --------------------------------------------------------------------------- #
def test_inc_state_series_matches_jax(both, rng):
    vt = both.field(rng)
    want = jsemilag.transport_inc_state_series(jnp.asarray(vt), both.jstate.grad_rho_series,
                                               both.jstate.plan)
    got = semilag.transport_inc_state_series(_t(vt), both.state.grad_rho_series,
                                             both.state.plan)
    assert got.shape == want.shape == (N_T + 1,) + both.jgrid.shape
    _close(got, want)
    # its last slice is the Gauss-Newton transport's result
    last = semilag.transport_inc_state(_t(vt), both.state.grad_rho_series, both.state.plan)
    torch.testing.assert_close(got[-1], last, rtol=0, atol=0)


@pytest.mark.parametrize("given_div", [False, True], ids=["own_div", "given_div"])
def test_inc_adjoint_newton_matches_jax(both, rng, given_div):
    vt = both.field(rng)
    lam1 = rng.standard_normal(both.jgrid.shape).astype(np.float32) * 0.1
    jdiv = tdiv = None
    if given_div:
        jdiv = both.jops.div(both.jstate.lam_series[:, None] * jnp.asarray(vt)[None])
        tdiv = both.ops.div(both.state.lam_series[:, None] * _t(vt)[None])
    want = jsemilag.transport_inc_adjoint_newton(
        jnp.asarray(lam1), both.jstate.lam_series, jnp.asarray(vt), both.jstate.plan,
        both.jops, div_lam_vt=jdiv)
    got = semilag.transport_inc_adjoint_newton(
        _t(lam1), both.state.lam_series, _t(vt), both.state.plan, both.ops, div_lam_vt=tdiv)
    assert got.shape == want.shape == (N_T + 1,) + both.jgrid.shape
    _close(got, want)
    np.testing.assert_array_equal(got[-1].numpy(), lam1)  # t = 1 is the terminal value


def test_full_hessian_matvec_matches_jax(both, rng):
    vt = both.field(rng)
    want = jobj.full_hessian_matvec(jnp.asarray(vt), both.jstate, both.jprob, both.jops)
    got = obj.full_hessian_matvec(_t(vt), both.state, both.prob, both.ops)
    _close(got, want)


# --------------------------------------------------------------------------- #
# the reference's properties (tests/test_gradient.py:98-133), on the port
# --------------------------------------------------------------------------- #
def test_full_newton_hessian_is_exact_second_derivative(both, rng):
    grid, prob, ops, st = both.grid, both.prob, both.ops, both.state
    v0 = _t(both.v0)
    w = _t(both.field(rng))
    hww = float(grid.inner(obj.full_hessian_matvec(w, st, prob, ops), w))

    def j(vv):
        return float(obj.evaluate_objective(vv, prob, ops)[0])

    e = 3e-2
    fd2 = (j(v0 + e * w) - 2 * j(v0) + j(v0 - e * w)) / e**2
    assert abs(fd2 - hww) / max(abs(fd2), 1e-8) < 2e-2


def test_full_newton_symmetric_and_matches_gn_at_solution(both, rng):
    grid, prob, ops, st = both.grid, both.prob, both.ops, both.state
    u, w = _t(both.field(rng)), _t(both.field(rng))
    hu = obj.full_hessian_matvec(u, st, prob, ops)
    hw = obj.full_hessian_matvec(w, st, prob, ops)
    a, b = float(grid.inner(hu, w)), float(grid.inner(u, hw))
    assert abs(a - b) < 1e-2 * max(abs(a), abs(b), 1e-6)
    prob0 = obj.Problem(grid, prob.rho_T, prob.rho_T, prob.beta, prob.n_t,
                        both.incompressible)
    st0 = obj.newton_state(torch.zeros_like(u), prob0, ops)
    torch.testing.assert_close(obj.full_hessian_matvec(w, st0, prob0, ops),
                               obj.gn_hessian_matvec(w, st0, prob0, ops), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------- #
# a whole full-Newton solve against the reference's
# --------------------------------------------------------------------------- #
SOLVE_KW = dict(beta=BETA, n_t=N_T, max_newton=10, gtol=1e-2, max_cg=50, gauss_newton=False)
# ROADMAP Queue C 8: the compressible solve amplifies roundoff at Newton
# iteration 3 in both packages (the reference's own step moves by 9.2e-4 of
# the largest value when its input moves by 3e-5); the final velocities are
# then held to tests/test_cohort.py's whole-solve bar, of the largest value
# (measured: 4.3e-4; bench_torch/full_newton_compare.py)
PARTED_V_RTOL = 5e-4
STEP_V_RTOL = 5e-5  # one step from the reference's iterate (measured: up to 1.2e-5)


def _solve_problem(incompressible):
    rho_R, rho_T, _, jgrid = jsyn.synthetic_problem(N, amplitude=0.5,
                                                     incompressible=incompressible)
    return rho_R, rho_T, jgrid, dict(SOLVE_KW, incompressible=incompressible)


@pytest.mark.parametrize("incompressible", [False, True], ids=["compressible", "incompressible"])
def test_full_newton_solve_matches_jax(incompressible):
    rho_R, rho_T, jgrid, kw = _solve_problem(incompressible)
    want = jgn.solve(rho_R, rho_T, jgrid, jgn.GNConfig(**kw))
    got = gn.solve(_t(rho_R), _t(rho_T), make_grid(N), gn.GNConfig(**kw), device="cpu")
    assert got["newton_iters"] == want["newton_iters"]
    for key in ("cg_iters", "armijo_trials", "status"):
        assert [h[key] for h in got["history"]] == [h[key] for h in want["history"]], key
    assert got["status"] == want["status"]
    dv = float(np.abs(got["v"].numpy() - np.asarray(want["v"])).max())
    if incompressible:
        assert dv < V_TOL, dv
    else:
        assert dv / float(np.abs(np.asarray(want["v"])).max()) < PARTED_V_RTOL, dv
    # it is not the Gauss-Newton solve
    gauss = gn.solve(_t(rho_R), _t(rho_T), make_grid(N),
                     gn.GNConfig(**{**kw, "gauss_newton": True}), device="cpu")
    assert not torch.equal(gauss["v"], got["v"])


@pytest.mark.parametrize("incompressible", [False, True], ids=["compressible", "incompressible"])
def test_full_newton_step_matches_jax_step_by_step(incompressible):
    """From each of the reference's own iterates, the port's full-Newton
    step takes the reference's PCG iterations and Armijo trials and gives
    its velocity to STEP_V_RTOL (ROADMAP Queue C 8)."""
    rho_R, rho_T, jgrid, kw = _solve_problem(incompressible)
    jcfg, cfg = jgn.GNConfig(**kw), gn.GNConfig(**kw)
    jops, ops = JOps(jgrid), SpectralOps(make_grid(N), device="cpu")
    jprob = jobj.Problem(jgrid, rho_R, rho_T, BETA, N_T, incompressible)
    prob = obj.Problem(make_grid(N), _t(rho_R), _t(rho_T), BETA, N_T, incompressible)
    want = jgn.solve(rho_R, rho_T, jgrid, jcfg)
    v = jnp.zeros((3,) + jgrid.shape, jnp.float32)
    g0 = jnp.float32(1e-30)
    for it in range(want["newton_iters"]):
        jv, jlog = jgn.newton_iteration(v, g0, jprob, jops, jcfg)
        tv, tlog = gn.newton_iteration(_t(v), torch.tensor(float(g0)), prob, ops, cfg)
        assert (tlog.cg_iters, tlog.ls_iters, tlog.status) == (
            int(jlog.cg_iters), int(jlog.ls_iters), int(jlog.status)), it
        assert _rel(tv, jv) < STEP_V_RTOL, (it, _rel(tv, jv))
        if it == 0:
            g0 = jlog.gnorm
        v = jv


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def test_full_newton_refuses_a_cohort():
    grid = make_grid(8)
    cfg = gn.GNConfig(gauss_newton=False, n_t=2)
    zeros = torch.zeros((2,) + grid.shape)
    for call in (lambda: gn.make_cohort_step(grid, cfg, device="cpu"),
                 lambda: gn.solve_cohort(zeros, zeros, grid, cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="Gauss-Newton Hessian only"):
            call()
    with pytest.raises(NotImplementedError, match="no cohort path"):
        obj.full_hessian_matvec(torch.zeros((2, 3) + grid.shape), None, None, None)


# --------------------------------------------------------------------------- #
# spectral operators
# --------------------------------------------------------------------------- #
SHAPE = (12, 10, 9)
BATCH_OPS = {
    # operator name -> (positional args, keyword args) on a scalar f and a vector v
    "grad": lambda f, v: ((f,), {}),
    "div": lambda f, v: ((v,), {}),
    "laplacian": lambda f, v: ((f,), {}),
    "biharmonic": lambda f, v: ((f,), {}),
    "inv_laplacian": lambda f, v: ((f,), {}),
    "inv_biharmonic": lambda f, v: ((f,), {"zero_mode": 0.5}),
    "reg_apply": lambda f, v: ((v, BETA), {}),
    "precond_apply": lambda f, v: ((v, BETA), {}),
    "leray": lambda f, v: ((v,), {}),
    "precond_project": lambda f, v: ((v, BETA, True), {}),
    "reg_plus_project": lambda f, v: ((v, 2.0 * v, BETA, True), {}),
    "smooth": lambda f, v: ((f,), {}),
    "reg_energy": lambda f, v: ((v, BETA), {}),
}


@pytest.fixture(scope="module")
def spectral_pair():
    return JOps(jmake_grid(SHAPE)), SpectralOps(make_grid(SHAPE), device="cpu")


def _fields(rng):
    f = rng.standard_normal(SHAPE).astype(np.float32)
    v = rng.standard_normal((3,) + SHAPE).astype(np.float32)
    return f, v


def _convert(args, to):
    return tuple(to(a) if isinstance(a, np.ndarray) else a for a in args)


@pytest.mark.parametrize("name", sorted(BATCH_OPS))
def test_spectral_batch_operator_matches_jax(spectral_pair, rng, name):
    """Each of the reference's 13 ``SpectralBatch`` operators, alone and
    coalesced with a ``div`` of another input into one transform pair."""
    jops, ops = spectral_pair
    f, v = _fields(rng)
    args, kw = BATCH_OPS[name](f, v)
    w = rng.standard_normal((3,) + SHAPE).astype(np.float32)
    with jops.batch() as jsb:
        jh = getattr(jsb, name)(*_convert(args, jnp.asarray), **kw)
        jd = jsb.div(jnp.asarray(w))
    with ops.batch() as sb:
        h = getattr(sb, name)(*_convert(args, _t), **kw)
        d = sb.div(_t(w))
    want, got = np.asarray(jh.get()), h.get()
    assert tuple(got.shape) == want.shape
    if name == "reg_energy":  # ROADMAP "Reference state": Parseval energies at ~1e-5
        np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
    else:
        _close(got, want, rel=SPECTRAL_RTOL)
    _close(d.get(), jd.get(), rel=SPECTRAL_RTOL)
    # the batch's result is the eager operator's
    if name != "reg_energy":
        _close(got, getattr(ops, name)(*_convert(args, _t), **kw), rel=SPECTRAL_RTOL)


@pytest.mark.parametrize("name,kw", [("biharmonic", {}), ("inv_laplacian", {}),
                                     ("inv_biharmonic", {}),
                                     ("inv_biharmonic", {"zero_mode": 2.0})])
def test_eager_spectral_operator_matches_jax(spectral_pair, rng, name, kw):
    jops, ops = spectral_pair
    f, _ = _fields(rng)
    want = getattr(jops, name)(jnp.asarray(f), **kw)
    _close(getattr(ops, name)(_t(f), **kw), want, rel=SPECTRAL_RTOL)


def test_inverse_operators_invert(spectral_pair, rng):
    _, ops = spectral_pair
    f, _ = _fields(rng)
    f = _t(f - f.mean())  # zero mean: the inverses map the mean mode to 0
    _close(ops.inv_laplacian(ops.laplacian(f)), f, rel=1e-4)
    _close(ops.inv_biharmonic(ops.biharmonic(f)), f, rel=1e-4)


# --------------------------------------------------------------------------- #
# the plain helpers of kernels/ref.py and kernels/ops.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk", [None, 64, 1000])
def test_tricubic_points_matches_jax(rng, chunk):
    field = rng.standard_normal(SHAPE).astype(np.float32)
    coords = rng.uniform(-20.0, 20.0, (3, 7, 11)).astype(np.float32)
    want = jkops.tricubic_points(jnp.asarray(field), jnp.asarray(coords), chunk=chunk)
    got = kops.tricubic_points(_t(field), _t(coords), chunk=chunk)
    assert tuple(got.shape) == (7, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.tricubic_points(_t(field), _t(coords)).numpy())


def test_tricubic_points_chunked_matches_jax(rng):
    field = rng.standard_normal(SHAPE).astype(np.float32)
    coords = rng.uniform(-5.0, 15.0, (3, 130)).astype(np.float32)
    want = jref.tricubic_points_chunked(jnp.asarray(field), jnp.asarray(coords), 32)
    got = ref.tricubic_points_chunked(_t(field), _t(coords), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_max_displacement_and_spectral_scale_match_jax(rng):
    disp = rng.uniform(-9.0, 9.0, (3,) + SHAPE).astype(np.float32)
    assert float(kops.max_displacement(_t(disp))) == float(
        jkops.max_displacement(jnp.asarray(disp)))
    re_, im_, sc = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3))
    want = jref.spectral_scale(jnp.asarray(re_), jnp.asarray(im_), jnp.asarray(sc))
    got = ref.spectral_scale(_t(re_), _t(im_), _t(sc))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
