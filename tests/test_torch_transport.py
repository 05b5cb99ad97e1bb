"""Port parity: the planner, the semi-Lagrangian transports and the
objective's gradient and Gauss-Newton Hessian matvec against ``repro.core``,
on the paper's synthetic velocity at 16^3 and on a non-cubic grid.

Both sides build their plans from the same velocity; the transported
series agree at 1e-4 (``tests/test_interp_plan.py``'s tolerance).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import objective as jobj  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import semilag as jsemilag  # noqa: E402
from repro.core.grid import make_grid as jmake_grid  # noqa: E402
from repro.core.spectral import SpectralOps as JOps  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro_torch.core import objective as obj  # noqa: E402
from repro_torch.core import planner, semilag  # noqa: E402
from repro_torch.core.grid import make_grid  # noqa: E402
from repro_torch.core.spectral import SpectralOps  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = [(16, 16, 16), (12, 10, 9)]
N_T = 4


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


def _close(got, want, rel=1e-4):
    """Agreement to ``rel`` of the reference field's largest value."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=rel, atol=rel * scale)


class Setup:
    """One problem on both sides: grid, ops, interp, velocity, images."""

    def __init__(self, shape, incompressible, amplitude=1.0):
        self.jgrid, self.grid = jmake_grid(shape), make_grid(shape)
        self.jops, self.ops = JOps(self.jgrid), SpectralOps(self.grid, device="cpu")
        self.jinterp, self.interp = jkops.make_interp(method="ref"), kops.make_interp()
        make_v = jsyn.paper_velocity_divfree if incompressible else jsyn.paper_velocity
        self.v = np.asarray(make_v(self.jgrid, amplitude))
        self.rho_T = np.asarray(jsyn.paper_template(self.jgrid))
        x = self.jgrid.coords
        self.rho_R = (0.5 + 0.3 * np.sin(x[0] + 0.4) * np.cos(x[1]) * np.sin(2 * x[2])).astype(
            np.float32
        )
        self.incompressible = incompressible

    def plans(self, adjoint=True):
        jp = jplanner.make_plan(
            jnp.asarray(self.v), self.jgrid, self.jops, N_T, self.incompressible,
            self.jinterp, adjoint=adjoint,
        )
        p = planner.make_plan(
            _t(self.v), self.grid, self.ops, N_T, self.incompressible, self.interp,
            adjoint=adjoint,
        )
        return jp, p

    def problems(self, beta=1e-2):
        jprob = jobj.Problem(self.jgrid, jnp.asarray(self.rho_R), jnp.asarray(self.rho_T),
                             beta, N_T, self.incompressible)
        prob = obj.Problem(self.grid, _t(self.rho_R), _t(self.rho_T), beta, N_T,
                           self.incompressible)
        return jprob, prob


@pytest.mark.parametrize("shape", SHAPES)
def test_departure_displacement_matches_jax(shape):
    s = Setup(shape, False, amplitude=2.0)
    want = jplanner.departure_displacement(jnp.asarray(s.v), s.jgrid, 0.25, s.jinterp)
    got = planner.departure_displacement(_t(s.v), s.grid, 0.25, s.interp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("incompressible", [False, True])
def test_plan_matches_jax(incompressible):
    s = Setup((16, 16, 16), incompressible)
    jp, p = s.plans()
    for name in ("disp_fwd", "disp_adj"):
        np.testing.assert_allclose(getattr(p, name).numpy(), getattr(jp, name), **TOL)
    assert (p.divv is None) == (jp.divv is None) == incompressible
    if not incompressible:
        _close(p.divv, jp.divv, rel=1e-5)
    assert float(planner.required_halo(p)) == float(jplanner.required_halo(jp))
    fwd_only = planner.make_plan(_t(s.v), s.grid, s.ops, N_T, False, s.interp, adjoint=False)
    assert fwd_only.disp_adj is None and fwd_only.iplan_adj is None
    with pytest.raises(ValueError, match="forward-only"):
        semilag.transport_adjoint(_t(s.rho_R), fwd_only, s.interp)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("incompressible", [False, True])
def test_transports_match_jax(shape, incompressible):
    s = Setup(shape, incompressible)
    jp, p = s.plans()
    _close(semilag.transport_state(_t(s.rho_T), p, s.interp),
           jsemilag.transport_state(jnp.asarray(s.rho_T), jp, s.jinterp))
    _close(semilag.transport_adjoint(_t(s.rho_R), p, s.interp),
           jsemilag.transport_adjoint(jnp.asarray(s.rho_R), jp, s.jinterp))
    _close(semilag.deformation_displacement(_t(s.v), p, s.interp),
           jsemilag.deformation_displacement(jnp.asarray(s.v), jp, s.jinterp))


def test_incremental_transports_and_quadrature_match_jax(rng):
    s = Setup((16, 16, 16), False)
    jp, p = s.plans()
    grad = rng.standard_normal((N_T + 1, 3, 16, 16, 16)).astype(np.float32)
    lam = rng.standard_normal((N_T + 1, 16, 16, 16)).astype(np.float32)
    vt = 0.1 * rng.standard_normal((3, 16, 16, 16)).astype(np.float32)
    _close(semilag.transport_inc_state(_t(vt), _t(grad), p, s.interp),
           jsemilag.transport_inc_state(jnp.asarray(vt), jnp.asarray(grad), jp, s.jinterp))
    _close(semilag.time_integral_b(_t(lam), _t(grad), p.dt),
           jsemilag.time_integral_b(jnp.asarray(lam), jnp.asarray(grad), jp.dt), rel=1e-5)


@pytest.mark.parametrize("incompressible", [False, True])
def test_newton_state_and_hessian_match_jax(rng, incompressible):
    s = Setup((16, 16, 16), incompressible)
    v = 0.5 * s.v
    jprob, prob = s.problems()
    jst = jobj.newton_state(jnp.asarray(v), jprob, s.jops, s.jinterp)
    st = obj.newton_state(_t(v), prob, s.ops, s.interp)
    for name in ("misfit", "reg", "j_val"):
        assert float(getattr(st, name)) == pytest.approx(float(getattr(jst, name)), rel=1e-4)
    _close(st.g, jst.g)
    _close(st.lam_series, jst.lam_series)
    _close(st.grad_rho_series, jst.grad_rho_series)

    vt = s.ops.smooth(torch.from_numpy(rng.standard_normal((3, 16, 16, 16)).astype(np.float32)))
    if incompressible:
        vt = s.ops.leray(vt)
    want = jobj.gn_hessian_matvec(jnp.asarray(vt.numpy()), jst, jprob, s.jops, s.jinterp)
    _close(obj.gn_hessian_matvec(vt, st, prob, s.ops, s.interp), want)

    jval, _ = jobj.evaluate_objective(jnp.asarray(v), jprob, s.jops, s.jinterp)
    val, (misfit, reg, series, plan) = obj.evaluate_objective(_t(v), prob, s.ops, s.interp)
    assert float(val) == pytest.approx(float(jval), rel=1e-4)
    assert plan.iplan_adj is None


def test_gradient_matches_directional_derivative():
    """<g, w> against a central difference of J: the port's gradient is the
    derivative of its own objective, not only a copy of the reference's."""
    s = Setup((16, 16, 16), False)
    _, prob = s.problems()
    v = _t(0.3 * s.v)
    w = s.ops.smooth(_t(np.roll(s.v, 3, axis=1)))
    st = obj.newton_state(v, prob, s.ops, s.interp)
    eps = 1e-2
    jp, _ = obj.evaluate_objective(v + eps * w, prob, s.ops, s.interp)
    jm, _ = obj.evaluate_objective(v - eps * w, prob, s.ops, s.interp)
    fd = (float(jp) - float(jm)) / (2 * eps)
    assert float(s.grid.inner(st.g, w)) == pytest.approx(fd, rel=5e-2)
