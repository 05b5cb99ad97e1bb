"""Port parity: every ``SpectralOps`` operator of the port's main path and
incompressible mode against ``repro.core.spectral``, on the same numpy
fields, plus the grid helpers and ``SpectralBatch``'s coalescing.

Both sides run float32 FFTs of different libraries (XLA's on the JAX side,
``torch.fft`` here), so fields agree to ~1e-6 of their largest value; the
tolerance is 1e-5 of it.  The Parseval energy is a float32 sum over every
mode and agrees to 2e-5 relative (ROADMAP, "Reference state").
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.grid import make_grid as jmake_grid  # noqa: E402
from repro.core.spectral import SpectralOps as JOps  # noqa: E402
from repro_torch.core.grid import make_grid  # noqa: E402
from repro_torch.core.spectral import SpectralOps  # noqa: E402

SHAPES = [(16, 16, 16), (12, 10, 9)]
BETA = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The fields here are 16^3 at most: intra-op threads only contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * scale)


def _ops(shape):
    return SpectralOps(make_grid(shape), device="cpu"), JOps(jmake_grid(shape))


def _field(rng, lead, shape):
    # smooth-ish fields: decaying spectrum, as images and velocities are
    x = rng.standard_normal(lead + shape).astype(np.float32)
    spec = np.fft.fftn(x, axes=(-3, -2, -1))
    k = np.meshgrid(*[np.fft.fftfreq(n, 1.0 / n) for n in shape], indexing="ij")
    spec /= (1.0 + sum(ki**2 for ki in k)) ** 1.5
    return np.fft.ifftn(spec, axes=(-3, -2, -1)).real.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_matches_jax(shape):
    g, jg = make_grid(shape), jmake_grid(shape)
    assert g.spacing == jg.spacing and g.cell_volume == jg.cell_volume
    np.testing.assert_array_equal(g.coords("cpu", torch.float64).numpy(), jg.coords)
    np.testing.assert_array_equal(g.coords("cpu").numpy(), np.asarray(jg.coords_jnp()))
    for a, b in zip(g.k_deriv(), jg.k_deriv()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_inner_matches_jax(rng, shape):
    a, b = _field(rng, (3,), shape), _field(rng, (3,), shape)
    g, jg = make_grid(shape), jmake_grid(shape)
    got = float(g.inner(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(float(jg.inner(jnp.asarray(a), jnp.asarray(b))), rel=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize(
    "op",
    ["grad", "div", "laplacian", "leray", "smooth", "reg_apply", "precond_apply"],
)
def test_operator_matches_jax(rng, shape, op):
    ops, jops = _ops(shape)
    lead = (3,) if op in ("div", "leray", "reg_apply", "precond_apply") else ()
    f = _field(rng, lead, shape)
    args = (BETA,) if op in ("reg_apply", "precond_apply") else ()
    got = getattr(ops, op)(torch.from_numpy(f), *args)
    _close(got, getattr(jops, op)(jnp.asarray(f), *args))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("incompressible", [False, True])
def test_fused_operators_match_jax(rng, shape, incompressible):
    ops, jops = _ops(shape)
    a, b = _field(rng, (3,), shape), _field(rng, (3,), shape)
    got = ops.reg_plus_project(torch.from_numpy(a), torch.from_numpy(b), BETA, incompressible)
    _close(got, jops.reg_plus_project(jnp.asarray(a), jnp.asarray(b), BETA, incompressible))
    got = ops.precond_project(torch.from_numpy(a), BETA, incompressible)
    _close(got, jops.precond_project(jnp.asarray(a), BETA, incompressible))


@pytest.mark.parametrize("shape", SHAPES)
def test_reg_energy_matches_jax(rng, shape):
    ops, jops = _ops(shape)
    v = _field(rng, (3,), shape)
    got = float(ops.reg_energy(torch.from_numpy(v), BETA))
    assert got == pytest.approx(float(jops.reg_energy(jnp.asarray(v), BETA)), rel=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_jacobian_det_matches_jax(rng, shape):
    ops, jops = _ops(shape)
    u = 0.3 * _field(rng, (3,), shape)
    _close(ops.jacobian_det(torch.from_numpy(u)), jops.jacobian_det(jnp.asarray(u)))


def test_leray_projects_to_divergence_free(rng):
    ops, _ = _ops((16, 16, 16))
    p = ops.leray(torch.from_numpy(_field(rng, (3,), (16, 16, 16))))
    assert float(ops.div(p).abs().max()) < 1e-5 * float(p.abs().max())
    torch.testing.assert_close(ops.leray(p), p, atol=1e-6, rtol=1e-5)


def test_batch_coalesces_and_matches_eager(rng, monkeypatch):
    """One forward over the deduplicated inputs, one inverse over the
    real-destined outputs; the energy joins no inverse."""
    shape = (12, 10, 9)
    ops, _ = _ops(shape)
    v = torch.from_numpy(_field(rng, (3,), shape))
    r = torch.from_numpy(_field(rng, (3,), shape))
    calls = {"fwd": 0, "inv": 0}
    fields = {}
    fwd, inv = ops.fwd_real, ops.inv_real

    def count(name, fn):
        def wrapped(x):
            calls[name] += 1
            fields[name] = x.shape[0]
            return fn(x)

        return wrapped

    monkeypatch.setattr(ops, "fwd_real", count("fwd", fwd))
    monkeypatch.setattr(ops, "inv_real", count("inv", inv))
    with ops.batch() as sb:
        h_div = sb.div(v)
        h_reg = sb.reg_apply(v, BETA)
        h_e = sb.reg_energy(v, BETA)
        h_r = sb.reg_apply(r, BETA)
    assert calls == {"fwd": 1, "inv": 1}
    # forward: v once and r once; inverse: div v (1) + reg v (3) + reg r (3)
    assert fields == {"fwd": 6, "inv": 7}
    monkeypatch.setattr(ops, "fwd_real", fwd)
    monkeypatch.setattr(ops, "inv_real", inv)
    torch.testing.assert_close(h_div.get(), ops.div(v), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h_reg.get(), ops.reg_apply(v, BETA), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h_e.get(), ops.reg_energy(v, BETA))
    torch.testing.assert_close(h_r.get(), ops.reg_apply(r, BETA), atol=1e-5, rtol=1e-5)
    with pytest.raises(RuntimeError, match="already ran"):
        sb.div(v)


def test_field_dtype_is_refused():
    with pytest.raises(NotImplementedError, match="item 12"):
        SpectralOps(make_grid(8), device="cpu", field_dtype="bfloat16")
