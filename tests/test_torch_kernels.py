"""Port parity: the plain versions of the tricubic kernels against the JAX
package, and the dispatch, build and device rules around the CUDA kernels.

The same numpy inputs go to ``repro.kernels`` (on the CPU) and to
``repro_torch.kernels`` (``device="cpu"``, so the plain versions run).
The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.tricubic import (  # noqa: E402
    tricubic_apply_pallas,
    tricubic_displace_pallas_many,
)
from repro_torch import convert  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build, ops, ref, tricubic  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_interp_plan.py
KERNEL_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_kernels.py
# a cubic and a non-cubic shape; (12, 20, 9) has N3 % 8 != 0
SHAPES = [(16, 16, 16), (12, 20, 9)]


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


def _problem(rng, shape, c, lim):
    f = rng.standard_normal((c,) + shape).astype(np.float32)
    d = rng.uniform(-lim, lim, (3,) + shape).astype(np.float32)
    return f, d


def test_lagrange_weights_match_jax(rng):
    t = rng.uniform(0, 1, 1000).astype(np.float32)
    np.testing.assert_allclose(
        ref.lagrange_weights(_t(t)).numpy(), jref.lagrange_weights(jnp.asarray(t)),
        atol=1e-6, rtol=0,
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_interp_plan_matches_jax(rng, shape):
    _, d = _problem(rng, shape, 1, lim=6.5)
    want = jref.make_interp_plan(jnp.asarray(d))
    got = ref.make_interp_plan(_t(d))
    np.testing.assert_array_equal(got.ib.numpy(), np.asarray(want.ib))
    assert got.ib.dtype == torch.int32 and got.w.shape == (3, 4) + shape
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), atol=1e-6, rtol=0)
    assert float(got.halo_need) == float(want.halo_need)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", [1, 2, 3])
def test_planned_apply_matches_jax_beyond_halo(rng, shape, c):
    """The plain K1 wraps periodically: exact for displacements above any halo."""
    f, d = _problem(rng, shape, c, lim=7.0)
    assert np.abs(d).max() > 4
    want = jref.interp_apply(jnp.asarray(f), jref.make_interp_plan(jnp.asarray(d)))
    got = ref.interp_apply(_t(f), ref.make_interp_plan(_t(d)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_displace_many_matches_jax_beyond_halo(rng, shape):
    f, d = _problem(rng, shape, 3, lim=7.0)
    want = jref.tricubic_displace_many(jnp.asarray(f), jnp.asarray(d))
    got = ref.tricubic_displace_many(_t(f), _t(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scalar_forms_match_jax(rng):
    shape = (12, 20, 9)
    f, d = _problem(rng, shape, 1, lim=7.0)
    np.testing.assert_allclose(
        ref.tricubic_displace(_t(f[0]), _t(d)).numpy(),
        np.asarray(jref.tricubic_displace(jnp.asarray(f[0]), jnp.asarray(d))), **TOL,
    )
    q = rng.uniform(-30, 30, (3, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        ref.tricubic_points(_t(f[0]), _t(q)).numpy(),
        np.asarray(jref.tricubic_points(jnp.asarray(f[0]), jnp.asarray(q))), **TOL,
    )


def test_chunked_gather_matches_one_chunk(rng, monkeypatch):
    f, d = _problem(rng, (8, 12, 10), 2, lim=5.0)
    plan = ref.make_interp_plan(_t(d))
    whole = ref.interp_apply(_t(f), plan)
    monkeypatch.setattr(ref, "CHUNK", 97)
    np.testing.assert_array_equal(ref.interp_apply(_t(f), plan).numpy(), whole.numpy())


@pytest.mark.parametrize("c", [1, 2])
def test_plain_kernels_match_pallas_interpret(rng, c):
    """Against the TPU kernels in interpret mode, at a tile-divisible shape
    with |disp| within their halo (the only inputs they accept)."""
    shape, tile, halo = (8, 8, 16), (4, 4, 8), 4
    f, d = _problem(rng, shape, c, lim=halo - 0.05)
    jplan = jref.make_interp_plan(jnp.asarray(d))
    want = tricubic_apply_pallas(jnp.asarray(f), jplan, tile=tile, halo=halo, interpret=True)
    got = ref.interp_apply(_t(f), ref.make_interp_plan(_t(d)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    want = tricubic_displace_pallas_many(
        jnp.asarray(f), jnp.asarray(d), tile=tile, halo=halo, interpret=True
    )
    got = ref.tricubic_displace_many(_t(f), _t(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_plan_from_numpy_carries_the_jax_plan(rng):
    f, d = _problem(rng, (8, 12, 16), 2, lim=5.0)
    jplan = jref.make_interp_plan(jnp.asarray(d))
    plan = convert.plan_from_numpy(jplan.ib, jplan.w, jplan.halo_need, device="cpu")
    want = jref.interp_apply(jnp.asarray(f), jplan)
    got = ref.interp_apply(convert.field_from_numpy(f, device="cpu"), plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------------- #
# dispatch: the tensor's device picks the kernel; nothing falls back
# ----------------------------------------------------------------------- #
def test_auto_takes_plain_version_on_cpu(rng):
    f, d = _problem(rng, (8, 8, 8), 3, lim=5.0)
    tricubic.reset_launches()
    interp = ops.make_interp()
    plan = interp.make_plan(_t(d))
    torch.testing.assert_close(interp.apply_plan(_t(f), plan), ref.interp_apply(_t(f), plan))
    torch.testing.assert_close(interp(_t(f), _t(d)), ref.tricubic_displace_many(_t(f), _t(d)))
    assert tricubic.LAUNCHES == {"tricubic_apply": 0, "tricubic_displace_many": 0}


def test_cuda_method_and_wrappers_refuse_cpu_tensors(rng):
    f, d = _problem(rng, (8, 8, 8), 2, lim=5.0)
    plan = ref.make_interp_plan(_t(d))
    with pytest.raises(ValueError, match="CUDA"):
        ops.make_interp("cuda").apply_plan(_t(f), plan)
    with pytest.raises(ValueError, match="CUDA"):
        ops.make_interp("cuda")(_t(f), _t(d))
    with pytest.raises(ValueError, match="CUDA"):
        tricubic.tricubic_apply_cuda(_t(f), plan)
    with pytest.raises(ValueError, match="CUDA"):
        tricubic.tricubic_displace_many_cuda(_t(f), _t(d))
    with pytest.raises(ValueError, match="method"):
        ops.make_interp("pallas")


def test_device_helper_raises_instead_of_falling_back(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda:0")


def test_build_is_keyed_by_source_and_ignored_by_git():
    assert build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
    assert build.build_dir().parent == build.BUILD_ROOT
    assert build.BUILD_ROOT.relative_to(ROOT).parts[0] == "build"
    assert len(build.source_hash()) == 16 and build.source_hash() == build.source_hash()
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
    src = build.SOURCES[0].read_text()
    for name in ("tricubic_apply_f32", "tricubic_displace_many_f32"):
        assert f'extern "C" int {name}(' in src
        assert name in build.SIGNATURES
    for replaced in ("_kernel_planned", "_kernel_many"):
        assert replaced in src


def test_port_imports_neither_jax_nor_repro():
    """Static: no import line names jax or repro.  Dynamic: every module
    imports with both blocked."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    offenders = [p for p in files if pattern.search(open(p).read())]
    assert not offenders, offenders
    modules = sorted(
        os.path.relpath(p, os.path.join(ROOT, "src"))[:-3].replace(os.sep, ".")
        for p in files
        if "repro_torch" in p
    )
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "import chip_smoke\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
