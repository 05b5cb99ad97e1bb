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

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.tricubic import (  # noqa: E402
    tricubic_apply_pallas,
    tricubic_displace_pallas,
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


def _stepwise_sum4(p):
    """((p0 + p1) + p2) + p3 in numpy float32, each addition rounded."""
    return ((p[0] + p[1]) + p[2]) + p[3]


def _stepwise_lagrange(t):
    """The Lagrange weights term for term, each f32 operation rounded (numpy),
    with /6 as a product with the f32 reciprocal."""
    sixth, half, one, two = (np.float32(x) for x in (1.0 / 6.0, 0.5, 1.0, 2.0))
    return np.stack([
        -t * (t - one) * (t - two) * sixth,
        (t + one) * (t - one) * (t - two) * half,
        -(t + one) * t * (t - two) * half,
        (t + one) * t * (t - one) * sixth,
    ])


def test_rounding_contract_dot4_order(rng):
    """ref._dot4 adds in the kernels' order (the rounding contract of
    csrc/tricubic.cu), bit for bit; another order rounds differently."""
    v = (rng.standard_normal((4, 4096)) * 10.0 ** rng.integers(-3, 4, (4, 4096)))
    v = v.astype(np.float32)
    w = rng.uniform(-0.2, 1.2, (4, 4096)).astype(np.float32)
    want = _stepwise_sum4(v * w)
    np.testing.assert_array_equal(ref._dot4(_t(v), _t(w)).numpy(), want)
    assert not np.array_equal(_stepwise_sum4((v * w)[::-1]), want)


def test_rounding_contract_lagrange_weights(rng):
    t = rng.uniform(0.0, 1.0, 4096).astype(np.float32)
    want = _stepwise_lagrange(t)
    np.testing.assert_array_equal(ref.lagrange_weights(_t(t)).numpy(), want)
    divided = (t + np.float32(1)) * t * (t - np.float32(1)) / np.float32(6)
    assert not np.array_equal(divided, want[3])


def test_rounding_contract_planned_apply(rng):
    """The plain planned apply is the kernels' contraction evaluated step by
    step in f32: axis 1, then 2, then 3, each sum in _stepwise_sum4's order."""
    shape = (5, 6, 7)
    f, d = _problem(rng, shape, 1, lim=9.0)
    plan = ref.make_interp_plan(_t(d))
    ib, w = plan.ib.numpy(), plan.w.numpy()
    home = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"))
    idx = [[(home[i] + ib[i] + a - 1) % shape[i] for a in range(4)] for i in range(3)]
    s2 = [[_stepwise_sum4([f[0][idx[0][a], idx[1][b], idx[2][e]] * w[0, a]
                           for a in range(4)]) for e in range(4)] for b in range(4)]
    s3 = [_stepwise_sum4([s2[b][e] * w[1, b] for b in range(4)]) for e in range(4)]
    want = _stepwise_sum4([s3[e] * w[2, e] for e in range(4)])
    np.testing.assert_array_equal(ref.interp_apply(_t(f), plan).numpy()[0], want)


def test_rounding_contract_build_flag():
    """The kernels are built without FMA contraction, the contract is stated
    in the kernels' source, and a build with other flags has its own
    directory."""
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "Rounding contract." in build.SOURCES[0].read_text()
    fused = tuple("-fmad=true" if f == "-fmad=false" else f for f in build.NVCC_FLAGS)
    assert build.build_dir(fused) != build.build_dir()


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


@pytest.mark.parametrize("halo", [2, 4, 6])
def test_plain_single_field_displace_matches_jax_and_pallas(rng, halo):
    """K3's plain version against the JAX oracle and the TPU kernel in
    interpret mode (the cases of tests/test_kernels.py's halo sweep)."""
    shape, tile = (16, 16, 32), (8, 8, 16)
    f = rng.standard_normal(shape).astype(np.float32)
    d = rng.uniform(-halo + 0.05, halo - 0.05, (3,) + shape).astype(np.float32)
    got = ops.tricubic_displace(_t(f), _t(d)).numpy()
    want = tricubic_displace_pallas(
        jnp.asarray(f), jnp.asarray(d), tile=tile, halo=halo, interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(want), **KERNEL_TOL)
    want = jref.tricubic_displace(jnp.asarray(f), jnp.asarray(d))
    np.testing.assert_allclose(got, np.asarray(want), **KERNEL_TOL)


def test_plain_single_field_displace_zero_disp_exact(rng):
    shape = (8, 8, 32)
    f = rng.standard_normal(shape).astype(np.float32)
    zero = np.zeros((3,) + shape, np.float32)
    want = tricubic_displace_pallas(
        jnp.asarray(f), jnp.asarray(zero), tile=(4, 4, 16), halo=2, interpret=True
    )
    np.testing.assert_allclose(np.asarray(want), f, atol=1e-6)
    np.testing.assert_allclose(ref.tricubic_displace(_t(f), _t(zero)).numpy(), f, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_displace_vec_matches_jax(rng, shape):
    """ops.tricubic_displace_vec, the reference's public C-field entry (a
    vmap of its single-field displace), on the same numpy inputs, with
    displacements beyond any halo."""
    f, d = _problem(rng, shape, 3, lim=7.0)
    want = jops.tricubic_displace_vec(jnp.asarray(f), jnp.asarray(d))
    got = ops.tricubic_displace_vec(_t(f), _t(d))
    assert got.shape == (3,) + shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_displace_vec_matches_pallas_interpret(rng):
    """The same against the reference's vmap over its TPU kernel in
    interpret mode, at a tile-divisible shape with |disp| within its halo."""
    shape, tile, halo = (8, 8, 16), (4, 4, 8), 2
    f, d = _problem(rng, shape, 2, lim=halo - 0.05)
    want = jops.tricubic_displace_vec(jnp.asarray(f), jnp.asarray(d), method="pallas",
                                      tile=tile, halo=halo)
    got = ops.tricubic_displace_vec(_t(f), _t(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_plain_displace_vec_is_each_field_bit_for_bit(rng):
    """ref.tricubic_displace_vec forms the query points once; each channel
    equals its own ref.tricubic_displace bit for bit, also across chunks."""
    f, d = _problem(rng, (12, 20, 9), 3, lim=9.0)
    got = ref.tricubic_displace_vec(_t(f), _t(d))
    want = torch.stack([ref.tricubic_displace(_t(fc), _t(d)) for fc in f])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_displace_vec_dispatch_on_cpu(rng, monkeypatch):
    """On the CPU "auto" takes the plain version and launches nothing;
    "cuda" refuses CPU tensors."""
    f, d = _problem(rng, (8, 8, 8), 2, lim=5.0)
    tricubic.reset_launches()
    np.testing.assert_array_equal(ops.tricubic_displace_vec(_t(f), _t(d)).numpy(),
                                  ref.tricubic_displace_vec(_t(f), _t(d)).numpy())
    assert tricubic.LAUNCHES["tricubic_displace"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.tricubic_displace_vec(_t(f), _t(d), method="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tricubic.tricubic_displace_cuda(_t(f), _t(d))


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
    # a 3-D field takes the single-field path, as in the reference
    torch.testing.assert_close(interp(_t(f[0]), _t(d)), ref.tricubic_displace(_t(f[0]), _t(d)))
    assert tricubic.LAUNCHES == {
        "tricubic_apply": 0, "tricubic_displace_many": 0, "tricubic_displace": 0
    }


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
    with pytest.raises(ValueError, match="CUDA"):
        ops.make_interp("cuda")(_t(f[0]), _t(d))
    with pytest.raises(ValueError, match="CUDA"):
        tricubic.tricubic_displace_cuda(_t(f[0]), _t(d))
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
    for name in ("tricubic_apply_f32", "tricubic_displace_many_f32", "tricubic_displace_f32"):
        assert f'extern "C" int {name}(' in src
        assert name in build.SIGNATURES
    for replaced in ("_kernel_planned", "_kernel_many", "_kernel "):
        assert replaced in src
    src = build.SOURCES[1].read_text()
    assert 'extern "C" int biharmonic_scale_f32(' in src
    assert "biharmonic_scale_f32" in build.SIGNATURES
    assert "spectral_diag.py _kernel" in src
    assert all(s.parent == build.CSRC and s.is_file() for s in build.SOURCES)


def test_port_imports_neither_jax_nor_repro():
    """Static: no import line names jax or repro.  Dynamic: every module
    imports with both blocked."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "bench_torch", n)
        for n in ("fmad_ab.py", "tricubic_ab.py", "ptx_diff.py")]
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
        "import chip_smoke, fmad_ab, ptx_diff, tricubic_ab\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT, "bench_torch")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_fmad_ab_flips_one_flag_and_needs_a_card():
    """The A/B build differs from the port's only in FMA contraction, and
    the script refuses to run without a card."""
    script = os.path.join(ROOT, "bench_torch", "fmad_ab.py")
    sys.path.insert(0, os.path.dirname(script))
    try:
        import fmad_ab
    finally:
        sys.path.remove(os.path.dirname(script))
    flipped = [(a, b) for a, b in zip(fmad_ab.VARIANTS["fmad_false"], fmad_ab.VARIANTS["fmad_true"])
               if a != b]
    assert fmad_ab.VARIANTS["fmad_false"] == build.NVCC_FLAGS
    assert flipped == [("-fmad=false", "-fmad=true")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script, "--n", "8"], env=env, capture_output=True,
                          text=True)
    assert proc.returncode != 0 and "CUDA card" in proc.stderr
    assert proc.stdout == ""


def _ptx(kernels: dict[str, str], anon: str, first_block: int) -> str:
    """A PTX module: one entry per kernel, its body ``body`` with a branch
    to its block label numbered from ``first_block``."""
    out = [".version 8.4", ".target sm_90a"]
    for i, (name, body) in enumerate(kernels.items()):
        mangled = f"_ZN44_GLOBAL__N__{anon}_11_tricubic_cu_f5c7b239{len(name)}{name}EPKfPfi"
        bb = f"$L__BB{first_block + i}_2"
        out += [f".visible .entry {mangled}(", f"\t.param .u64 {mangled}_param_0", ")",
                "{", f"\t{body}", f"\t@%p1 bra \t{bb};", f"{bb}:", "\tret;", "}", ""]
    return "\n".join(out)


def test_ptx_diff_ignores_only_names_and_block_labels():
    """Kernels whose mangled names and block numbering differ but whose
    instructions agree are identical; a changed instruction differs; a
    kernel the new copy lacks is missing; new kernels are listed."""
    sys.path.insert(0, os.path.join(ROOT, "bench_torch"))
    try:
        import ptx_diff
    finally:
        sys.path.remove(os.path.join(ROOT, "bench_torch"))
    assert ptx_diff.kernel_name("_ZN44_GLOBAL__N__8cdf822f_11_tricubic_cu_f5c7b23912"
                                "apply_kernelEPKfPKiS1_PfiiiiPi") == "apply_kernel"
    old = ptx_diff.bodies(_ptx({"apply_kernel": "add.f32 %f1, %f2, %f3;",
                                "displace_kernel": "mul.f32 %f1, %f2, %f3;",
                                "field_warp_kernel": "ret;"}, "8cdf822f", 0))
    new = ptx_diff.bodies(_ptx({"apply_kernel": "add.f32 %f1, %f2, %f3;",
                                "apply_cohort_kernel": "add.f32 %f1, %f2, %f3;",
                                "displace_kernel": "fma.rn.f32 %f1, %f2, %f3, %f4;"},
                               "ff0287a2", 3))
    got = ptx_diff.compare(old, new)
    assert {k: v["verdict"] for k, v in got["kernels"].items()} == {
        "apply_kernel": "identical", "displace_kernel": "differs",
        "field_warp_kernel": "missing"}
    assert got["new_only"] == ["apply_cohort_kernel"]


def test_tricubic_ab_builds_the_first_design_beside_the_tree_and_needs_a_card():
    """The A/B baseline is the kernels' first design (one thread per point,
    no staged-tile counter and no subject count in its entry points), and
    the script refuses to run without a card."""
    script = os.path.join(ROOT, "bench_torch", "tricubic_ab.py")
    sys.path.insert(0, os.path.dirname(script))
    try:
        import tricubic_ab
    finally:
        sys.path.remove(os.path.dirname(script))
    base = tricubic_ab.BASELINE.read_text()
    assert "Shared-memory staging and several points per thread are later work" in base
    assert "staged_tiles" not in base and "staged_tiles" in build.SOURCES[0].read_text()
    # the tree's K1 and K2 take the subject count and the counter
    for name in ("tricubic_apply_f32", "tricubic_displace_many_f32"):
        assert len(tricubic_ab.BASELINE_SIGNATURES[name]) + 2 == len(build.SIGNATURES[name])
    # the first design's K3 takes neither a channel count nor the counter
    name = "tricubic_displace_f32"
    assert len(tricubic_ab.BASELINE_SIGNATURES[name]) + 2 == len(build.SIGNATURES[name])
    assert "field_warp_kernel" in tricubic_ab.SYMBOLS
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script, "--sizes", "8"], env=env, capture_output=True,
                          text=True)
    assert proc.returncode != 0 and "CUDA card" in proc.stderr
    assert proc.stdout == ""

