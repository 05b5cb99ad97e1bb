"""Card-only tests of the port's CUDA kernels (``-m gpu``).

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card, at
small shapes (cubic, non-cubic with N3 % 8 != 0, displacements beyond any
halo), and the default solve and a coarse-to-fine solve are shown to
launch the tricubic kernels.  The planned apply and the batched displace
also take a cohort of subjects in one launch (the subject axis), equal bit
for bit to one launch per subject and to the plain cohort versions, and a
cohort solve through them equals the plain one.  On smooth displacements,
whose tiles the three tricubic kernels stage in shared memory, they agree
with their plain versions bit for bit and stage as many tiles as the plain
model ``tricubic.staged_tiles`` says; random displacements take the
unstaged branch.  A cohort launch with one subject poisoned by NaN or
+-inf raises nothing, writes nothing outside its output and leaves the
other subjects bit for bit; a NaN injected into one served job leaves the
others bit for bit; and a full Newton solve through the kernels equals the
plain one.  Whether a card is present is decided inside the ``cuda``
fixture, so every worker collects the same tests; without a card they
skip.  Imports neither JAX nor the JAX package.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench_torch"))
from fmad_ab import poisoned_cohort_case, smooth_disp  # noqa: E402
from repro_torch.core import gauss_newton as gn
from repro_torch.core.registration import RegistrationConfig, register
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref, spectral_diag, tricubic
from repro_torch.multilevel import MultilevelConfig

pytestmark = pytest.mark.gpu

ATOL, RTOL = 2e-5, 1e-4  # tests/test_kernels.py: kernel against oracle
SHAPES = [(16, 16, 16), (12, 20, 9), (40, 48, 36)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(cuda, shape, c, lim=9.0, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    f = torch.randn((c,) + shape, generator=gen, device=cuda)
    d = (torch.rand((3,) + shape, generator=gen, device=cuda) * 2 - 1) * lim
    return f, d


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", [1, 2, 3])
def test_apply_kernel_matches_plain(cuda, shape, c):
    f, d = _inputs(cuda, shape, c)
    plan = ref.make_interp_plan(d)
    got = tricubic.tricubic_apply_cuda(f, plan)
    torch.testing.assert_close(got, ref.interp_apply(f, plan), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", [1, 3])
def test_displace_kernel_matches_plain(cuda, shape, c):
    f, d = _inputs(cuda, shape, c)
    got = tricubic.tricubic_displace_many_cuda(f, d)
    torch.testing.assert_close(got, ref.tricubic_displace_many(f, d), atol=ATOL, rtol=RTOL)


SMOOTH_SHAPES = [(64, 64, 64), (40, 48, 36), (12, 20, 9)]
# voxels: the first stages every tile of these shapes, the last almost none
SMOOTH_MAX_DISP = [2.0, 4.0, 16.0]


def _smooth_inputs(cuda, shape, c, max_disp, seed=0):
    """Random fields and a periodic low-mode displacement of at most
    ``max_disp`` voxels."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    f = torch.randn((c,) + shape, generator=gen, device=cuda)
    return f, smooth_disp(shape, max_disp, gen, cuda)


@pytest.mark.parametrize("max_disp", SMOOTH_MAX_DISP)
@pytest.mark.parametrize("shape", SMOOTH_SHAPES)
@pytest.mark.parametrize("c", [1, 2, 3])
def test_apply_kernel_bit_exact_on_smooth_field(cuda, shape, c, max_disp):
    f, d = _smooth_inputs(cuda, shape, c, max_disp)
    plan = ref.make_interp_plan(d)
    with tricubic.count_staged() as counts:
        got = tricubic.tricubic_apply_cuda(f, plan)
    torch.testing.assert_close(got, ref.interp_apply(f, plan), atol=0, rtol=0)
    assert counts[("tricubic_apply", shape)]["staged"] == tricubic.staged_tiles(plan.ib)


@pytest.mark.parametrize("max_disp", SMOOTH_MAX_DISP)
@pytest.mark.parametrize("shape", SMOOTH_SHAPES)
@pytest.mark.parametrize("c", [1, 3])
def test_displace_kernel_bit_exact_on_smooth_field(cuda, shape, c, max_disp):
    f, d = _smooth_inputs(cuda, shape, c, max_disp)
    with tricubic.count_staged() as counts:
        got = tricubic.tricubic_displace_many_cuda(f, d)
    torch.testing.assert_close(got, ref.tricubic_displace_many(f, d), atol=0, rtol=0)
    assert (counts[("tricubic_displace_many", shape)]["staged"]
            == tricubic.staged_tiles(torch.floor(d).to(torch.int32)))


def test_staged_branch_taken_on_small_smooth_field(cuda):
    """The smallest smooth field stages tiles of every shape; random
    displacements of 9 voxels stage none: both branches run in the tests
    above."""
    for shape in SMOOTH_SHAPES:
        f, d = _smooth_inputs(cuda, shape, 2, SMOOTH_MAX_DISP[0])
        with tricubic.count_staged() as counts:
            tricubic.tricubic_displace_many_cuda(f, d)
        assert counts[("tricubic_displace_many", shape)]["staged"] > 0
        f, d = _inputs(cuda, shape, 2)
        with tricubic.count_staged() as counts:
            tricubic.tricubic_apply_cuda(f, ref.make_interp_plan(d))
        assert counts[("tricubic_apply", shape)]["staged"] == 0


def test_count_staged_counts_every_launch(cuda):
    """count_staged() adds up each launch's staged tiles by kernel and grid,
    as many as the plain model says; outside it nothing is counted."""
    shape = (40, 48, 36)
    f, d = _smooth_inputs(cuda, shape, 2, SMOOTH_MAX_DISP[1])
    plan = ref.make_interp_plan(d)
    tricubic.tricubic_apply_cuda(f, plan)
    with tricubic.count_staged() as counts:
        for _ in range(2):
            tricubic.tricubic_apply_cuda(f, plan)
        tricubic.tricubic_displace_many_cuda(f, d)
    tricubic.tricubic_displace_many_cuda(f, d)
    tiles = tricubic.n_tiles(shape)
    assert counts == {
        ("tricubic_apply", shape): {"staged": 2 * tricubic.staged_tiles(plan.ib),
                                    "tiles": 2 * tiles},
        ("tricubic_displace_many", shape): {
            "staged": tricubic.staged_tiles(torch.floor(d).to(torch.int32)), "tiles": tiles},
    }


def _cohort_inputs(cuda, shape, c, subjects, field, seed=0):
    """Fields (C, S, N..) and per-subject displacements (S, 3, N..): smooth
    ones of 2 to 16 voxels (the subjects stage all, part or few of their
    tiles) or random ones of up to 9 voxels."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    f = torch.randn((c, subjects) + shape, generator=gen, device=cuda)
    if field == "smooth":
        d = torch.stack([smooth_disp(shape, SMOOTH_MAX_DISP[s % 3], gen, cuda)
                         for s in range(subjects)])
    else:
        d = (torch.rand((subjects, 3) + shape, generator=gen, device=cuda) * 2 - 1) * 9.0
    return f, d


@pytest.mark.parametrize("field", ["smooth", "random"])
@pytest.mark.parametrize("shape", SMOOTH_SHAPES)
@pytest.mark.parametrize("name,c", [("tricubic_apply", 1), ("tricubic_apply", 2),
                                    ("tricubic_apply", 3), ("tricubic_displace_many", 3)])
def test_cohort_kernels_bit_exact_against_plain_and_single_launches(cuda, name, c, shape,
                                                                     field):
    """K1 and K2 over 4 subjects in one launch equal the plain cohort
    version and 4 single-subject launches on the contiguous slabs bit for
    bit, and stage each subject's tiles as the model does."""
    subjects = 4
    f, d = _cohort_inputs(cuda, shape, c, subjects, field)
    plan = ref.make_interp_plan(d)
    with tricubic.count_staged() as counts:
        if name == "tricubic_apply":
            got = tricubic.tricubic_apply_cuda(f, plan)
        else:
            got = tricubic.tricubic_displace_many_cuda(f, d)
    assert got.shape == f.shape
    want = (ref.interp_apply(f, plan) if name == "tricubic_apply"
            else ref.tricubic_displace_many(f, d))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    for s in range(subjects):
        slab = f[:, s].contiguous()
        if name == "tricubic_apply":
            one = tricubic.tricubic_apply_cuda(
                slab, ref.InterpPlan(plan.ib[s], plan.w[s], plan.halo_need))
        else:
            one = tricubic.tricubic_displace_many_cuda(slab, d[s].contiguous())
        torch.testing.assert_close(got[:, s], one, atol=0, rtol=0)
    base = tricubic.stencil_base(name, d, plan)
    assert counts[(name, shape)] == {"staged": tricubic.staged_tiles(base),
                                     "tiles": subjects * tricubic.n_tiles(shape)}


@pytest.mark.parametrize("shape", SMOOTH_SHAPES)
def test_cohort_of_one_subject_is_the_single_launch(cuda, shape):
    """S = 1: the cohort launch gives the single-subject launch's output bit
    for bit, and books the same tiles."""
    f, d = _cohort_inputs(cuda, shape, 3, 1, "smooth")
    plan = ref.make_interp_plan(d)
    single = ref.InterpPlan(plan.ib[0], plan.w[0], plan.halo_need)
    with tricubic.count_staged() as cohort_counts:
        k1 = tricubic.tricubic_apply_cuda(f[:2].contiguous(), plan)
        k2 = tricubic.tricubic_displace_many_cuda(f, d)
    with tricubic.count_staged() as single_counts:
        one1 = tricubic.tricubic_apply_cuda(f[:2, 0].contiguous(), single)
        one2 = tricubic.tricubic_displace_many_cuda(f[:, 0].contiguous(), d[0].contiguous())
    torch.testing.assert_close(k1[:, 0], one1, atol=0, rtol=0)
    torch.testing.assert_close(k2[:, 0], one2, atol=0, rtol=0)
    assert cohort_counts == single_counts


def test_cohort_dispatch_launches_once_per_call(cuda):
    """A cohort plan or displacement goes to one launch of K1 or K2 under
    "auto", to the plain cohort version under "ref", with equal results."""
    f, d = _cohort_inputs(cuda, (12, 20, 9), 2, 3, "smooth")
    interp = ops.make_interp()
    plan = interp.make_plan(d)
    tricubic.reset_launches()
    got = interp.apply_plan(f, plan), interp(f, d), interp(f[0], d)
    assert tricubic.LAUNCHES == {
        "tricubic_apply": 1, "tricubic_displace_many": 2, "tricubic_displace": 0
    }
    tricubic.reset_launches()
    plain = ops.make_interp("ref")
    want = plain.apply_plan(f, plan), plain(f, d), plain(f[0], d)
    assert all(n == 0 for n in tricubic.LAUNCHES.values())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_cohort_solve_through_kernels_equals_plain(cuda):
    """A 16^3 cohort solve under "auto" (the kernels) equals the one under
    "ref" (no launch): the same per-subject counts and velocities."""
    from repro_torch.core.grid import make_grid

    probs = [synthetic.synthetic_problem(16, n_t=2, amplitude=a, device=cuda)
             for a in (0.2, 0.6, 1.0, 1.4)]
    rho_R = torch.stack([p[0] for p in probs])
    rho_T = torch.stack([p[1] for p in probs])
    outs, launches = {}, {}
    for method in ("auto", "ref"):
        cfg = gn.GNConfig(n_t=2, max_newton=8, max_cg=20, interp_method=method)
        tricubic.reset_launches()
        outs[method] = gn.solve_cohort(rho_R, rho_T, make_grid(16), cfg, device=cuda)
        launches[method] = dict(tricubic.LAUNCHES)
    assert launches["auto"]["tricubic_apply"] > 0
    assert launches["auto"]["tricubic_displace_many"] > 0
    assert all(n == 0 for n in launches["ref"].values())
    for key in ("newton_iters", "hessian_matvecs", "status"):
        assert outs["auto"][key] == outs["ref"][key], key
    assert float((outs["auto"]["v"] - outs["ref"]["v"]).abs().max()) == 0.0


@pytest.mark.parametrize("shape", SHAPES)
def test_single_field_displace_kernel_matches_plain(cuda, shape):
    f, d = _inputs(cuda, shape, 1)
    got = tricubic.tricubic_displace_cuda(f[0], d)
    torch.testing.assert_close(got, ref.tricubic_displace(f[0], d), atol=0, rtol=0)


def _warp_disp(cuda, shape, field):
    """K3's displacements: smooth (most tiles stage), strained (some or
    none do) or random (none do), with two points whose x + disp rounds up
    to an integer in f32."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    if field == "random":
        d = (torch.rand((3,) + shape, generator=gen, device=cuda) * 2 - 1) * 12.0
    else:
        d = smooth_disp(shape, 2.0 if field == "smooth" else 16.0, gen, cuda)
    d[:, 1, 2, 3] = -1e-8
    d[:, -1, -1, -1] = -1e-8
    return d.contiguous()


@pytest.mark.parametrize("field", ["smooth", "strained", "random"])
@pytest.mark.parametrize("shape", SMOOTH_SHAPES)
def test_single_field_displace_kernel_bit_exact_with_staged_count(cuda, shape, field):
    """K3 in both branches: bit for bit with ref.tricubic_displace, and as
    many staged tiles as the model counts with its own box and base."""
    f = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    d = _warp_disp(cuda, shape, field)
    tricubic.reset_launches()
    with tricubic.count_staged() as counts:
        got = tricubic.tricubic_displace_cuda(f, d)
    assert tricubic.LAUNCHES["tricubic_displace"] == 1
    torch.testing.assert_close(got, ref.tricubic_displace(f, d), atol=0, rtol=0)
    model = tricubic.staged_tiles(tricubic.warp_base(d), tricubic.WARP_BOX_ROWS)
    assert counts[("tricubic_displace", shape)] == {"staged": model,
                                                     "tiles": tricubic.n_tiles(shape)}
    if field == "smooth":
        assert model > 0
    if field == "random":
        assert model == 0


@pytest.mark.parametrize("shape", SMOOTH_SHAPES)
def test_displace_vec_one_launch_bit_exact(cuda, shape):
    """ops.tricubic_displace_vec: one K3 launch over C = 3 fields, each bit
    for bit with its own call of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    f = torch.randn((3,) + shape, generator=gen, device=cuda)
    d = smooth_disp(shape, 4.0, gen, cuda)
    tricubic.reset_launches()
    with tricubic.count_staged() as counts:
        got = ops.tricubic_displace_vec(f, d)
    assert tricubic.LAUNCHES["tricubic_displace"] == 1
    want = torch.stack([ref.tricubic_displace(fc, d) for fc in f])
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert counts[("tricubic_displace", shape)]["staged"] == tricubic.staged_tiles(
        tricubic.warp_base(d), tricubic.WARP_BOX_ROWS)


@pytest.mark.parametrize("shape", [(8, 16, 128), (16, 8, 256), (12, 20, 9)])
@pytest.mark.parametrize("betas", [(1.0,), (1e-2, 1.0)])
def test_biharmonic_kernel_matches_plain(cuda, shape, betas):
    gen = torch.Generator(device=cuda).manual_seed(0)
    re, im = (torch.randn(shape, generator=gen, device=cuda) for _ in range(2))
    spectral_diag.reset_launches()
    got = spectral_diag.biharmonic_scale(re, im, betas)
    assert spectral_diag.LAUNCHES == {"biharmonic_scale": 1}
    for g, w in zip(got, spectral_diag.biharmonic_scale_ref(re, im, betas)):
        torch.testing.assert_close(g, w, atol=0, rtol=2e-5)
    with pytest.raises(ValueError, match="betas"):
        spectral_diag.biharmonic_scale_cuda(re, im, tuple(range(1, 10)))


def test_kernels_exact_at_grid_points(cuda):
    f, _ = _inputs(cuda, (8, 12, 10), 2)
    d = torch.randint(-20, 20, (3, 8, 12, 10), device=cuda).float()
    got = tricubic.tricubic_displace_many_cuda(f, torch.zeros_like(d))
    torch.testing.assert_close(got, f, atol=1e-6, rtol=0)
    # integer displacements are periodic shifts
    plan = ref.make_interp_plan(d)
    torch.testing.assert_close(
        tricubic.tricubic_apply_cuda(f, plan), ref.interp_apply(f, plan), atol=1e-6, rtol=0
    )


def test_wrappers_reject_bad_inputs(cuda):
    f, d = _inputs(cuda, (8, 8, 8), 2)
    plan = ref.make_interp_plan(d)
    cohort = ref.make_interp_plan(torch.stack([d, d]))
    with pytest.raises(ValueError):  # a cohort plan needs (C, S, N..) fields
        tricubic.tricubic_apply_cuda(f, cohort)
    with pytest.raises(ValueError):  # of its S subjects
        tricubic.tricubic_apply_cuda(torch.stack([f, f, f], dim=1), cohort)
    with pytest.raises(TypeError):
        tricubic.tricubic_apply_cuda(f.double(), plan)
    with pytest.raises(ValueError):
        tricubic.tricubic_apply_cuda(f.transpose(1, 2), plan)
    with pytest.raises(ValueError):
        tricubic.tricubic_displace_many_cuda(f, d[:2])
    with pytest.raises(ValueError):
        tricubic.tricubic_displace_many_cuda(f.cpu(), d)


def test_auto_dispatch_launches_kernels(cuda):
    f, d = _inputs(cuda, (8, 8, 8), 3)
    interp = ops.make_interp()
    tricubic.reset_launches()
    interp(f, d)
    interp.apply_plan(f, interp.make_plan(d))
    interp(f[0], d)
    assert tricubic.LAUNCHES == {
        "tricubic_apply": 1, "tricubic_displace_many": 1, "tricubic_displace": 1
    }
    tricubic.reset_launches()
    ops.make_interp("ref").apply_plan(f, interp.make_plan(d))
    ops.make_interp("ref")(f[0], d)
    assert all(n == 0 for n in tricubic.LAUNCHES.values())


def test_default_register_runs_through_kernels(cuda):
    rho_R, rho_T, _, grid = synthetic.synthetic_problem(16, device=cuda)
    tricubic.reset_launches()
    out = register(rho_R, rho_T, RegistrationConfig(), grid=grid, device=cuda)
    assert tricubic.LAUNCHES["tricubic_apply"] > 0
    assert tricubic.LAUNCHES["tricubic_displace_many"] > 0
    assert out["det_min"] > 0
    ref_out = register(
        rho_R, rho_T, RegistrationConfig(solver=gn.GNConfig(interp_method="ref")),
        grid=grid, device=cuda,
    )
    assert [h["cg_iters"] for h in out["history"]] == [
        h["cg_iters"] for h in ref_out["history"]
    ]
    assert float((out["v"] - ref_out["v"]).abs().max()) < 1e-4


def test_multilevel_register_runs_through_kernels(cuda):
    rho_R, rho_T, grid = synthetic.brain_like(32, device=cuda)
    solver = gn.GNConfig(beta=1e-3, beta_continuation=(1e-1, 1e-2), max_newton=8, max_cg=40)
    cfg = RegistrationConfig(multilevel=MultilevelConfig(solver=solver, n_levels=3,
                                                         precond="vcycle"))
    tricubic.reset_launches()
    out = register(rho_R, rho_T, cfg, grid=grid, device=cuda)
    assert tricubic.LAUNCHES["tricubic_apply"] > 0
    assert tricubic.LAUNCHES["tricubic_displace_many"] > 0
    assert [lv["shape"] for lv in out["levels"]] == [[8] * 3, [16] * 3, [32] * 3]
    assert out["det_min"] > 0
    tricubic.reset_launches()
    ref_cfg = RegistrationConfig(multilevel=MultilevelConfig(
        solver=dataclasses.replace(solver, interp_method="ref"), n_levels=3,
        precond="vcycle"))
    ref_out = register(rho_R, rho_T, ref_cfg, grid=grid, device=cuda)
    assert all(n == 0 for n in tricubic.LAUNCHES.values())
    assert [h["cg_iters"] for h in out["history"]] == [
        h["cg_iters"] for h in ref_out["history"]
    ]
    assert float((out["v"] - ref_out["v"]).abs().max()) < 1e-4


# --------------------------------------------------------------------------- #
# a poisoned subject inside a cohort launch (the fault-tolerant server)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(12, 20, 9), (40, 48, 36)])
@pytest.mark.parametrize("where", ["disp", "fields"])
@pytest.mark.parametrize("value", [float("nan"), float("inf"), float("-inf")],
                         ids=["nan", "pinf", "ninf"])
@pytest.mark.parametrize("name,c", [("tricubic_apply", 2), ("tricubic_displace_many", 3)])
def test_poisoned_cohort_subject_is_isolated(cuda, name, c, value, where, shape):
    """K1/K2 over 4 subjects, one of them with NaN or +-inf in every other
    x1-plane of its displacement or fields: no CUDA error, nothing written
    outside the output, the other subjects bit for bit their outputs
    without the poison and alone, and the whole output the plain cohort
    version's."""
    from repro_torch.kernels import build

    gen = torch.Generator(device=cuda).manual_seed(3)
    f = torch.randn((c, 4) + shape, generator=gen, device=cuda)
    disp = torch.stack([smooth_disp(shape, 3.0, gen, cuda) for _ in range(4)])
    case = poisoned_cohort_case(build.library(), name, f, disp, subject=1, value=value,
                                where=where)
    assert case == {"launch_ok": True, "guard_intact": True, "healthy_equal": True,
                    "healthy_equal_without": True, "plain_equal": True}


def test_full_newton_solve_through_kernels_equals_plain(cuda):
    """``GNConfig(gauss_newton=False)`` at 32^3 under "auto" (the kernels)
    and "ref" (no launch): the same counts, max|dv| 0."""
    rho_R, rho_T, grid = synthetic.brain_like(32, device=cuda)
    outs, launches = {}, {}
    for method in ("auto", "ref"):
        cfg = RegistrationConfig(solver=gn.GNConfig(gauss_newton=False, max_newton=4,
                                                    interp_method=method))
        tricubic.reset_launches()
        outs[method] = register(rho_R, rho_T, cfg, grid=grid, device=cuda)
        launches[method] = dict(tricubic.LAUNCHES)
    assert launches["auto"]["tricubic_apply"] > 0
    assert all(n == 0 for n in launches["ref"].values())
    for key in ("cg_iters", "armijo_trials", "status"):
        assert [h[key] for h in outs["auto"]["history"]] == [
            h[key] for h in outs["ref"]["history"]], key
    assert float((outs["auto"]["v"] - outs["ref"]["v"]).abs().max()) == 0.0


def test_served_nan_injection_keeps_healthy_jobs_bit_exact(cuda):
    """A NaN injected into one job's slot mid-serve at 16^3, through the
    kernels: the job is retried and finishes, the others equal the
    un-faulted run bit for bit, one step signature."""
    from repro_torch.launch.reg_serve import RegJob, serve_jobs
    from repro_torch.resilience import NaNInjector, RetryPolicy

    probs = [synthetic.synthetic_problem(16, n_t=2, amplitude=a, device=cuda)
             for a in (0.2, 0.6, 1.0, 1.4)]
    cfg = gn.GNConfig(n_t=2, max_newton=8, max_cg=20)

    def jobs():
        return [RegJob(job_id=s, rho_R=p[0], rho_T=p[1]) for s, p in enumerate(probs)]

    base = {r.job_id: r for r in serve_jobs(jobs(), cfg, slots=2, device=cuda)["results"]}
    fault = NaNInjector(job_id=1, field="v", at_iteration=1)
    out = serve_jobs(jobs(), cfg, slots=2, device=cuda, retry=RetryPolicy(), faults=[fault])
    torch.cuda.synchronize()
    res = {r.job_id: r for r in out["results"]}
    assert fault.fired and res[1].attempts == 2 and torch.isfinite(res[1].v).all()
    assert out["compiled_executables"] == 1
    for s in (0, 2, 3):
        assert torch.equal(res[s].v, base[s].v), s
        assert (res[s].newton_iters, res[s].hessian_matvecs, res[s].status) == (
            base[s].newton_iters, base[s].hessian_matvecs, base[s].status), s
