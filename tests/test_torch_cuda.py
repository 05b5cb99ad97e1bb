"""Card-only tests of the port's CUDA kernels (``-m gpu``).

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card, at
small shapes (cubic, non-cubic with N3 % 8 != 0, displacements beyond any
halo), and the default solve is shown to launch both kernels.  Whether a
card is present is decided inside the ``cuda`` fixture, so every worker
collects the same tests; without a card they skip.  Imports neither JAX
nor the JAX package.
"""
import pytest
import torch

from repro_torch.core import gauss_newton as gn
from repro_torch.core.registration import RegistrationConfig, register
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref, tricubic

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
    assert tricubic.LAUNCHES == {"tricubic_apply": 1, "tricubic_displace_many": 1}
    tricubic.reset_launches()
    ops.make_interp("ref").apply_plan(f, interp.make_plan(d))
    assert tricubic.LAUNCHES == {"tricubic_apply": 0, "tricubic_displace_many": 0}


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
