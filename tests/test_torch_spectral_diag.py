"""Port parity of the fused spectral diagonal scaling (K4): the plain
version ``biharmonic_scale_ref`` against the TPU kernel
``biharmonic_scale_pallas`` in interpret mode, on the same numpy spectra,
at the shapes and tolerance of ``tests/test_kernels.py`` (``rtol=2e-5``),
plus its agreement with ``SpectralOps.reg_apply`` and the dispatch rules.
The CUDA kernel runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.spectral_diag import biharmonic_scale_pallas  # noqa: E402
from repro_torch.core.grid import make_grid  # noqa: E402
from repro_torch.core.spectral import SpectralOps  # noqa: E402
from repro_torch.kernels import spectral_diag  # noqa: E402

SHAPES = [(8, 16, 128), (16, 8, 256)]
BETAS = [(1.0,), (1e-2, 1.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(rng, shape):
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    return re, im


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("betas", BETAS)
def test_plain_version_matches_pallas_interpret(rng, shape, betas):
    re, im = _planes(rng, shape)
    want_re, want_im = biharmonic_scale_pallas(
        jnp.asarray(re), jnp.asarray(im), betas=betas, tile=(8, 128), interpret=True
    )
    got_re, got_im = spectral_diag.biharmonic_scale_ref(
        torch.from_numpy(re), torch.from_numpy(im), betas
    )
    assert got_re.shape == got_im.shape == (len(betas),) + shape
    np.testing.assert_allclose(got_re.numpy(), np.asarray(want_re), rtol=2e-5)
    np.testing.assert_allclose(got_im.numpy(), np.asarray(want_im), rtol=2e-5)


@pytest.mark.parametrize("shape", SHAPES + [(12, 10, 9)])
def test_plain_version_matches_numpy_kgrid(rng, shape):
    """The symbol on the fftfreq grid, odd and even axes alike."""
    re, im = _planes(rng, shape)
    k1, k2, k3 = make_grid(shape).k_grids(rfft_last=False)
    ksq = (k1**2 + k2**2 + k3**2).astype(np.float32)
    out_re, out_im = spectral_diag.biharmonic_scale(
        torch.from_numpy(re), torch.from_numpy(im), (1e-2, 1.0)
    )
    for c, beta in enumerate((1e-2, 1.0)):
        np.testing.assert_allclose(out_re[c].numpy(), re * (beta * ksq**2), rtol=2e-5)
        np.testing.assert_allclose(out_im[c].numpy(), im * (beta * ksq**2), rtol=2e-5)


def test_plain_version_is_reg_apply(rng):
    """ifftn of the output is ``SpectralOps.reg_apply`` (tests/test_kernels.py
    tolerances)."""
    n = (8, 16, 128)
    f = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    spec = torch.fft.fftn(f)
    out_re, out_im = spectral_diag.biharmonic_scale(
        spec.real.contiguous(), spec.imag.contiguous(), (1e-2,)
    )
    got = torch.fft.ifftn(torch.complex(out_re[0], out_im[0])).real
    want = SpectralOps(make_grid(n), device="cpu").reg_apply(f, 1e-2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2, rtol=1e-3)


def test_dispatch_and_limits(rng):
    re, im = (torch.from_numpy(a) for a in _planes(rng, (4, 6, 8)))
    spectral_diag.reset_launches()
    spectral_diag.biharmonic_scale(re, im, (1.0,))
    spectral_diag.biharmonic_scale(re, im, (1.0,), method="ref")
    assert spectral_diag.LAUNCHES == {"biharmonic_scale": 0}
    with pytest.raises(ValueError, match="CUDA"):
        spectral_diag.biharmonic_scale(re, im, (1.0,), method="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        spectral_diag.biharmonic_scale_cuda(re, im, (1.0,))
    with pytest.raises(ValueError, match="betas"):
        spectral_diag.biharmonic_scale(re, im, tuple(range(1, 10)))
    with pytest.raises(ValueError, match="betas"):
        spectral_diag.biharmonic_scale(re, im, ())
