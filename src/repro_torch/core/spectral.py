"""Spectral (Fourier) differential operators on the periodic grid.

Counterpart of ``repro/core/spectral.py``: gradient, divergence, Laplacian,
the regularization operator ``beta Lap^2`` and its inverse (the spectral
preconditioner), the Leray projection, Gaussian smoothing, the Parseval
regularization energy and ``det(grad y)``.  Every operator is a diagonal
scaling of the FFT coefficients; the transforms are cuFFT (on the card) or
PocketFFT/MKL (on the CPU) through ``torch.fft``.

``SpectralBatch`` coalesces independent operator calls into one batched
forward and one batched inverse transform, with inputs deduplicated by
identity (the same Python tensor object is transformed once)::

    with ops.batch() as sb:
        divv = sb.div(v)
        regv = sb.reg_apply(v, beta)
    g = regv.get() + ...          # both shared one forward and one inverse
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.grid import Grid
from repro_torch.device import resolve_device

_DIMS = (-3, -2, -1)


# Coarsening a periodic spectral discretization is exact mode selection: the
# coarse grid of size M carries the modes k in {0..ceil(M/2)-1, -M//2..-1}.
# ``mode_indices`` maps those modes to their positions in a length-N fine
# spectrum (numpy fft ordering); ``nyquist_mask`` zeroes the +-M/2 plane,
# whose fine counterpart is ambiguous, in both restriction and prolongation,
# which keeps the pair exactly adjoint (``repro_torch.multilevel.transfer``).
def mode_indices(n_fine: int, n_coarse: int, rfft: bool = False) -> np.ndarray:
    """Positions of the coarse grid's modes inside a length-``n_fine`` spectrum,
    in coarse-spectrum order: two contiguous runs (positive head, negative
    tail).  ``rfft=True`` addresses an rfft last axis (modes 0..n/2)."""
    if n_coarse > n_fine:
        raise ValueError(f"coarse axis {n_coarse} exceeds fine axis {n_fine}")
    if rfft:
        return np.arange(n_coarse // 2 + 1)
    n_pos = n_coarse - n_coarse // 2  # modes 0 .. ceil(M/2)-1
    n_neg = n_coarse // 2  # modes -M//2 .. -1
    return np.concatenate([np.arange(n_pos), np.arange(n_fine - n_neg, n_fine)])


def nyquist_mask(n_fine: int, n_coarse: int, rfft: bool = False) -> np.ndarray:
    """1.0 per retained mode, 0.0 on the coarse Nyquist plane (even M < N)."""
    size = n_coarse // 2 + 1 if rfft else n_coarse
    mask = np.ones(size, np.float32)
    if n_coarse % 2 == 0 and n_coarse < n_fine:
        mask[n_coarse // 2] = 0.0
    return mask


class LocalFFT:
    """Single-device backend: real FFT over the last three axes."""

    def __init__(self, grid: Grid, device):
        self.grid = grid
        self.device = torch.device(device)
        k1, k2, k3 = grid.k_grids(rfft_last=True)
        d1, d2, d3 = grid.k_deriv(rfft_last=True)
        f32 = np.float32

        def t(a):
            return torch.as_tensor(np.asarray(a, f32), device=self.device)

        self.k = (t(k1), t(k2), t(k3))
        self.kd = (t(d1), t(d2), t(d3))
        self.ksq = t(k1**2 + k2**2 + k3**2)
        self.ksq_d = t(d1**2 + d2**2 + d3**2)
        # Parseval weight of each stored rfft mode: every 0 < k3 < N3/2 mode
        # stands for itself and its dropped conjugate partner
        n3 = grid.shape[2]
        w = np.full(n3 // 2 + 1, 2.0, f32)
        w[0] = 1.0
        if n3 % 2 == 0:
            w[-1] = 1.0
        self.spec_weight = t(w.reshape(1, 1, -1))

    def fwd(self, u: torch.Tensor) -> torch.Tensor:
        return torch.fft.rfftn(u.to(torch.float32), dim=_DIMS)

    def inv(self, spec: torch.Tensor) -> torch.Tensor:
        return torch.fft.irfftn(spec, s=self.grid.shape, dim=_DIMS).to(self.grid.dtype)


class SpectralRef:
    """Lazy handle for one coalesced op's output (see ``SpectralBatch``)."""

    __slots__ = ("_batch", "_idx")

    def __init__(self, batch: "SpectralBatch", idx: int):
        self._batch = batch
        self._idx = idx

    def get(self) -> torch.Tensor:
        """Resolve the result (runs the batch's single transform pair if needed)."""
        self._batch.run()
        return self._batch._results[self._idx]


class SpectralBatch:
    """Coalesce independent spectral operator calls into ONE forward and ONE
    inverse transform.

    ``run()`` (at the context-manager exit or the first ``SpectralRef.get()``)
    concatenates the deduplicated inputs, runs one batched real forward,
    applies every op's k-space function, and inverts the stacked outputs in
    one batched inverse.  Reduction jobs (``reg_energy``) are read off the
    forward spectrum and join no inverse.
    """

    def __init__(self, ops: "SpectralOps"):
        self.ops = ops
        self._in_arrays: list = []
        self._in_slots: dict = {}  # id(tensor) -> (start, tensor)
        self._n_in = 0
        self._jobs: list = []  # (slots, kfn, out_lead, reduce)
        self._results: list | None = None

    def _input(self, u: torch.Tensor):
        """Register a real input field; dedup by identity. Returns (start, lead)."""
        if self._results is not None:
            raise RuntimeError("SpectralBatch already ran; start a new batch")
        space = tuple(u.shape[-3:])
        if space != tuple(self.ops.grid.shape):
            raise ValueError(f"field shape {tuple(u.shape)} not on grid {self.ops.grid.shape}")
        lead = tuple(u.shape[:-3])
        slot = self._in_slots.get(id(u))
        if slot is not None and slot[1] is u:
            return slot[0], lead
        m = math.prod(lead)
        start = self._n_in
        self._in_arrays.append(u.reshape((m,) + space))
        self._n_in += m
        self._in_slots[id(u)] = (start, u)
        return start, lead

    def _job(self, inputs, kfn, out_lead, reduce: bool = False) -> SpectralRef:
        slots = [self._input(u) for u in inputs]
        self._jobs.append((slots, kfn, tuple(out_lead), reduce))
        return SpectralRef(self, len(self._jobs) - 1)

    def run(self) -> None:
        """Execute the coalesced transform pair (idempotent)."""
        if self._results is not None:
            return
        self._results = [None] * len(self._jobs)
        if not self._jobs:
            return
        ins = self._in_arrays[0] if len(self._in_arrays) == 1 else torch.cat(self._in_arrays)
        specs = self.ops.fwd_real(ins)
        kshape = tuple(specs.shape[1:])
        out_blocks, inv_slots = [], []
        for idx, (slots, kfn, out_lead, reduce) in enumerate(self._jobs):
            args = [
                specs[start : start + math.prod(lead)].reshape(lead + kshape)
                for start, lead in slots
            ]
            out = kfn(*args)
            if reduce:
                self._results[idx] = out
            else:
                out_blocks.append(out.reshape((-1,) + kshape))
                inv_slots.append((idx, out_lead))
        if out_blocks:
            allspec = out_blocks[0] if len(out_blocks) == 1 else torch.cat(out_blocks)
            real = self.ops.inv_real(allspec)
            pos = 0
            for idx, out_lead in inv_slots:
                m = math.prod(out_lead)
                self._results[idx] = real[pos : pos + m].reshape(out_lead + tuple(real.shape[1:]))
                pos += m
        # a retained handle must not pin the stacked input buffers
        self._in_arrays.clear()
        self._in_slots.clear()
        self._jobs.clear()

    def __enter__(self) -> "SpectralBatch":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.run()

    # -- coalesced operators (same semantics as the eager SpectralOps) -----
    def grad(self, f: torch.Tensor) -> SpectralRef:
        return self._job([f], self.ops._grad_spec, (3,) + tuple(f.shape[:-3]))

    def div(self, v: torch.Tensor) -> SpectralRef:
        return self._job([v], self.ops._div_spec, v.shape[:-4])

    def laplacian(self, f: torch.Tensor) -> SpectralRef:
        return self._job([f], lambda s: -self.ops.fft.ksq * s, f.shape[:-3])

    def biharmonic(self, f: torch.Tensor) -> SpectralRef:
        return self._job([f], lambda s: self.ops.fft.ksq**2 * s, f.shape[:-3])

    def inv_laplacian(self, f: torch.Tensor) -> SpectralRef:
        return self._job([f], lambda s: self.ops._inv_lap_scale() * s, f.shape[:-3])

    def inv_biharmonic(self, f: torch.Tensor, zero_mode: float = 0.0) -> SpectralRef:
        return self._job(
            [f], lambda s: self.ops._inv_bihar_scale(zero_mode) * s, f.shape[:-3]
        )

    def reg_apply(self, v: torch.Tensor, beta) -> SpectralRef:
        return self._job([v], lambda s: self.ops._reg_scale(beta) * s, v.shape[:-3])

    def precond_apply(self, r: torch.Tensor, beta) -> SpectralRef:
        return self._job([r], lambda s: self.ops._precond_scale(beta) * s, r.shape[:-3])

    def leray(self, v: torch.Tensor) -> SpectralRef:
        return self._job([v], self.ops._leray_spec, v.shape[:-3])

    def precond_project(self, r: torch.Tensor, beta, incompressible: bool) -> SpectralRef:
        def kfn(s):
            s = self.ops._precond_scale(beta) * s
            return self.ops._leray_spec(s) if incompressible else s

        return self._job([r], kfn, r.shape[:-3])

    def reg_plus_project(self, a: torch.Tensor, b: torch.Tensor, beta,
                         incompressible: bool) -> SpectralRef:
        """beta Lap^2 a + P b (P = I when not incompressible): 6 fields
        forward, 3 back."""
        def kfn(sa, sb):
            if incompressible:
                sb = self.ops._leray_spec(sb)
            return self.ops._reg_scale(beta) * sa + sb

        return self._job([a, b], kfn, a.shape[:-3])

    def smooth(self, f: torch.Tensor, sigma=None) -> SpectralRef:
        scale = self.ops._smooth_scale(sigma)
        return self._job([f], lambda s: scale * s, f.shape[:-3])

    def reg_energy(self, v: torch.Tensor, beta) -> SpectralRef:
        """beta/2 ||Lap v||^2 as a spectrum-side Parseval reduction (joins no
        inverse transform)."""
        return self._job(
            [v], lambda s: self.ops._reg_energy_spec(s, beta), v.shape[:-4], reduce=True
        )


def check_field_dtype(field_dtype, owner: str) -> None:
    """The port stores every field in float32: ``field_dtype`` is accepted as
    ``None`` or as any spelling of float32 (``"float32"``, ``torch.float32``,
    ``numpy.float32``), the identity.  A narrower storage dtype raises: it is
    ROADMAP Queue A item 12."""
    if field_dtype is None:
        return
    name = str(field_dtype).removeprefix("torch.")
    if not isinstance(field_dtype, (str, torch.dtype)):
        try:
            name = np.dtype(field_dtype).name
        except TypeError:
            pass
    if name != "float32":
        raise NotImplementedError(
            f"{owner}(field_dtype={field_dtype!r}) is not ported (ROADMAP Queue A item 12)"
        )


class SpectralOps:
    """The paper's spectral operator toolbox on one device.

    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent; the
    k-space multipliers live on that device.  ``field_dtype`` is accepted
    only as ``None`` or float32, the port's field dtype
    (``check_field_dtype``): a narrower storage dtype is ROADMAP Queue A
    item 12.
    """

    def __init__(self, grid: Grid, device="cuda", field_dtype=None):
        check_field_dtype(field_dtype, "SpectralOps")
        self.grid = grid
        self.device = resolve_device(device)
        self.fft = LocalFFT(grid, self.device)

    def batch(self) -> SpectralBatch:
        """Open a transform-coalescing batch (see ``SpectralBatch``)."""
        return SpectralBatch(self)

    def fwd_real(self, u: torch.Tensor) -> torch.Tensor:
        return self.fft.fwd(u)

    def inv_real(self, spec: torch.Tensor) -> torch.Tensor:
        return self.fft.inv(spec)

    # ------------------------------------------------------------------ #
    # k-space transfer functions, shared by the eager operators and the
    # coalesced SpectralBatch ops
    # ------------------------------------------------------------------ #
    def _grad_spec(self, spec: torch.Tensor) -> torch.Tensor:
        """(...,) spectrum -> (3, ...) gradient spectrum (Nyquist-zeroed)."""
        return torch.stack([1j * k * spec for k in self.fft.kd], dim=0)

    def _div_spec(self, spec: torch.Tensor) -> torch.Tensor:
        """(..., 3, k-shape) spectrum -> (..., k-shape) divergence spectrum."""
        return sum(1j * k * spec[..., i, :, :, :] for i, k in enumerate(self.fft.kd))

    def _leray_spec(self, spec: torch.Tensor) -> torch.Tensor:
        """P = I - k k^T/|k|^2 over the ``-4`` component axis."""
        kd = self.fft.kd
        ksq = self.fft.ksq_d
        comp = [spec[..., i, :, :, :] for i in range(3)]
        kdotv = sum(k * comp[i] for i, k in enumerate(kd))
        inv = torch.where(ksq > 0, 1.0 / torch.clamp(ksq, min=1e-30), 0.0)
        return torch.stack([comp[i] - kd[i] * inv * kdotv for i in range(3)], dim=-4)

    def _inv_lap_scale(self) -> torch.Tensor:
        ksq = self.fft.ksq
        return torch.where(ksq > 0, -1.0 / torch.clamp(ksq, min=1e-30), 0.0)

    def _inv_bihar_scale(self, zero_mode: float) -> torch.Tensor:
        ksq = self.fft.ksq
        return torch.where(ksq > 0, 1.0 / torch.clamp(ksq**2, min=1e-30), zero_mode)

    def _reg_scale(self, beta) -> torch.Tensor:
        """Diagonal of A = beta Lap^2."""
        return beta * self.fft.ksq**2

    def _precond_scale(self, beta) -> torch.Tensor:
        ksq = self.fft.ksq
        return torch.where(ksq > 0, 1.0 / torch.clamp(beta * ksq**2, min=1e-30), 1.0)

    def _smooth_scale(self, sigma=None) -> torch.Tensor:
        if sigma is None:
            sigma = self.grid.spacing
        if np.isscalar(sigma):
            sigma = (sigma, sigma, sigma)
        k1, k2, k3 = self.fft.k
        expo = -0.5 * ((k1 * sigma[0]) ** 2 + (k2 * sigma[1]) ** 2 + (k3 * sigma[2]) ** 2)
        return torch.exp(expo)

    def _reg_energy_spec(self, spec: torch.Tensor, beta) -> torch.Tensor:
        """beta/2 ||Lap v||^2 read off the forward spectrum of ``v`` (Parseval):
        ``h^3 sum_x |u|^2 = h^3/N sum_k |U(k)|^2``, with the rfft modes whose
        conjugate partners are not stored counted twice.  Reduces the
        component and space axes, so a cohort (S, 3, k..) spectrum yields
        (S,)."""
        mag = (spec.real**2 + spec.imag**2) * self.fft.spec_weight
        e = torch.sum(self.fft.ksq**2 * mag, dim=(-4, -3, -2, -1))
        scale = self.grid.cell_volume / self.grid.num_points
        return 0.5 * beta * scale * e

    # ------------------------------------------------------------------ #
    # operators
    # ------------------------------------------------------------------ #
    def grad(self, f: torch.Tensor) -> torch.Tensor:
        """grad f: (..., N1,N2,N3) -> (3, ..., N1,N2,N3); one forward, one
        batched inverse."""
        return self.inv_real(self._grad_spec(self.fwd_real(f)))

    def div(self, v: torch.Tensor) -> torch.Tensor:
        """div v: (..., 3, N1,N2,N3) -> (..., N1,N2,N3)."""
        return self.inv_real(self._div_spec(self.fwd_real(v)))

    def laplacian(self, f: torch.Tensor) -> torch.Tensor:
        return self.inv_real(-self.fft.ksq * self.fwd_real(f))

    def biharmonic(self, f: torch.Tensor) -> torch.Tensor:
        return self.inv_real(self.fft.ksq**2 * self.fwd_real(f))

    def inv_laplacian(self, f: torch.Tensor) -> torch.Tensor:
        """Lap^{-1} with the zero mean mode mapped to zero."""
        return self.inv_real(self._inv_lap_scale() * self.fwd_real(f))

    def inv_biharmonic(self, f: torch.Tensor, zero_mode: float = 0.0) -> torch.Tensor:
        """Lap^{-2}, the zero mean mode scaled by ``zero_mode``."""
        return self.inv_real(self._inv_bihar_scale(zero_mode) * self.fwd_real(f))

    def leray(self, v: torch.Tensor) -> torch.Tensor:
        """Project a velocity onto the divergence-free subspace."""
        return self.inv_real(self._leray_spec(self.fwd_real(v)))

    def reg_apply(self, v: torch.Tensor, beta) -> torch.Tensor:
        """beta * Lap^2 v (H^2 seminorm regularization, paper eq. (2a))."""
        return self.inv_real(self._reg_scale(beta) * self.fwd_real(v))

    def precond_apply(self, r: torch.Tensor, beta) -> torch.Tensor:
        """(beta Lap^2)^{-1} r, the mean mode passed through unchanged."""
        return self.inv_real(self._precond_scale(beta) * self.fwd_real(r))

    def reg_plus_project(self, a: torch.Tensor, b: torch.Tensor, beta, incompressible: bool):
        """beta Lap^2 a + P b (P = I when not incompressible): one batched
        forward over the 6 stacked components, one batched inverse over 3."""
        spec = self.fwd_real(torch.stack([a, b], dim=0))
        sa, sb = spec[0], spec[1]
        if incompressible:
            sb = self._leray_spec(sb)
        return self.inv_real(self._reg_scale(beta) * sa + sb)

    def precond_project(self, r: torch.Tensor, beta, incompressible: bool) -> torch.Tensor:
        """P (beta Lap^2)^{-1} r in a single spectral round trip."""
        spec = self._precond_scale(beta) * self.fwd_real(r)
        if incompressible:
            spec = self._leray_spec(spec)
        return self.inv_real(spec)

    def smooth(self, f: torch.Tensor, sigma=None) -> torch.Tensor:
        """Gaussian spectral filter; default bandwidth = one grid cell."""
        return self.inv_real(self._smooth_scale(sigma) * self.fwd_real(f))

    def reg_energy(self, v: torch.Tensor, beta) -> torch.Tensor:
        """beta/2 ||Lap v||^2 via Parseval on the forward spectrum (no inverse);
        per subject, (S,), for a cohort velocity (S, 3, N..)."""
        return self._reg_energy_spec(self.fwd_real(v), beta)

    def jacobian_det(self, disp: torch.Tensor) -> torch.Tensor:
        """det(grad y) for y = x + u given the displacement u (3,N1,N2,N3)."""
        g = torch.swapaxes(self.grad(disp), 0, 1)  # g[i,j] = d_j u_i
        a = g + torch.eye(3, dtype=g.dtype, device=g.device)[:, :, None, None, None]
        return (
            a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
            - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
            + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0])
        )
