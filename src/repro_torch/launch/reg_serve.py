"""Cohort registration server: one cohort Newton step per (grid, config)
bucket, with jobs streamed through its subject slots; counterpart of
``repro/launch/reg_serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.reg_serve --jobs 6 --slots 3 \\
        --size 16 --beta 1e-2 --max-newton 8 [--device cuda]

* Jobs are bucketed by image shape.  Each bucket owns one
  ``gn.make_cohort_step`` callable; the image stacks, the beta, the
  per-subject forcing references and the active mask are its arguments, so
  admissions and retirements call it with the same argument signature
  (``compiled_executables`` stays 1; ``gn.CohortStep``).
* Each bucket runs an S-slot cohort: a subject that converges retires
  mid-flight, and its slot is refilled from the queue before the next
  iteration.
* Every job is billed the Hessian matvecs its own masked PCG took, which
  equals what its independent solve would take.

The slots share one beta per step, so a server config must not use
``beta_continuation``.  Every retirement carries a ``status`` read off the
health guard (``repro_torch.resilience.health``).  Not ported (ROADMAP
Queue A item 10): the retry ladder, checkpointed sessions and resume, and
fault hooks (``serve_jobs(retry=, checkpoint=, resume=True, faults=)``,
``CohortServer.snapshot``/``restore``); and the per-step collective counts
of item 14 (``emit_step_collectives``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import gauss_newton as gn
from repro_torch.core.grid import Grid, make_grid
from repro_torch.core.spectral import SpectralOps
from repro_torch.resilience import health

_FORCING_SENTINEL = 1e-30  # first iteration of a subject: eta = eta_max
_ITEM10 = "is not ported (ROADMAP Queue A item 10)"


@dataclasses.dataclass
class RegJob:
    """One registration request: a reference and template image pair.

    ``v0`` (3, N..) warm-starts the slot; ``g0_ref`` fixes the convergence
    reference gradient norm (the forcing reference stays the slot's first
    iterate); ``block`` tags a tile index for the job's ``JobEvent``.
    """

    job_id: Any
    rho_R: torch.Tensor  # (N1, N2, N3)
    rho_T: torch.Tensor
    v0: torch.Tensor | None = None
    g0_ref: float | None = None
    block: tuple | None = None
    attempt: int = 1


@dataclasses.dataclass
class JobResult:
    job_id: Any
    v: torch.Tensor  # (3, N..) the job's velocity, on the server's device
    newton_iters: int
    hessian_matvecs: int
    fine_equiv_matvecs: float  # single level: the Hessian matvecs
    rel_gnorm: float
    converged: bool
    # "converged" | "stagnated" | "max_newton" | "nonfinite" | "diverged" |
    # "pcg_breakdown" (repro_torch.resilience.health names)
    status: str = ""
    attempts: int = 1


class CohortServer:
    """One bucket: an S-slot cohort over a fixed (grid, cfg).

    ``admit()`` queues jobs; ``step()`` fills free slots, advances every
    live slot one masked Newton iteration and returns the jobs that
    retired; ``run()`` steps until queue and slots are empty.  The server
    lives on ``ops``' device, else on ``device``.
    """

    def __init__(self, grid: Grid, cfg: gn.GNConfig, slots: int = 4,
                 ops: SpectralOps | None = None, interp=None, step_fn=None, device="cuda"):
        if cfg.beta_continuation:
            raise ValueError(
                "CohortServer slots share one beta per step; run beta continuation "
                "as chained server buckets instead"
            )
        self.grid, self.cfg, self.slots = grid, cfg, slots
        self.step_fn = step_fn or gn.make_cohort_step(grid, cfg, ops=ops, interp=interp,
                                                      device=device)
        dev = self.step_fn.ops.device
        self.device = dev
        self.queue: list[RegJob] = []
        self.results: list[JobResult] = []
        S = slots
        self._jobs: list[RegJob | None] = [None] * S
        self._v = torch.zeros((S, 3) + grid.shape, dtype=grid.dtype, device=dev)
        self._rho_R = torch.zeros((S,) + grid.shape, dtype=grid.dtype, device=dev)
        self._rho_T = torch.zeros((S,) + grid.shape, dtype=grid.dtype, device=dev)
        self._g_forcing = np.full(S, _FORCING_SENTINEL, np.float32)
        self._g0 = np.zeros(S, np.float32)  # termination reference per slot
        self._g0_preset = np.zeros(S, bool)  # True: the job supplied g0_ref
        self._newton = np.zeros(S, np.int64)
        self._cg = np.zeros(S, np.int64)
        self._rel = np.zeros(S, np.float32)
        self.iterations = 0  # cohort step calls
        self.refills = 0  # slot fills after a retirement (not the initial fills)
        self.admitted = 0
        self._echo = False
        self._enqueued_at: dict[int, int] = {}  # id(job) -> iterations at admit
        self._admitted_at = np.zeros(S, np.int64)
        self._queue_wait = np.zeros(S, np.int64)
        # called with this server at the top of every step(); the fault
        # hooks that use it are not ported (item 10)
        self.hooks: list = []

    def admit(self, *jobs: RegJob) -> None:
        for job in jobs:
            self._enqueued_at[id(job)] = self.iterations
        self.admitted += len(jobs)
        self.queue.extend(jobs)

    @property
    def active(self) -> np.ndarray:
        return np.asarray([j is not None for j in self._jobs])

    def _fill_slots(self) -> None:
        for s in range(self.slots):
            if self._jobs[s] is not None or not self.queue:
                continue
            job = self.queue.pop(0)
            self._jobs[s] = job
            if job.v0 is None:
                self._v[s] = 0.0
            else:
                self._v[s] = torch.as_tensor(job.v0, dtype=self.grid.dtype)
            self._rho_R[s] = torch.as_tensor(job.rho_R, dtype=self.grid.dtype)
            self._rho_T[s] = torch.as_tensor(job.rho_T, dtype=self.grid.dtype)
            self._g_forcing[s] = _FORCING_SENTINEL
            self._g0_preset[s] = job.g0_ref is not None
            self._g0[s] = job.g0_ref if job.g0_ref is not None else 0.0
            self._newton[s] = 0
            self._cg[s] = 0
            if self.iterations > 0:
                self.refills += 1
            self._admitted_at[s] = self.iterations
            self._queue_wait[s] = self.iterations - self._enqueued_at.pop(id(job),
                                                                          self.iterations)

    def _retire(self, s: int, converged: bool, status: str) -> JobResult:
        job = self._jobs[s]
        res = JobResult(
            job_id=job.job_id,
            v=self._v[s].clone(),
            newton_iters=int(self._newton[s]),
            hessian_matvecs=int(self._cg[s]),
            fine_equiv_matvecs=float(self._cg[s]),
            rel_gnorm=float(self._rel[s]),
            converged=converged,
            status=status,
            attempts=int(job.attempt),
        )
        self._jobs[s] = None
        self.results.append(res)
        if status in health.FAILED_NAMES:
            telemetry.counter("resilience.guard_tripped", status=status, source="reg_serve")
        telemetry.emit(
            telemetry.JobEvent(
                job_id=str(res.job_id),
                newton_iters=res.newton_iters,
                hessian_matvecs=res.hessian_matvecs,
                fine_equiv_matvecs=res.fine_equiv_matvecs,
                rel_gnorm=res.rel_gnorm,
                converged=res.converged,
                slot=s,
                queue_wait_steps=int(self._queue_wait[s]),
                admitted_step=int(self._admitted_at[s]),
                retired_step=self.iterations,
                block=list(job.block) if job.block is not None else None,
                status=res.status,
                attempts=res.attempts,
            ),
            echo=self._echo,
        )
        return res

    def step(self) -> list[JobResult]:
        """Fill free slots, advance one masked Newton iteration, retire."""
        for hook in list(self.hooks):
            hook(self)
        self._fill_slots()
        active = self.active
        if not active.any():
            return []
        self._v, log = self.step_fn(
            self._v,
            torch.as_tensor(self._g_forcing, device=self.device),
            torch.as_tensor(active, device=self.device),
            self.cfg.beta,
            self._rho_R,
            self._rho_T,
        )
        self.iterations += 1
        gnorm = log.gnorm.cpu().numpy().astype(np.float32)
        step_len = log.step_len.cpu().numpy()
        code = log.status.cpu().numpy().astype(np.int64)
        self._newton += active
        self._cg += log.cg_iters.cpu().numpy().astype(np.int64)
        retired = []
        for s in range(self.slots):
            if not active[s]:
                continue
            # a new subject's first iterate fixes its forcing reference and,
            # unless the job gave g0_ref, its termination reference
            if self._g_forcing[s] == _FORCING_SENTINEL:
                self._g_forcing[s] = gnorm[s]
                if not self._g0_preset[s]:
                    self._g0[s] = gnorm[s]
            self._rel[s] = gnorm[s] / max(self._g0[s], _FORCING_SENTINEL)
            converged = bool(self._rel[s] <= self.cfg.gtol)
            # the guard decides the failures; the host decides converged,
            # stagnated and max_newton
            if int(code[s]) in health.FAILED_CODES:
                status = health.status_name(int(code[s]))
                converged = False
            elif converged:
                status = health.status_name(health.CONVERGED)
            elif step_len[s] == 0.0:
                status = health.status_name(health.STAGNATED)
            elif self._newton[s] >= self.cfg.max_newton:
                status = health.status_name(health.MAX_NEWTON)
            else:
                continue
            retired.append(self._retire(s, converged, status))
        telemetry.emit(
            telemetry.ServeStepEvent(
                iteration=self.iterations,
                slots=self.slots,
                occupancy=int(active.sum()),
                queue_len=len(self.queue),
                refills=self.refills,
            )
        )
        return retired

    def run(self, verbose: bool = False) -> list[JobResult]:
        self._echo = verbose
        try:
            while self.queue or self.active.any():
                self.step()
        finally:
            self._echo = False
        return self.results

    def compiled_executables(self) -> int:
        """The argument signatures this bucket's step was called with
        (``gn.CohortStep``): 1 for a whole session of refills."""
        return self.step_fn._cache_size()

    def emit_step_collectives(self, label: str = "cohort_step") -> None:
        raise NotImplementedError(
            "CohortServer.emit_step_collectives is not ported (ROADMAP Queue A item 14)"
        )

    def snapshot(self):
        raise NotImplementedError(f"CohortServer.snapshot {_ITEM10}")

    @classmethod
    def restore(cls, *args, **kwargs):
        raise NotImplementedError(f"CohortServer.restore {_ITEM10}")


def serve_jobs(jobs: list[RegJob], cfg: gn.GNConfig, slots: int = 4,
               ops: SpectralOps | None = None, interp=None, verbose: bool = False,
               retry=None, checkpoint: Any = None, resume: bool = False,
               faults: list | None = None, device="cuda") -> dict:
    """Bucket ``jobs`` by image shape and drain every bucket, round-robin.

    Returns ``{"results": [JobResult...], "buckets": {shape: stats},
    "compiled_executables": n}``, ``n`` summed over the buckets' steps.
    ``retry``, ``checkpoint``, ``resume=True`` and ``faults`` raise
    ``NotImplementedError`` (ROADMAP Queue A item 10).
    """
    for name, given in (("retry", retry is not None), ("checkpoint", checkpoint is not None),
                        ("resume", resume), ("faults", bool(faults))):
        if given:
            raise NotImplementedError(f"serve_jobs({name}=...) {_ITEM10}")
    servers: dict[tuple, CohortServer] = {}
    for job in jobs:
        shape = tuple(job.rho_R.shape)
        if shape not in servers:
            servers[shape] = CohortServer(make_grid(shape), cfg, slots=slots, ops=ops,
                                          interp=interp, device=device)
        servers[shape].admit(job)

    results: list[JobResult] = []
    while any(srv.queue or srv.active.any() for srv in servers.values()):
        for srv in servers.values():
            if not (srv.queue or srv.active.any()):
                continue
            srv._echo = verbose
            try:
                results.extend(srv.step())
            finally:
                srv._echo = False

    stats = {
        shape: {
            "jobs": srv.admitted,
            "attempt": 1,
            "cohort_iterations": srv.iterations,
            "refills": srv.refills,
            "compiled_executables": srv.compiled_executables(),
        }
        for shape, srv in servers.items()
    }
    return {
        "results": results,
        "buckets": stats,
        "compiled_executables": sum(s["compiled_executables"] for s in stats.values()),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--beta", type=float, default=1e-2)
    ap.add_argument("--n-t", type=int, default=4)
    ap.add_argument("--max-newton", type=int, default=8)
    ap.add_argument("--max-cg", type=int, default=30)
    ap.add_argument("--gtol", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--trace", type=str, default=None,
                    help="write a telemetry JSONL trace to this path "
                         "(render with: python -m repro.analysis.trace_report)")
    args = ap.parse_args(argv)

    from repro_torch.data.synthetic import synthetic_problem

    cfg = gn.GNConfig(beta=args.beta, n_t=args.n_t, max_newton=args.max_newton,
                      max_cg=args.max_cg, gtol=args.gtol)
    rng = np.random.default_rng(args.seed)
    jobs = []
    for j in range(args.jobs):
        amp = float(rng.uniform(0.3, 1.0))
        rho_R, rho_T, _, _ = synthetic_problem(args.size, n_t=args.n_t, amplitude=amp,
                                               device=args.device)
        jobs.append(RegJob(job_id=f"job{j}(amp={amp:.2f})", rho_R=rho_R, rho_T=rho_T))

    sink = telemetry.JsonlSink(args.trace) if args.trace else contextlib.nullcontext()
    t0 = time.time()
    with sink:
        out = serve_jobs(jobs, cfg, slots=args.slots, verbose=True, device=args.device)
    dt = time.time() - t0
    for shape, st in out["buckets"].items():
        print(
            f"bucket {shape}: {st['jobs']} jobs in {st['cohort_iterations']} cohort "
            f"iterations, {st['refills']} refills, {st['compiled_executables']} step "
            f"signature(s)"
        )
    total_mv = sum(r.hessian_matvecs for r in out["results"])
    print(f"served {len(out['results'])} jobs in {dt:.1f}s, {total_mv} matvecs total")


if __name__ == "__main__":
    main()
