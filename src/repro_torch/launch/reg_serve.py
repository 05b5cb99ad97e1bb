"""Cohort registration server: one cohort Newton step per (grid, config)
bucket, with jobs streamed through its subject slots; counterpart of
``repro/launch/reg_serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.reg_serve --jobs 6 --slots 3 \\
        --size 16 --beta 1e-2 --max-newton 8 [--device cuda]

* Jobs are bucketed by image shape (and retry attempt).  Each bucket runs
  a ``gn.make_cohort_step`` callable, shared by the buckets whose configs
  differ in ``beta`` alone; the image stacks, the beta, the per-subject
  forcing references and the active mask are its arguments, so
  admissions and retirements call it with the same argument signature
  (``compiled_executables`` stays 1; ``gn.CohortStep``).
* Each bucket runs an S-slot cohort: a subject that converges retires
  mid-flight, and its slot is refilled from the queue before the next
  iteration.
* Every job is billed the Hessian matvecs its own masked PCG took, which
  equals what its independent solve would take.

The slots share one beta per step, so a server config must not use
``beta_continuation``.  Every retirement carries a ``status`` read off the
health guard (``repro_torch.resilience.health``).  ``serve_jobs`` also
re-admits failed jobs under the degradation ladder
(``retry=RetryPolicy(...)``; a beta-only rung rides the primary bucket's
step), snapshots the whole session through
``ckpt.manager.CheckpointManager`` (``checkpoint=dir``) and restarts a
killed stream from its latest snapshot, re-serving only the unfinished
jobs with their billing kept (``resume=True``).  ``CohortServer.hooks`` is
the fault-injection surface (``repro_torch.resilience.faults``).  The
per-step collective counts (``emit_step_collectives``) are ROADMAP Queue A
item 14.
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
from repro_torch.device import resolve_device
from repro_torch.resilience import health
from repro_torch.resilience import policy as res_policy

_FORCING_SENTINEL = 1e-30  # first iteration of a subject: eta = eta_max


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
        # called with this server at the top of every step(): the fault
        # hooks of repro_torch.resilience.faults mutate slot state or abort
        # the loop on the host; the cohort step is untouched
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

    # ------------------------------------------------------------------ #
    # checkpointed job streams: a snapshot carries the slot state and every
    # queued job's images, so ``restore`` needs no access to the original
    # job list (job ids must be JSON-serializable)
    def snapshot(self) -> tuple[dict, dict]:
        """(tree, meta) for ``CheckpointManager.save``: tensors in the tree,
        JSON-able bookkeeping in the meta."""
        zero_v = torch.zeros((3,) + self.grid.shape, dtype=self.grid.dtype)

        def field(x):
            return torch.as_tensor(x, dtype=self.grid.dtype)

        tree = {
            "v": self._v,
            "rho_R": self._rho_R,
            "rho_T": self._rho_T,
            "queue_rho_R": [field(j.rho_R) for j in self.queue],
            "queue_rho_T": [field(j.rho_T) for j in self.queue],
            "queue_v0": [zero_v if j.v0 is None else field(j.v0) for j in self.queue],
        }

        def job_meta(job: RegJob) -> dict:
            return {
                "job_id": job.job_id,
                "attempt": int(job.attempt),
                "g0_ref": None if job.g0_ref is None else float(job.g0_ref),
                "block": None if job.block is None else list(job.block),
            }

        meta = {
            "iterations": int(self.iterations),
            "refills": int(self.refills),
            "admitted": int(self.admitted),
            "slot_jobs": [
                None if job is None else {
                    **job_meta(job),
                    "g_forcing": float(self._g_forcing[s]),
                    "g0": float(self._g0[s]),
                    "g0_preset": bool(self._g0_preset[s]),
                    "newton": int(self._newton[s]),
                    "cg": int(self._cg[s]),
                    "rel": float(self._rel[s]),
                    "admitted_at": int(self._admitted_at[s]),
                    "queue_wait": int(self._queue_wait[s]),
                }
                for s, job in enumerate(self._jobs)
            ],
            "queue_jobs": [
                {**job_meta(job), "has_v0": job.v0 is not None,
                 "enqueued_at": int(self._enqueued_at.get(id(job), self.iterations))}
                for job in self.queue
            ],
        }
        return tree, meta

    @classmethod
    def restore(cls, grid: Grid, cfg: gn.GNConfig, tree: dict, meta: dict,
                ops: SpectralOps | None = None, interp=None, step_fn=None,
                device="cuda") -> "CohortServer":
        """Rebuild a server mid-stream from a ``snapshot()`` pair: slot
        iterates, per-slot billing meters and queued jobs resume exactly, on
        the step's device."""
        srv = cls(grid, cfg, slots=len(meta["slot_jobs"]), ops=ops, interp=interp,
                  step_fn=step_fn, device=device)
        dev, dt = srv.device, grid.dtype
        srv._v = torch.as_tensor(tree["v"], dtype=dt).to(dev)
        srv._rho_R = torch.as_tensor(tree["rho_R"], dtype=dt).to(dev)
        srv._rho_T = torch.as_tensor(tree["rho_T"], dtype=dt).to(dev)
        srv.iterations = int(meta["iterations"])
        srv.refills = int(meta["refills"])
        srv.admitted = int(meta["admitted"])
        for s, sm in enumerate(meta["slot_jobs"]):
            if sm is None:
                continue
            # copies: a later fill of the slot writes its images in place
            srv._jobs[s] = RegJob(job_id=sm["job_id"], rho_R=srv._rho_R[s].clone(),
                                  rho_T=srv._rho_T[s].clone(), v0=None, g0_ref=sm["g0_ref"],
                                  block=None if sm["block"] is None else tuple(sm["block"]),
                                  attempt=int(sm["attempt"]))
            srv._g_forcing[s] = sm["g_forcing"]
            srv._g0[s] = sm["g0"]
            srv._g0_preset[s] = sm["g0_preset"]
            srv._newton[s] = sm["newton"]
            srv._cg[s] = sm["cg"]
            srv._rel[s] = sm["rel"]
            srv._admitted_at[s] = sm["admitted_at"]
            srv._queue_wait[s] = sm["queue_wait"]
        for q, qm in enumerate(meta["queue_jobs"]):
            job = RegJob(
                job_id=qm["job_id"],
                rho_R=torch.as_tensor(tree["queue_rho_R"][q], dtype=dt).to(dev),
                rho_T=torch.as_tensor(tree["queue_rho_T"][q], dtype=dt).to(dev),
                v0=torch.as_tensor(tree["queue_v0"][q], dtype=dt).to(dev)
                if qm["has_v0"] else None,
                g0_ref=qm["g0_ref"],
                block=None if qm["block"] is None else tuple(qm["block"]),
                attempt=int(qm["attempt"]),
            )
            srv.queue.append(job)
            srv._enqueued_at[id(job)] = int(qm["enqueued_at"])
        return srv


def _result_meta(res: JobResult) -> dict:
    """The JSON-able fields of a JobResult (its ``v`` rides the tree)."""
    return {
        "job_id": res.job_id,
        "newton_iters": int(res.newton_iters),
        "hessian_matvecs": int(res.hessian_matvecs),
        "fine_equiv_matvecs": float(res.fine_equiv_matvecs),
        "rel_gnorm": float(res.rel_gnorm),
        "converged": bool(res.converged),
        "status": res.status,
        "attempts": int(res.attempts),
    }


def serve_jobs(jobs: list[RegJob], cfg: gn.GNConfig, slots: int = 4,
               ops: SpectralOps | None = None, interp=None, verbose: bool = False,
               retry: res_policy.RetryPolicy | None = None, checkpoint: Any = None,
               checkpoint_every: int = 5, resume: bool = False,
               faults: list | None = None, device="cuda") -> dict:
    """Bucket ``jobs`` by (image shape, attempt) and drain every bucket,
    round-robin.

    Returns ``{"results": [JobResult...], "buckets": {key: stats},
    "compiled_executables": n}``.  A bucket's key is the image shape for
    the first attempt and ``shape + ("retry<k>",)`` for attempt k; ``n``
    counts the argument signatures of the distinct cohort steps of the
    session (``gn.CohortStep``), one step per (shape, ``static_key(cfg)``),
    so 1 when every retry rode a beta-only rung.

    * ``retry``: a ``RetryPolicy``; a job retiring with a status in
      ``retry.retry_on`` is re-admitted under the ladder's config for its
      next attempt, warm-started from its last iterate when that is finite.
    * ``checkpoint``: a directory (or a ``CheckpointManager``) that takes a
      snapshot of the session every ``checkpoint_every`` serve rounds and
      at the end; with ``resume=True`` the latest snapshot is restored and
      only the unfinished jobs are served (``jobs`` is ignored when a
      snapshot exists: it carries every queued image and finished result).
    * ``faults``: hooks attached to every server
      (``repro_torch.resilience.faults``).

    The servers live on ``ops``' device, else on ``device``.
    """
    faults = list(faults or [])
    dev = ops.device if ops is not None else resolve_device(device)
    mgr = None
    if checkpoint is not None:
        from repro_torch.ckpt.manager import CheckpointManager

        mgr = checkpoint if isinstance(checkpoint, CheckpointManager) \
            else CheckpointManager(checkpoint)

    step_cache: dict = {}  # (shape, static_key(cfg)) -> one cohort step
    servers: dict[tuple, CohortServer] = {}  # (shape, attempt) -> server
    by_id: dict = {}  # job_id -> RegJob (its images, for a retry)
    final: list[JobResult] = []  # one final result per job

    def bucket(shape, attempt: int):
        """(key, grid, cfg, shared step) of the bucket of ``attempt``."""
        key = (tuple(shape), int(attempt))
        grid = make_grid(key[0])
        cfg_a = retry.degraded(cfg, key[1]) if retry is not None and key[1] > 1 else cfg
        sk = (key[0], res_policy.static_key(cfg_a))
        if sk not in step_cache:
            step_cache[sk] = gn.make_cohort_step(grid, cfg_a, ops=ops, interp=interp,
                                                 device=dev)
        return key, grid, cfg_a, step_cache[sk]

    def get_server(shape, attempt: int) -> CohortServer:
        key, grid, cfg_a, step = bucket(shape, attempt)
        if key not in servers:
            srv = CohortServer(grid, cfg_a, slots=slots, ops=ops, interp=interp,
                               step_fn=step, device=dev)
            srv.hooks.extend(faults)
            servers[key] = srv
        return servers[key]

    # ---- session bring-up: resume from the latest snapshot, or admit jobs
    serve_round = 0
    restored = False
    if resume and mgr is not None and mgr.latest_step() is not None:
        tree, meta = mgr.restore(device=dev)
        serve_round = int(meta["step"])
        for r_meta, r_v in zip(meta["results"], tree["results_v"]):
            final.append(JobResult(v=r_v, **r_meta))
        for label, bm in meta["buckets"].items():
            key, grid, cfg_a, step = bucket(bm["shape"], bm["attempt"])
            srv = CohortServer.restore(grid, cfg_a, tree["buckets"][label], bm, ops=ops,
                                       interp=interp, step_fn=step, device=dev)
            srv.hooks.extend(faults)
            servers[key] = srv
        for srv in servers.values():
            for j in list(srv.queue) + [x for x in srv._jobs if x is not None]:
                by_id.setdefault(j.job_id, j)
        restored = True
        telemetry.emit(
            telemetry.RecoveryEvent(
                action="resume_from_checkpoint",
                step=serve_round,
                attrs={"completed": len(final),
                       "unfinished": sum(len(s.queue) + int(s.active.sum())
                                         for s in servers.values())},
            ),
            echo=verbose,
        )
        telemetry.counter("resilience.resumes")
    if not restored:
        for job in jobs:
            by_id[job.job_id] = job
            get_server(tuple(job.rho_R.shape), job.attempt).admit(job)

    # ---- retirement: retry failed jobs through the ladder -----------------
    def handle(res: JobResult) -> None:
        if (retry is not None and res.status in retry.retry_on
                and res.attempts < retry.max_attempts and res.job_id in by_id):
            base = by_id[res.job_id]
            warm = retry.warm_start and bool(torch.isfinite(res.v).all())
            nxt = res.attempts + 1
            rj = RegJob(job_id=res.job_id, rho_R=base.rho_R, rho_T=base.rho_T,
                        v0=res.v if warm else base.v0, g0_ref=base.g0_ref, block=base.block,
                        attempt=nxt)
            by_id[res.job_id] = rj
            get_server(tuple(base.rho_R.shape), nxt).admit(rj)
            telemetry.emit(
                telemetry.RecoveryEvent(action="retry_degraded", job_id=str(res.job_id),
                                        attempts=nxt,
                                        attrs={"status": res.status, "warm_start": warm}),
                echo=verbose,
            )
            telemetry.counter("resilience.retries", status=res.status)
            return
        if res.status in health.FAILED_NAMES:
            telemetry.counter("resilience.jobs_failed", status=res.status)
        final.append(res)

    def save_session() -> None:
        tree: dict = {"buckets": {}, "results_v": [r.v for r in final]}
        meta: dict = {"buckets": {}, "results": [_result_meta(r) for r in final]}
        for (shape, attempt), srv in servers.items():
            label = "x".join(map(str, shape)) + f"@a{attempt}"
            tree["buckets"][label], m = srv.snapshot()
            meta["buckets"][label] = {"shape": list(shape), "attempt": attempt, **m}
        mgr.save(serve_round, tree, meta)

    # ---- drain: round-robin over the buckets, periodic snapshots --------
    def live(srv: CohortServer) -> bool:
        return bool(srv.queue) or bool(srv.active.any())

    while any(live(srv) for srv in servers.values()):
        for key in list(servers):
            srv = servers[key]
            if not live(srv):
                continue
            srv._echo = verbose
            try:
                for res in srv.step():
                    handle(res)
            finally:
                srv._echo = False
        serve_round += 1
        if mgr is not None and checkpoint_every and serve_round % checkpoint_every == 0:
            save_session()
    if mgr is not None:
        save_session()

    stats: dict = {}
    steps: dict[int, int] = {}
    for (shape, attempt), srv in servers.items():
        stats[shape if attempt == 1 else shape + (f"retry{attempt}",)] = {
            "jobs": srv.admitted,
            "attempt": attempt,
            "cohort_iterations": srv.iterations,
            "refills": srv.refills,
            "compiled_executables": srv.compiled_executables(),
        }
        steps[id(srv.step_fn)] = srv.compiled_executables()
    return {"results": final, "buckets": stats, "compiled_executables": sum(steps.values())}


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
