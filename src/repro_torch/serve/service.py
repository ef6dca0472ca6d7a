"""The solve service: admission → coalesce → bucketed solve → scatter.

The port's counterpart of ``repro/serve/service.py``. :class:`SolveService`
wires the serve layer together around a synchronous tick loop (run
:meth:`tick` by hand in tests, or hang a
:class:`~repro_torch.serve.dispatcher.Dispatcher` thread off the service for
the deployment shape):

* :meth:`submit` validates a request, pins the target matrix's *current*
  value binding, and enqueues; every malformed input fails that one
  request with a structured :class:`SolveResponse` — nothing malformed
  ever reaches a batch.
* :meth:`tick` drains the queue, coalesces compatible requests across
  tenants (``coalescer.coalesce``), runs one bucketed multi-RHS solve per
  batch on the pre-warmed engine, and scatters per-lane results back into
  per-request responses (per-request convergence from per-lane residual
  freezing; per-request tolerance rides as a lane of the static ``tolb``).
* :meth:`warmup` joins the refactor workers, warms every resident engine
  for every bucket (on a CUDA device each bucket's GMRES restart captured
  as one CUDA graph) and pins the compile baseline — after it returns, a
  flat ``compiles.after_warmup`` (and ``cold_restarts.after_warmup``) is
  the service's core SLO invariant.

Degradation ladder (per batch, in order):

1. **Deadline sweep** — requests whose ``expires_at`` passed fail with
   ``DEADLINE_EXCEEDED`` before occupying a lane (and again after the
   solve, if the batch itself blew the budget).
2. **Quarantine** — if the engine *raises* on a multi-lane batch, each
   live request is re-dispatched solo: one poisoned lane costs one
   request, the co-batched survivors still get their (bitwise-identical)
   answers. A solo failure is a structured ``SOLVE_FAILED`` response.
3. **Shift retry** — lanes whose solve classifies as ``breakdown`` or
   ``diverged`` get one bucketed retry against a shifted-preconditioner
   binding (``cache.degraded_binding``); recovered lanes return
   ``degraded=True`` with the shift α, unrecovered lanes fail with a
   structured ``BREAKDOWN`` response.

Bit-compat bar: a healthy response's ``x`` is bitwise identical to solving
that request alone (``solve_with_ilu`` / ``solve_sharded`` on the same values)
— regardless of which batch, bucket, or lane position it was coalesced
into, and regardless of any *other* lane in its tick breaking down.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.sparse import CSRMatrix

from .admission import (
    BREAKDOWN,
    DEADLINE_EXCEEDED,
    SOLVE_FAILED,
    AdmissionError,
    AdmissionQueue,
    SolveRequest,
    SolveResponse,
    validate_deadline,
    validate_request,
)
from .cache import PlanCache
from .coalescer import CoalescedBatch, coalesce
from .engine import DEFAULT_MAXITER, DEFAULT_RESTART, ServeEngine, ShardedServeEngine
from .metrics import ServiceMetrics

#: solver verdicts that trigger the shift retry (everything else — even
#: ``maxiter``/``stagnated`` — returns normally with its verdict attached:
#: a slow solve is the tenant's tolerance problem, not a health problem)
_RETRY_VERDICTS = ("breakdown", "diverged")


@dataclasses.dataclass
class ServeConfig:
    """Service-wide knobs (per-matrix overrides ride on ``register_matrix``)."""

    cache_capacity: int = 8
    max_queue_depth: int = 4096
    tick_drain: Optional[int] = None      # max requests drained per tick
    k: int = 1
    restart: int = DEFAULT_RESTART
    maxiter: int = DEFAULT_MAXITER
    precond_method: str = "sweep"
    #: where the engines run: None means CUDA (``core.device.resolve_device``);
    #: "cpu" runs the kernels' plain versions
    device: object = None
    buckets: Optional[Sequence[int]] = None
    sharded: bool = False                 # ShardedServeEngine over solve_sharded
    n_devices: int = 2                    # sharded only: band owners on the device
    band_rows: int = 32                   # sharded only
    #: sharded only: the band group the engines run over, the counterpart of
    #: the JAX package's ``mesh`` — None for a one-device
    #: ``BandGroup(n_devices)``; a ``DistBandGroup`` (one owner per rank) is
    #: served from rank 0 inside ``repro_torch.serve.ranks.lead``
    group: object = None
    # -- robustness knobs ---------------------------------------------------
    #: breakdown policy for *register-time* factorization audits
    #: ("raise" | "shift" | "fallback" | "ignore"); solve-time lane retries
    #: are governed by ``retry_on_breakdown`` below
    on_breakdown: str = "shift"
    pivot_tol: Optional[float] = None
    #: one bucketed shift-retry for lanes whose verdict is breakdown/diverged
    retry_on_breakdown: bool = True
    #: deadline applied to requests that don't carry their own (None = none)
    default_deadline_seconds: Optional[float] = None


class SolveService:
    """Multi-tenant front end over the warm bucketed solver stack."""

    def __init__(self, config: Optional[ServeConfig] = None, **kw):
        self.config = config or ServeConfig(**kw)
        self.metrics = ServiceMetrics()
        self.cache = PlanCache(capacity=self.config.cache_capacity,
                               metrics=self.metrics,
                               engine_factory=self._make_engine,
                               on_breakdown=self.config.on_breakdown,
                               pivot_tol=self.config.pivot_tol,
                               engine_key=self._engine_key)
        self.queue = AdmissionQueue(max_depth=self.config.max_queue_depth)
        self._warmed = False
        # ticks must not interleave: the dispatcher thread and any direct
        # tick() caller (tests, drain) serialize here
        self._tick_lock = threading.Lock()

    # -- engine construction -------------------------------------------------
    def _engine_knobs(self, knobs):
        cfg = self.config
        common = dict(restart=cfg.restart, maxiter=cfg.maxiter,
                      precond_method=cfg.precond_method, buckets=cfg.buckets,
                      device=cfg.device)
        if cfg.sharded:
            common.update(n_devices=cfg.n_devices, band_rows=cfg.band_rows, k=cfg.k,
                          group=cfg.group)
        common.update(knobs)
        return common

    def _engine_class(self):
        return ShardedServeEngine if self.config.sharded else ServeEngine

    def _make_engine(self, a, pattern, vals_csr=None, **knobs):
        knobs = self._engine_knobs(knobs)
        group = knobs.get("group")
        if getattr(group, "kind", None) == "ranks":
            from .ranks import leader_of

            leader = leader_of(group)
            if leader is None:
                raise ValueError("a service over a DistBandGroup runs on rank 0 inside "
                                 "repro_torch.serve.ranks.lead, with every other rank in "
                                 "follow: its engines' collectives need every rank")
            return leader.engine(a, pattern, knobs)
        return self._engine_class()(a, pattern, vals_csr, **knobs)

    def _engine_key(self, a, pattern, **knobs):
        return self._engine_class().fingerprint_for(a, pattern, **self._engine_knobs(knobs))

    # -- tenant-facing surface -----------------------------------------------
    def register_matrix(self, matrix_id: str, a: CSRMatrix,
                        k: Optional[int] = None) -> int:
        """Make a matrix solvable; returns the initial value version."""
        entry = self.cache.register(matrix_id, a,
                                    k=self.config.k if k is None else k)
        return entry.version

    def update_matrix_values(self, matrix_id: str, data: np.ndarray,
                             background: bool = True):
        """Push new values (same structure): background refactorization +
        atomic binding swap; other tenants' solves proceed throughout."""
        return self.cache.update_values(matrix_id, data, background=background)

    def submit(self, tenant: str, matrix_id: str, b, tol: float = 1e-5,
               deadline_seconds: Optional[float] = None):
        """Admit one request. Returns the pending :class:`SolveRequest`, or a
        failed :class:`SolveResponse` if any admission check rejects — a
        malformed request costs its tenant one error, nobody else anything."""
        try:
            bv = validate_request(tenant, matrix_id, b, tol,
                                  self.cache.dim_of(matrix_id))
            dl = validate_deadline(deadline_seconds)
            if dl is None:
                dl = self.config.default_deadline_seconds
            entry, binding = self.cache.acquire(matrix_id)  # the pin
            req = SolveRequest(tenant=tenant, matrix_id=matrix_id,
                               b=bv, tol=float(tol), binding=(entry, binding),
                               deadline_seconds=dl)
            if dl is not None:
                req.expires_at = req.submitted_at + dl
            try:
                self.queue.push(req)
            except AdmissionError:
                self.cache.release(matrix_id)
                raise
        except AdmissionError as e:
            self.metrics.record_admission(False, e.reason)
            # rejects count under rejected_by_reason, not the latency
            # histograms — a 0-latency observation would skew every quantile
            return SolveResponse(
                request_id=-1, tenant=tenant, matrix_id=matrix_id, ok=False,
                error=e.detail, error_reason=e.reason)
        self.metrics.record_admission(True)
        return req

    # -- probes ----------------------------------------------------------------
    def healthz(self) -> dict:
        """Liveness: the service object is consistent and can report state."""
        return {
            "ok": True,
            "uptime_seconds": time.time() - self.metrics.started_at,
            "ticks": self.metrics.ticks,
            "queue_depth": len(self.queue),
            "resident_matrices": len(self.cache.resident_ids()),
            "warmed": self._warmed,
        }

    def readyz(self) -> dict:
        """Readiness: warmed engines exist — a request admitted now will
        replay a warmed restart, not pay a build or a capture."""
        resident = self.cache.resident_ids()
        ready = self._warmed and bool(resident)
        return {"ready": ready, "warmed": self._warmed,
                "resident_matrices": len(resident)}

    # -- the tick loop ---------------------------------------------------------
    def tick(self) -> List[SolveResponse]:
        """One dispatch round: drain → coalesce → solve each batch → scatter."""
        with self._tick_lock:
            t0 = time.perf_counter()
            self.metrics.record_queue_depth(len(self.queue))
            reqs = self.queue.drain(self.config.tick_drain)
            responses: List[SolveResponse] = []
            for batch in coalesce(reqs):
                responses.extend(self._run_batch(batch))
            self.metrics.record_tick(time.perf_counter() - t0)
        return responses

    # -- response builders (every terminal path funnels through these, so
    #    req.finish() always fires and the pin is released exactly once) -----
    def _fail(self, r: SolveRequest, batch, reason: str, detail: str,
              verdict: Optional[str] = None) -> SolveResponse:
        self.cache.release(r.matrix_id)
        lat = time.perf_counter() - r.submitted_at
        self.metrics.record_response(r.tenant, False, lat)
        resp = SolveResponse(
            request_id=r.request_id, tenant=r.tenant, matrix_id=r.matrix_id,
            ok=False, error=detail, error_reason=reason, latency_seconds=lat,
            batch_lanes=batch.bucket, matrix_version=batch.binding.version,
            verdict=verdict)
        r.finish(resp)
        return resp

    def _succeed(self, r: SolveRequest, batch, lane, binding) -> SolveResponse:
        self.cache.release(r.matrix_id)
        lat = time.perf_counter() - r.submitted_at
        self.metrics.record_response(r.tenant, True, lat)
        degraded = bool(getattr(binding, "degraded", False)
                        or getattr(binding, "shift", 0.0))
        if degraded:
            self.metrics.record_robustness("degraded_responses")
        resp = SolveResponse(
            request_id=r.request_id, tenant=r.tenant, matrix_id=r.matrix_id,
            ok=True, x=lane.x, iterations=lane.iterations,
            residual=lane.residual, converged=lane.converged,
            latency_seconds=lat, batch_lanes=batch.bucket,
            matrix_version=batch.binding.version, verdict=lane.verdict,
            degraded=degraded, shift=float(getattr(binding, "shift", 0.0)))
        r.finish(resp)
        return resp

    def _run_batch(self, batch, solo: bool = False) -> List[SolveResponse]:
        out: List[SolveResponse] = []
        # 1) deadline sweep: expired requests never occupy a lane
        now = time.perf_counter()
        live: List[SolveRequest] = []
        for r in batch.requests:
            if r.expires_at < now:
                self.metrics.record_robustness("deadline_expired")
                out.append(self._fail(
                    r, batch, DEADLINE_EXCEEDED,
                    f"deadline of {r.deadline_seconds}s elapsed before dispatch"))
            else:
                live.append(r)
        if not live:
            return out

        bs = np.stack([r.b for r in live])
        tols = np.asarray([r.tol for r in live], np.float32)
        t0 = time.perf_counter()
        try:
            lanes = batch.entry.engine.solve(batch.binding, bs, tols)
        except Exception as e:  # noqa: BLE001 — a batch failure must not kill the service
            dt = time.perf_counter() - t0
            self.metrics.record_batch(batch.matrix_id, 0, batch.bucket, dt)
            if len(live) > 1 and not solo:
                # 2) quarantine: one poisoned lane must not fail its
                # co-batched neighbours — re-dispatch each request alone so
                # only the broken one eats the error
                self.metrics.record_robustness("quarantined_batches")
                for r in live:
                    sub = CoalescedBatch(
                        matrix_id=batch.matrix_id, entry=batch.entry,
                        binding=batch.binding, requests=[r],
                        bucket=batch.entry.engine.bucket_for(1))
                    out.extend(self._run_batch(sub, solo=True))
                return out
            for r in live:
                out.append(self._fail(r, batch, SOLVE_FAILED, str(e)))
            return out
        dt = time.perf_counter() - t0
        self.metrics.record_batch(batch.matrix_id, len(live), batch.bucket, dt)

        # 3) verdict pass: split healthy lanes from breakdown/diverged ones
        now = time.perf_counter()
        retry: List[tuple] = []
        for r, lane in zip(live, lanes):
            if r.expires_at < now:
                self.metrics.record_robustness("deadline_expired")
                out.append(self._fail(
                    r, batch, DEADLINE_EXCEEDED,
                    f"deadline of {r.deadline_seconds}s elapsed during solve",
                    verdict=lane.verdict))
            elif lane.verdict in _RETRY_VERDICTS:
                self.metrics.record_robustness("breakdown_lanes")
                retry.append((r, lane))
            else:
                out.append(self._succeed(r, batch, lane, batch.binding))
        if not retry:
            return out

        # 4) shift retry: one bucketed re-solve of just the broken lanes
        # against a shifted-preconditioner binding for the same values
        dbind = None
        if self.config.retry_on_breakdown and not getattr(
                batch.binding, "shift", 0.0):
            dbind = self.cache.degraded_binding(batch.matrix_id, batch.binding)
        if dbind is None:
            for r, lane in retry:
                out.append(self._fail(
                    r, batch, BREAKDOWN,
                    f"solve verdict {lane.verdict!r}"
                    + ("" if self.config.retry_on_breakdown
                       else " (retry_on_breakdown disabled)"),
                    verdict=lane.verdict))
            return out
        self.metrics.record_robustness("shift_retries")
        bs2 = np.stack([r.b for r, _ in retry])
        tols2 = np.asarray([r.tol for r, _ in retry], np.float32)
        t0 = time.perf_counter()
        try:
            lanes2 = batch.entry.engine.solve(dbind, bs2, tols2)
        except Exception as e:  # noqa: BLE001
            for r, lane in retry:
                out.append(self._fail(
                    r, batch, BREAKDOWN,
                    f"shift retry raised: {e}", verdict=lane.verdict))
            return out
        dt = time.perf_counter() - t0
        self.metrics.record_batch(batch.matrix_id, len(retry),
                                  batch.entry.engine.bucket_for(len(retry)), dt)
        for (r, lane0), lane in zip(retry, lanes2):
            if lane.verdict in _RETRY_VERDICTS:
                out.append(self._fail(
                    r, batch, BREAKDOWN,
                    f"solve verdict {lane0.verdict!r}; shift retry at "
                    f"alpha={dbind.shift:g} verdict {lane.verdict!r}",
                    verdict=lane.verdict))
            else:
                self.metrics.record_robustness("retry_recoveries")
                out.append(self._succeed(r, batch, lane, dbind))
        return out

    def run_until_idle(self, max_ticks: int = 10_000) -> List[SolveResponse]:
        """Tick until the queue drains (bounded); returns all responses."""
        out: List[SolveResponse] = []
        for _ in range(max_ticks):
            if not len(self.queue):
                break
            out.extend(self.tick())
        return out

    # -- lifecycle --------------------------------------------------------------
    def warmup(self, matrix_ids: Optional[Sequence[str]] = None) -> dict:
        """Warm every (engine, bucket) pair for the given (default: all
        resident) matrices — on a CUDA device each bucket's restart captured
        as one CUDA graph — then pin the compile baseline: every later
        ``metrics.compiles.after_warmup`` counts serving-path builds and
        captures only. Returns {matrix_id: {bucket: seconds}}.

        Capture vs. other threads: the refactor workers are joined first,
        so no bind runs device work while a graph is captured; the warm-up
        holds the tick lock, since it writes the engines' value slots."""
        self.cache.wait_refactors()
        out = {}
        with self._tick_lock:
            for mid in (matrix_ids if matrix_ids is not None else self.cache.resident_ids()):
                e = self.cache.entry(mid)
                if e is not None:
                    out[mid] = e.engine.warm(e.binding)
        self.metrics.mark_warm()
        self._warmed = True
        return out

    def drain(self, timeout: Optional[float] = None) -> List[SolveResponse]:
        """Graceful stop: finish queued work, join refactor workers."""
        out = self.run_until_idle()
        self.cache.wait_refactors(timeout)
        return out

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()
