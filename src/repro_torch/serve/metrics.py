"""Observability for the solve service: histograms, counters, compile watch.

The port's counterpart of ``repro/serve/metrics.py``. Everything here is
host-side bookkeeping designed around one consumer: the JSON metrics
snapshot (:meth:`ServiceMetrics.snapshot`) that the soak test asserts a
schema on. Four kinds of signals:

* **Per-tenant latency** — log-spaced histogram buckets plus a bounded
  reservoir of raw observations so p50/p99 are exact for soak-sized runs
  (the histogram alone would quantize the p99 the acceptance bar pins).
* **Service counters** — queue depth (sampled per tick), coalesced-batch
  occupancy (real lanes / bucket lanes), cache hit/miss/evict/refactor
  counts, admission rejects by reason.
* **Compile counter** — the port compiles nothing per request: what it
  builds is the kernel library (``kernels.build.load``), the
  :class:`~repro_torch.core.solvers.WarmRestart` engines and their CUDA
  graph captures. :func:`compile_count` sums the three, process-wide.
  After warmup this number must go *flat*: an increment on the serving
  path means a request paid a build or a capture, the failure mode the
  warm/bucketed architecture exists to prevent. ``CompileWatch.mark`` /
  ``since_mark`` make "zero new compiles after warmup" a one-line assert.
* **Cold restarts** — GMRES restarts run eagerly because no warmed engine
  had the solve's key. On the CPU nothing is captured, so this is what
  shows there that every served batch went through a warmed engine.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional


# --------------------------------------------------------------------------
# compile and cold-restart counters
# --------------------------------------------------------------------------
def compile_count() -> int:
    """Kernel libraries loaded + WarmRestart engines made + restarts
    captured as CUDA graphs, since the process started."""
    from repro_torch.core.solvers import engine_events
    from repro_torch.kernels.build import load_count

    ev = engine_events()
    return load_count() + ev["warm_builds"] + ev["captures"]


def cold_restart_count() -> int:
    """GMRES restarts run eagerly, outside any warmed engine, since the
    process started."""
    from repro_torch.core.solvers import engine_events

    return engine_events()["cold_restarts"]


class CompileWatch:
    """Snapshot-and-delta view of a process-wide counter (by default
    :func:`compile_count`)."""

    def __init__(self, count=compile_count):
        self._count = count
        self._mark = count()

    def mark(self) -> int:
        """Reset the baseline (call when warmup finishes); returns it."""
        self._mark = self._count()
        return self._mark

    def since_mark(self) -> int:
        return self._count() - self._mark


# --------------------------------------------------------------------------
# Latency histogram
# --------------------------------------------------------------------------
class LatencyHistogram:
    """Log-spaced latency histogram with an exact-percentile reservoir.

    Buckets span 10 µs … ~100 s at 10 per decade (a fixed, snapshot-stable
    set). The reservoir keeps the most recent ``reservoir`` raw values so
    quantiles are exact over the window the soak measures; the bucket
    counts never saturate and cover the full history.
    """

    DECADES = (1e-5, 1e2)
    PER_DECADE = 10

    def __init__(self, reservoir: int = 100_000):
        ndec = int(round(math.log10(self.DECADES[1] / self.DECADES[0])))
        self.bounds = [
            self.DECADES[0] * 10 ** (i / self.PER_DECADE)
            for i in range(ndec * self.PER_DECADE + 1)
        ]
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum_seconds = 0.0
        self._raw: collections.deque = collections.deque(maxlen=reservoir)

    def observe(self, seconds: float) -> None:
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # first bound > value
            mid = (lo + hi) // 2
            if seconds < self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.total += 1
        self.sum_seconds += seconds
        self._raw.append(seconds)

    def quantile(self, q: float) -> float:
        """Exact quantile over the reservoir window (0 when empty)."""
        if not self._raw:
            return 0.0
        xs = sorted(self._raw)
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]

    def to_dict(self) -> dict:
        return {
            "count": self.total,
            "mean_seconds": (self.sum_seconds / self.total) if self.total else 0.0,
            "p50_seconds": self.quantile(0.50),
            "p99_seconds": self.quantile(0.99),
            "max_seconds": max(self._raw) if self._raw else 0.0,
            "bucket_bounds_seconds": self.bounds,
            "bucket_counts": list(self.counts),
        }


# --------------------------------------------------------------------------
# Service-wide metrics
# --------------------------------------------------------------------------
@dataclasses.dataclass
class BatchRecord:
    matrix_id: str
    real_lanes: int
    bucket: int
    solve_seconds: float


class ServiceMetrics:
    """All service counters + histograms, snapshotting to one JSON dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self.started_at = time.time()
        self.tenant_latency: Dict[str, LatencyHistogram] = {}
        self.queue_depth_samples: List[int] = []
        self.max_queue_depth = 0
        self.batches: List[BatchRecord] = []
        self.requests_admitted = 0
        self.requests_completed = 0
        self.requests_failed = 0
        self.rejects_by_reason: Dict[str, int] = collections.defaultdict(int)
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self.refactorizations = 0
        self.engines_shared = 0
        self.ticks = 0
        self.solve_seconds_total = 0.0
        self.compile_watch = CompileWatch()
        self.warmup_compiles = 0
        self.cold_watch = CompileWatch(cold_restart_count)
        self.warmup_cold_restarts = 0
        # robustness counters (breakdown/retry/degradation accounting);
        # defaultdict so new counter names need no schema change here
        self.robustness: Dict[str, int] = collections.defaultdict(int)
        # tick-duration health: EWMA-based slow-tick detector (the
        # StragglerMonitor from runtime/fault) + an exact-percentile histogram
        from repro_torch.runtime.fault import StragglerMonitor

        self.tick_monitor = StragglerMonitor(deadline_factor=3.0)
        self.tick_hist = LatencyHistogram(reservoir=10_000)

    # -- recording hooks (called by the service/cache/coalescer) ----------
    def record_admission(self, ok: bool, reason: Optional[str] = None) -> None:
        with self._lock:
            if ok:
                self.requests_admitted += 1
            else:
                self.rejects_by_reason[reason or "unknown"] += 1

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth_samples.append(depth)
            self.max_queue_depth = max(self.max_queue_depth, depth)

    def record_batch(self, matrix_id: str, real: int, bucket: int, seconds: float) -> None:
        with self._lock:
            self.batches.append(BatchRecord(matrix_id, real, bucket, seconds))
            self.solve_seconds_total += seconds

    def record_response(self, tenant: str, ok: bool, latency_seconds: float) -> None:
        with self._lock:
            if ok:
                self.requests_completed += 1
            else:
                self.requests_failed += 1
            hist = self.tenant_latency.get(tenant)
            if hist is None:
                hist = self.tenant_latency[tenant] = LatencyHistogram()
            hist.observe(latency_seconds)

    def record_cache(self, event: str, n: int = 1) -> None:
        with self._lock:
            if event == "hit":
                self.cache_hits += n
            elif event == "miss":
                self.cache_misses += n
            elif event == "evict":
                self.cache_evictions += n
            elif event == "refactor":
                self.refactorizations += n
            elif event == "engine_shared":
                self.engines_shared += n
            else:
                raise ValueError(f"unknown cache event {event!r}")

    def record_tick(self, seconds: Optional[float] = None) -> None:
        """Count a tick; with ``seconds`` also feed the slow-tick monitor
        (EWMA straggler detection) and the tick-duration histogram."""
        with self._lock:
            self.ticks += 1
            if seconds is not None:
                self.tick_monitor.observe(seconds)
                self.tick_hist.observe(seconds)

    def record_robustness(self, name: str, n: int = 1) -> None:
        """Bump a named robustness counter (breakdown_lanes, shift_retries,
        retry_recoveries, degraded_responses, deadline_expired,
        quarantined_batches, broken_factorizations, shifted_bindings,
        identity_fallbacks, rejected_updates, ...)."""
        with self._lock:
            self.robustness[name] += n

    def mark_warm(self) -> None:
        """End of warmup: pin the compile baseline. ``compiles_after_warmup``
        in every later snapshot counts only serving-path compiles."""
        with self._lock:
            self.warmup_compiles = compile_count()
            self.warmup_cold_restarts = cold_restart_count()
        self.compile_watch.mark()
        self.cold_watch.mark()

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-serializable dict of everything above — the schema the
        soak test pins: the JAX package's keys, and ``cold_restarts``."""
        with self._lock:
            occupancies = [b.real_lanes / b.bucket for b in self.batches if b.bucket]
            lanes = sum(b.real_lanes for b in self.batches)
            padded = sum(b.bucket - b.real_lanes for b in self.batches)
            qd = self.queue_depth_samples
            lookups = self.cache_hits + self.cache_misses
            return {
                "uptime_seconds": time.time() - self.started_at,
                "ticks": self.ticks,
                "requests": {
                    "admitted": self.requests_admitted,
                    "completed": self.requests_completed,
                    "failed": self.requests_failed,
                    "rejected_by_reason": dict(self.rejects_by_reason),
                },
                "queue": {
                    "depth_samples": len(qd),
                    "depth_mean": (sum(qd) / len(qd)) if qd else 0.0,
                    "depth_max": self.max_queue_depth,
                },
                "coalescing": {
                    "batches": len(self.batches),
                    "solved_lanes": lanes,
                    "padded_lanes": padded,
                    "occupancy_mean": (sum(occupancies) / len(occupancies)) if occupancies else 0.0,
                    "occupancy_min": min(occupancies) if occupancies else 0.0,
                    "solve_seconds_total": self.solve_seconds_total,
                },
                "cache": {
                    "hits": self.cache_hits,
                    "misses": self.cache_misses,
                    "hit_rate": (self.cache_hits / lookups) if lookups else 0.0,
                    "evictions": self.cache_evictions,
                    "refactorizations": self.refactorizations,
                    "engines_shared": self.engines_shared,
                },
                "compiles": {
                    "total": compile_count(),
                    "warmup": self.warmup_compiles,
                    "after_warmup": self.compile_watch.since_mark(),
                },
                "cold_restarts": {
                    "total": cold_restart_count(),
                    "warmup": self.warmup_cold_restarts,
                    "after_warmup": self.cold_watch.since_mark(),
                },
                "robustness": dict(self.robustness),
                "tick_health": {
                    "observed": self.tick_monitor.steps,
                    "slow_ticks": self.tick_monitor.slow_steps,
                    "deadline_factor": self.tick_monitor.deadline_factor,
                    "mean_seconds": (self.tick_hist.sum_seconds / self.tick_hist.total)
                    if self.tick_hist.total else 0.0,
                    "p99_seconds": self.tick_hist.quantile(0.99),
                },
                "tenants": {t: h.to_dict() for t, h in sorted(self.tenant_latency.items())},
            }
