"""Bounded-LRU multi-tenant plan/factorization cache with pinning.

The port's counterpart of ``repro/serve/cache.py``. One :class:`CacheEntry`
per registered ``matrix_id``: the matrix object (``a0``), the filled
pattern, a (possibly shared) :class:`~repro_torch.serve.engine.ServeEngine`,
and the *current* :class:`~repro_torch.serve.engine.EngineBinding` (value
version). Three protocols:

**LRU + pinning.** Capacity bounds device memory. Every in-flight request
holds a pin on its entry; eviction only reclaims unpinned entries
(least-recently-used first). If the cache is full of pinned entries the
insert fails with ``QUEUE_FULL`` semantics rather than evicting a solve's
data out from under it. An evicted matrix can be re-registered — with the
engine shared by structure, re-admission rebuilds nothing if a
structure-mate is still resident.

**Engine sharing.** Engines are keyed by their fingerprint (structure +
knobs, never values) in a ``WeakValueDictionary``: tenants with identical
sparsity share one engine — one set of value slots and one restart graph
per bucket; the engine dies with its last entry. With an ``engine_key``
the key is reckoned before an engine is built, so a structure-mate costs
no engine at all.

**Background refactorization.** ``update_values`` refactorizes the new
values through the engine's structure-keyed plan (the first registrant of
the structure is its host) and binds them — in a worker thread, so a
tenant's value push never blocks other tenants' solves. The worker runs
inside the engine's ``refactoring()`` lane where it has one (a sharded
engine: over ranks the refactor's exchanges go through a process group of
their own and a follower thread of their own, ``serve.ranks``). The swap is atomic
(one reference assignment under the cache lock); requests admitted before
the swap keep their pinned old binding (``SolveRequest.binding``) and
solve against the values they were admitted under — a racing update can
never retarget an in-flight solve mid-batch.

**Streams.** On a CUDA device a bind's device work (the factorization, the
values' scatter and staging) runs on a stream of its own, which the bind
synchronizes before the binding is returned and published: the tick's
slot refill then reads finished tensors, and the tick's replays are not
queued behind a refactorization. The same holds for the shift ladder when
a tick climbs it (:meth:`PlanCache.degraded_binding`).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.sparse import CSRMatrix

from .admission import BREAKDOWN, QUEUE_FULL, UNKNOWN_MATRIX, AdmissionError
from .engine import ServeEngine


def identity_values(pattern) -> np.ndarray:
    """Pattern-aligned factor values of the identity (diag 1, rest 0).

    Swept through the bound triangular kernel these apply M^{-1} = I
    exactly — every L lane contributes a rounded ``0·y = ±0`` to a sum that
    starts at +0.0, and every U diagonal divides by 1.0 — so the serve
    layer's last-resort degradation costs a bind and a slot refill, never
    a capture."""
    vals = np.zeros(pattern.nnz, np.float32)
    vals[np.asarray(pattern.indptr[:-1]) + np.asarray(pattern.diag_ptr)] = 1.0
    return vals


@contextlib.contextmanager
def bind_stream(device):
    """Run the block's device work on a CUDA stream of its own and
    synchronize it on exit (nothing on the CPU): a binding made inside is
    finished when the block ends, and the block never queues behind, or
    ahead of, the tick's solves on the current stream."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))  # the engine's tables are made
    with torch.cuda.stream(stream):
        yield
    stream.synchronize()


class CacheEntry:
    """One resident matrix: canonical host objects + current binding."""

    def __init__(self, matrix_id: str, a0: CSRMatrix, pattern, engine, binding,
                 plan_host: Optional[CSRMatrix] = None):
        self.matrix_id = matrix_id
        self.a0 = a0              # this entry's own matrix (structure + values)
        self.pattern = pattern
        self.engine = engine
        self.binding = binding    # current EngineBinding (atomic-swap target)
        # canonical same-structure matrix the FactorPlan memoizes on (the
        # engine's host: the first registrant of this structure)
        self.plan_host = plan_host if plan_host is not None else a0
        self.pins = 0
        self.version = binding.version
        # lazily built shifted-preconditioner bindings for breakdown
        # retries, keyed by ("shift", base binding version) — one ladder
        # climb per value version, shared by every retrying request
        self.degraded_bindings: dict = {}


class PlanCache:
    """The bounded-LRU store. All public methods are thread-safe; solves,
    submits, and background refactor threads may interleave freely.

    An engine (what ``engine_factory(a, pattern, vals_csr, **knobs)``
    returns) provides ``fingerprint``, ``buckets``, ``bucket_for``,
    ``device``, ``host``, ``factor(a)``, ``audit(factored, pivot_tol)``,
    ``bind(a, factored)``, ``bind_degraded(a, shift, factorize)``, ``solve``
    and ``warm``. ``engine_key(a, pattern, **knobs)``, when given, reckons
    the fingerprint without building an engine."""

    def __init__(self, capacity: int = 8, metrics=None,
                 engine_factory: Optional[Callable] = None,
                 on_breakdown: str = "shift", pivot_tol: Optional[float] = None,
                 engine_key: Optional[Callable] = None):
        if capacity < 1:
            raise ValueError(f"PlanCache capacity must be >= 1, got {capacity}")
        if on_breakdown not in ("raise", "shift", "fallback", "ignore"):
            raise ValueError(f"PlanCache: unknown on_breakdown {on_breakdown!r}")
        self.capacity = capacity
        self.metrics = metrics
        # pivot-guard policy for every factorization this cache performs
        # (serve default "shift": a tenant's broken matrix registers with a
        # shifted preconditioner instead of poisoning its future batches)
        self.on_breakdown = on_breakdown
        self.pivot_tol = pivot_tol
        self._engine_factory = engine_factory or self._default_engine_factory
        self._engine_key = engine_key
        self._lock = threading.RLock()
        self._entries: "collections.OrderedDict[str, CacheEntry]" = collections.OrderedDict()
        # structure-keyed engine sharing; weak so engines die with their entries
        self._engines_by_structure = weakref.WeakValueDictionary()
        self._refactor_threads: Dict[str, threading.Thread] = {}

    # -- construction helpers ----------------------------------------------
    @staticmethod
    def _default_engine_factory(a, pattern, vals_csr=None, **knobs):
        return ServeEngine(a, pattern, vals_csr, **knobs)

    def _factorize(self, engine, a: CSRMatrix):
        """The factorization of ``a`` through ``engine``'s structure-keyed
        plan (memoized on the engine's host matrix): the first call per
        structure plans, every refactorization after is an execute."""
        return engine.factor(a)

    # -- registration -------------------------------------------------------
    def register(self, matrix_id: str, a: CSRMatrix, k: int = 1, **engine_knobs) -> CacheEntry:
        """Insert (or replace) a matrix: symbolic fill, engine lookup/build,
        numeric factorize, value bind. May evict an unpinned LRU entry.
        Same-structure registrations share one engine (and through its host
        one factor plan) — the second tenant of a structure onboards without
        a single build or capture."""
        from repro_torch.core.api import _symbolic

        pattern = _symbolic(a, k, "sum")
        with self._lock:
            engine = self._shared_engine(a, pattern, engine_knobs)
        with bind_stream(engine.device):
            factored = self._factorize(engine, a)
            binding = self._guarded_bind(engine, pattern, a, factored)
        with self._lock:
            self._evict_for_insert(exclude=matrix_id)
            entry = CacheEntry(matrix_id, a, pattern, engine, binding,
                               plan_host=getattr(engine, "host", a))
            self._entries[matrix_id] = entry
            self._entries.move_to_end(matrix_id)
            return entry

    def _guarded_bind(self, engine, pattern, a, factored):
        """Audit the fresh factorization and bind per ``on_breakdown``:
        healthy values bind as-is (the audit is a pure read — the binding
        is bitwise what an unguarded bind produces); broken ones climb the
        shift ladder through the same engine, and exhaustion either binds
        the exact identity preconditioner (``"fallback"``) or rejects the
        matrix with a structured BREAKDOWN."""
        from repro_torch.core.guard import ladder_alphas

        if self.on_breakdown == "ignore":
            return engine.bind(a, factored)
        health = engine.audit(factored, self.pivot_tol)
        if health.ok:
            return engine.bind(a, factored)
        if self.metrics is not None:
            self.metrics.record_robustness("broken_factorizations")
        if self.on_breakdown == "raise":
            raise AdmissionError(BREAKDOWN, health.summary())

        def factorize(m):
            return self._factorize(engine, m)

        for alpha in ladder_alphas():
            b2 = engine.bind_degraded(a, alpha, factorize)
            if b2 is not None:
                if self.metrics is not None:
                    self.metrics.record_robustness("shifted_bindings")
                return b2
        if self.on_breakdown == "fallback" and getattr(
                engine, "supports_identity_fallback", False):
            b2 = engine.bind(a, identity_values(pattern))
            b2.degraded = True
            if self.metrics is not None:
                self.metrics.record_robustness("identity_fallbacks")
            return b2
        raise AdmissionError(
            BREAKDOWN, f"shift ladder exhausted: {health.summary()}")

    def _shared_engine(self, a, pattern, knobs):
        fp = None if self._engine_key is None else self._engine_key(a, pattern, **knobs)
        probe = None
        if fp is None:
            probe = self._engine_factory(a, pattern, None, **knobs)
            fp = getattr(probe, "fingerprint", None)
            if fp is None:
                return probe
        existing = self._engines_by_structure.get(fp)
        if existing is not None:
            if self.metrics is not None:
                self.metrics.record_cache("engine_shared")
            return existing
        if probe is None:
            probe = self._engine_factory(a, pattern, None, **knobs)
        self._engines_by_structure[fp] = probe
        return probe

    def _evict_for_insert(self, exclude: str) -> None:
        while len(self._entries) >= self.capacity + (1 if exclude in self._entries else 0):
            victim = None
            for mid, e in self._entries.items():  # OrderedDict: LRU first
                if mid != exclude and e.pins == 0:
                    victim = mid
                    break
            if victim is None:
                raise AdmissionError(
                    QUEUE_FULL,
                    f"plan cache full ({self.capacity} entries, all pinned by "
                    "in-flight solves); retry after current batches drain")
            del self._entries[victim]
            if self.metrics is not None:
                self.metrics.record_cache("evict")

    # -- lookup + pinning ----------------------------------------------------
    def dim_of(self, matrix_id: str) -> Optional[int]:
        with self._lock:
            e = self._entries.get(matrix_id)
            return None if e is None else e.a0.n

    def acquire(self, matrix_id: str):
        """Pin the entry's *current* binding for one request; returns
        ``(entry, binding)``. The pin blocks eviction; the binding reference
        keeps the value tensors alive even across a racing update (the
        solve runs on the version the request was admitted under)."""
        with self._lock:
            e = self._entries.get(matrix_id)
            if e is None:
                if self.metrics is not None:
                    self.metrics.record_cache("miss")
                raise AdmissionError(
                    UNKNOWN_MATRIX, f"matrix_id {matrix_id!r} is not resident")
            e.pins += 1
            self._entries.move_to_end(matrix_id)
            if self.metrics is not None:
                self.metrics.record_cache("hit")
            return e, e.binding

    def release(self, matrix_id: str) -> None:
        with self._lock:
            e = self._entries.get(matrix_id)
            if e is not None and e.pins > 0:
                e.pins -= 1

    # -- value updates -------------------------------------------------------
    def update_values(self, matrix_id: str, data: np.ndarray,
                      background: bool = True) -> threading.Thread:
        """Refactorize ``matrix_id`` with new values (same structure) and
        atomically swap the entry's binding. Runs in a worker thread by
        default — registration lookups and other tenants' solves proceed
        during the numeric factorization; only the final reference swap
        takes the lock. Returns the worker (already joined if
        ``background=False``)."""
        with self._lock:
            e = self._entries.get(matrix_id)
            if e is None:
                raise AdmissionError(
                    UNKNOWN_MATRIX, f"matrix_id {matrix_id!r} is not resident")
            a0, pattern, engine = e.a0, e.pattern, e.engine
            data = np.asarray(data, np.float32)
            if data.shape != a0.data.shape:
                raise ValueError(
                    f"update_values: expected {a0.data.shape[0]} values for the "
                    f"structure of {matrix_id!r}, got {data.shape}")

        def work():
            a_new = CSRMatrix(n=a0.n, indptr=a0.indptr, indices=a0.indices, data=data)
            # a sharded engine's refactor lane: over ranks its exchanges go
            # through a group of their own, never the solves' communicator
            lane = getattr(engine, "refactoring", contextlib.nullcontext)
            with lane(), bind_stream(engine.device):
                factored = self._factorize(engine, a_new)
                try:
                    binding = self._guarded_bind(engine, pattern, a_new, factored)
                except AdmissionError:
                    binding = None
            if binding is None:
                # a value push that breaks down unrecoverably keeps the old
                # binding serving — existing requests stay healthy; the
                # counter records the rejected update
                if self.metrics is not None:
                    self.metrics.record_robustness("rejected_updates")
                return
            with self._lock:
                cur = self._entries.get(matrix_id)
                if cur is not None and cur.engine is engine:
                    cur.binding = binding      # the atomic swap
                    cur.version = binding.version
            if self.metrics is not None:
                self.metrics.record_cache("refactor")

        t = threading.Thread(target=work, name=f"refactor-{matrix_id}", daemon=True)
        with self._lock:
            self._refactor_threads[matrix_id] = t
        t.start()
        if not background:
            t.join()
        return t

    def degraded_binding(self, matrix_id: str, binding) -> Optional["object"]:
        """A shifted-preconditioner binding for retrying breakdown lanes.

        Climbs the α ladder against the *exact matrix of the base binding*
        (``binding.a`` — not the entry's possibly newer values: the retry
        must solve the system the request was admitted under), audits each
        rung, and caches the first healthy binding per base version so one
        ladder climb serves every retrying request of that version. The
        retried solve's matvec still targets the original A — only the
        preconditioner is shifted. Returns None when the ladder exhausts
        (the caller fails the lane with a structured BREAKDOWN)."""
        from repro_torch.core.guard import ladder_alphas

        with self._lock:
            e = self._entries.get(matrix_id)
            if e is None or binding.a is None:
                return None
            key = ("shift", binding.version)
            cached = e.degraded_bindings.get(key)
            if cached is not None:
                return cached
            engine = e.engine

        def factorize(m):
            return self._factorize(engine, m)

        for alpha in ladder_alphas():
            try:
                with bind_stream(engine.device):
                    b2 = engine.bind_degraded(binding.a, alpha, factorize)
            except Exception:
                return None
            if b2 is not None:
                with self._lock:
                    cur = self._entries.get(matrix_id)
                    if cur is not None:
                        cur.degraded_bindings[key] = b2
                return b2
        return None

    def wait_refactors(self, timeout: Optional[float] = None) -> None:
        """Join all outstanding refactor workers (tests / drain / warmup)."""
        with self._lock:
            threads = list(self._refactor_threads.values())
        for t in threads:
            t.join(timeout)

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, matrix_id: str) -> bool:
        with self._lock:
            return matrix_id in self._entries

    def entry(self, matrix_id: str) -> Optional[CacheEntry]:
        with self._lock:
            return self._entries.get(matrix_id)

    def resident_ids(self):
        with self._lock:
            return list(self._entries)
