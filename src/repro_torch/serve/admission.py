"""Request front end: types, validation, and the bounded admission queue
(a copy of ``repro/serve/admission.py``; the reason codes are the same).

A request is ``(tenant, matrix_id, b, tol)`` plus solver knobs; admission
is the only place malformed input can enter the service, so every check
lives here and fails **that one request** with a structured reason — never
the coalesced batch it would have ridden in, never the process. Checks:

* ``matrix_id`` registered (and not mid-eviction without a host copy),
* ``b`` a finite 1-D float vector of the matrix's dimension,
* ``tol`` a finite positive float,
* queue depth below the admission bound (load shedding, not OOM).

The queue is a plain FIFO deque; fairness across tenants comes from the
coalescer batching *across* tenants rather than per-tenant queues — a
burst from one tenant fills lanes that would otherwise be padding.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

#: admission-reject / failure reason codes (stable strings — they key the
#: ``rejected_by_reason`` metrics map and the fault-injection tests)
UNKNOWN_MATRIX = "unknown_matrix"
BAD_SHAPE = "bad_shape"
NON_FINITE = "non_finite"
BAD_TOL = "bad_tol"
BAD_DEADLINE = "bad_deadline"
QUEUE_FULL = "queue_full"
SOLVE_FAILED = "solve_failed"
#: the request's deadline elapsed before (or while) its batch solved
DEADLINE_EXCEEDED = "deadline_exceeded"
#: the lane's solve classified as breakdown/diverged and the shift retry
#: (if enabled) did not recover it
BREAKDOWN = "breakdown"


class AdmissionError(ValueError):
    """Raised (and caught at the submit boundary) for a rejected request."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


_req_ids = itertools.count()


@dataclasses.dataclass
class SolveRequest:
    """One admitted solve: fixed at submit time, immutable afterwards."""

    tenant: str
    matrix_id: str
    b: np.ndarray  # (n,) float32, validated finite
    tol: float
    request_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    # bound at admission: the cache-entry binding this request will solve
    # against (a racing value update must not retarget an in-flight solve)
    binding: object = None
    #: wall-clock budget (None = no deadline); checked before dispatch and
    #: again before the response is recorded — an expired request fails with
    #: DEADLINE_EXCEEDED instead of occupying a lane
    deadline_seconds: Optional[float] = None
    expires_at: float = float("inf")
    # async completion: the dispatcher sets `response` then fires `done`;
    # synchronous tick() callers read the returned responses instead
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)
    response: object = dataclasses.field(default=None, repr=False, compare=False)

    def finish(self, resp) -> None:
        self.response = resp
        self.done.set()

    def result(self, timeout: Optional[float] = None):
        """Block until this request's response exists (async dispatcher
        path). Returns None on timeout."""
        if self.done.wait(timeout):
            return self.response
        return None


@dataclasses.dataclass
class SolveResponse:
    """Terminal state of a request — success or per-request failure."""

    request_id: int
    tenant: str
    matrix_id: str
    ok: bool
    x: Optional[np.ndarray] = None
    iterations: int = 0
    residual: float = float("nan")
    converged: bool = False
    error: Optional[str] = None
    error_reason: Optional[str] = None
    latency_seconds: float = 0.0
    #: bucket the request was coalesced into (lanes incl. padding); 0 = failed pre-solve
    batch_lanes: int = 0
    #: cache-entry version the solve ran against (refactorization audit trail)
    matrix_version: int = -1
    #: solver termination verdict for this lane (solvers.VERDICTS), None
    #: when the request never reached a solve
    verdict: Optional[str] = None
    #: True when the response came from a degraded path: a shift-retry
    #: recovery or an identity-preconditioner fallback
    degraded: bool = False
    #: diagonal shift α of the preconditioner that produced this response
    shift: float = 0.0


def validate_deadline(deadline_seconds) -> Optional[float]:
    """Validate a per-request deadline; returns the float budget or None."""
    if deadline_seconds is None:
        return None
    try:
        d = float(deadline_seconds)
    except (TypeError, ValueError):
        raise AdmissionError(
            BAD_DEADLINE, f"deadline {deadline_seconds!r} is not a float") from None
    if not (np.isfinite(d) and d > 0):
        raise AdmissionError(
            BAD_DEADLINE, f"deadline must be a finite positive float, got {d}")
    return d


def validate_request(tenant: str, matrix_id: str, b, tol, n: Optional[int]) -> np.ndarray:
    """All admission checks; returns the validated float32 RHS or raises
    :class:`AdmissionError`. ``n=None`` means the matrix is unknown."""
    if n is None:
        raise AdmissionError(UNKNOWN_MATRIX, f"matrix_id {matrix_id!r} is not registered")
    try:
        b = np.asarray(b, np.float32)
    except (TypeError, ValueError) as e:
        raise AdmissionError(BAD_SHAPE, f"b is not a numeric array: {e}") from None
    if b.ndim != 1 or b.shape[0] != n:
        raise AdmissionError(
            BAD_SHAPE,
            f"b must have shape ({n},) for matrix {matrix_id!r}, got {b.shape}")
    if not np.all(np.isfinite(b)):
        bad = int(np.sum(~np.isfinite(b)))
        raise AdmissionError(NON_FINITE, f"b contains {bad} non-finite entries")
    try:
        tol = float(tol)
    except (TypeError, ValueError):
        raise AdmissionError(BAD_TOL, f"tol {tol!r} is not a float") from None
    if not (np.isfinite(tol) and tol > 0):
        raise AdmissionError(BAD_TOL, f"tol must be a finite positive float, got {tol}")
    return b


class AdmissionQueue:
    """Bounded FIFO of admitted requests (thread-safe: submits may come
    from tenant threads while the tick loop drains)."""

    def __init__(self, max_depth: int = 4096):
        self.max_depth = max_depth
        self._q: deque = deque()
        self._lock = threading.Lock()

    def push(self, req: SolveRequest) -> None:
        with self._lock:
            if len(self._q) >= self.max_depth:
                raise AdmissionError(
                    QUEUE_FULL,
                    f"admission queue at max depth {self.max_depth}; retry later")
            self._q.append(req)

    def drain(self, limit: Optional[int] = None):
        """Pop up to ``limit`` requests (FIFO). The coalescer calls this
        once per tick and regroups by matrix."""
        out = []
        with self._lock:
            while self._q and (limit is None or len(out) < limit):
                out.append(self._q.popleft())
        return out

    def requeue_front(self, reqs) -> None:
        """Put overflow requests back at the *front*, preserving FIFO order
        (used when a tick's compatible group exceeds the largest bucket)."""
        with self._lock:
            for r in reversed(reqs):
                self._q.appendleft(r)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)
