"""Deterministic synthetic traffic for soak tests and the serve smoke run
(a copy of ``repro/serve/traffic.py``).

Everything derives from one ``numpy`` Generator seed: tenant arrival
order, burst sizes, RHS vectors, tolerance choices, and the optional
malformed-request / value-update injections. Replaying the same seed
against the same service configuration produces byte-identical submits —
which is what lets the soak test assert byte-identical responses and a
deterministic metrics shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .admission import SolveRequest, SolveResponse
from .service import SolveService


@dataclasses.dataclass
class TrafficRecord:
    """One submitted request + everything needed to recompute its solo
    reference solve (the bitwise check the soak runs afterwards)."""

    request_id: int
    tenant: str
    matrix_id: str
    b: np.ndarray
    tol: float
    expected_version: int       # binding version pinned at admission
    kind: str = "solve"         # "solve" | "malformed" | "update"


@dataclasses.dataclass
class TrafficResult:
    records: List[TrafficRecord]
    responses: List[SolveResponse]
    rejected: List[SolveResponse]
    updates: Dict[str, List[np.ndarray]]   # value pushes per matrix (in order)


def run_traffic(service: SolveService, matrix_ids: Sequence[str],
                n_requests: int, seed: int = 0,
                tenants: Sequence[str] = ("t0", "t1", "t2", "t3"),
                tol_choices: Sequence[float] = (1e-4, 1e-5, 1e-6),
                burst_max: int = 8,
                malformed_prob: float = 0.0,
                update_prob: float = 0.0,
                update_values: Optional[Dict[str, List[np.ndarray]]] = None,
                tick_every_burst: bool = True) -> TrafficResult:
    """Drive ``n_requests`` seeded solve submissions through the service.

    Per burst: a tenant, a matrix, a burst size, and per-request (b, tol)
    draws; the burst submits back-to-back (that's what the coalescer sees
    as one tick's worth of compatible lanes). ``malformed_prob`` injects a
    bad request per burst (wrong shape / non-finite b / bad tol — rotated
    deterministically); ``update_prob`` pushes the next queued value array
    from ``update_values`` for the burst's matrix. Runs until every
    admitted request has a response; returns the full audit trail.
    """
    rng = np.random.default_rng(seed)
    dims = {mid: service.cache.entry(mid).a0.n for mid in matrix_ids}
    records: List[TrafficRecord] = []
    responses: List[SolveResponse] = []
    rejected: List[SolveResponse] = []
    updates: Dict[str, List[np.ndarray]] = {mid: [] for mid in matrix_ids}
    update_queues = {mid: list(vs) for mid, vs in (update_values or {}).items()}
    malformed_kind = 0
    submitted = 0

    while submitted < n_requests:
        mid = matrix_ids[int(rng.integers(len(matrix_ids)))]
        n = dims[mid]
        burst = int(rng.integers(1, burst_max + 1))
        burst = min(burst, n_requests - submitted)

        if update_prob > 0 and update_queues.get(mid) and rng.random() < update_prob:
            data = update_queues[mid].pop(0)
            updates[mid].append(data)
            service.update_matrix_values(mid, data, background=True)

        if malformed_prob > 0 and rng.random() < malformed_prob:
            bad = malformed_kind % 3
            malformed_kind += 1
            tenant = tenants[int(rng.integers(len(tenants)))]
            if bad == 0:
                resp = service.submit(tenant, mid, np.ones(n + 3, np.float32))
            elif bad == 1:
                b = np.ones(n, np.float32)
                b[0] = np.nan
                resp = service.submit(tenant, mid, b)
            else:
                resp = service.submit(tenant, mid, np.ones(n, np.float32), tol=-1.0)
            rejected.append(resp)

        for _ in range(burst):
            tenant = tenants[int(rng.integers(len(tenants)))]
            b = rng.standard_normal(n).astype(np.float32)
            tol = float(tol_choices[int(rng.integers(len(tol_choices)))])
            out = service.submit(tenant, mid, b, tol=tol)
            if isinstance(out, SolveRequest):
                records.append(TrafficRecord(
                    request_id=out.request_id, tenant=tenant, matrix_id=mid,
                    b=b, tol=tol, expected_version=out.binding[1].version))
                submitted += 1
            else:
                rejected.append(out)

        if tick_every_burst:
            responses.extend(service.tick())

    responses.extend(service.drain())
    return TrafficResult(records=records, responses=responses,
                         rejected=rejected, updates=updates)
