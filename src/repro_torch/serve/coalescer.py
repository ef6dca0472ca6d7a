"""Cross-tenant request coalescing: one bucketed multi-RHS solve per group
(a copy of ``repro/serve/coalescer.py``).

A tick drains the admission queue and regroups requests by **compat key**:
the (matrix_id, binding) pair pinned at admission. Same key ⇒ same engine,
same value version ⇒ the requests can ride as lanes of one batched GMRES
solve (one lane axis, one warmed restart per bucket). Tenant identity is
deliberately *not* part of the key — coalescing across tenants is the
point (one tenant's burst fills lanes another tenant's trickle would have
left as padding).

Groups larger than the largest bucket **chunk** into consecutive
largest-bucket batches inside the same tick (FIFO order preserved within
the group): an oversized group costs extra dispatches, never a failure and
never starvation. Bit-compat makes this free — a lane's bits do not depend
on which batch it rode in.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .admission import SolveRequest


@dataclasses.dataclass
class CoalescedBatch:
    """One solver dispatch: requests sharing an engine + value binding."""

    matrix_id: str
    entry: object            # cache.CacheEntry
    binding: object          # engine.EngineBinding the lanes solve against
    requests: List[SolveRequest]
    bucket: int              # padded lane count: the warmed engine this batch replays

    @property
    def real_lanes(self) -> int:
        return len(self.requests)


def coalesce(requests: List[SolveRequest]) -> List[CoalescedBatch]:
    """Group admitted requests into dispatchable batches.

    Grouping is stable (first-seen key order, FIFO within a group) so the
    schedule is deterministic for a deterministic submit order — the soak
    test replays byte-identical traffic and asserts byte-identical
    responses. Returns batches with their bucket sizes resolved; chunking
    at the largest bucket happens here so the service's tick loop is a
    flat ``for batch: solve``.
    """
    groups: dict = {}
    order = []
    for r in requests:
        entry, binding = r.binding
        key = (r.matrix_id, id(binding))
        if key not in groups:
            groups[key] = (entry, binding, [])
            order.append(key)
        groups[key][2].append(r)

    batches: List[CoalescedBatch] = []
    for key in order:
        entry, binding, reqs = groups[key]
        cap = max(entry.engine.buckets)
        for i in range(0, len(reqs), cap):
            chunk = reqs[i:i + cap]
            batches.append(CoalescedBatch(
                matrix_id=key[0], entry=entry, binding=binding,
                requests=chunk, bucket=entry.engine.bucket_for(len(chunk))))
    return batches
