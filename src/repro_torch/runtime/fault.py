"""Fault tolerance & straggler mitigation (a copy of ``repro/runtime/fault.py``,
which is pure Python; the serve layer's tick-health monitor uses
:class:`StragglerMonitor`).

Three mechanisms, mapped from the paper's master/worker world to SPMD pods
(DESIGN.md §6):

1. **Checkpoint/restart** — `run_with_restarts` wraps a step function; on
   failure it restores the latest checkpoint and continues. Node failures
   on a real pod surface as distributed-runtime errors, which take exactly
   this path after the scheduler re-provisions.
2. **Elastic band re-ownership** (TOP-ILU) — static ownership is
   ``owner(band, epoch) = (band + epoch) % D_alive``: when a worker is
   lost, the factorization restarts from its last completed frontier with
   D-1 devices and ownership re-derives with zero coordination — this is
   the paper's dynamic-load-balancing fallback made deterministic.
3. **Straggler mitigation** — a per-step deadline monitor; steps that
   exceed ``deadline_factor`` x the EWMA step time are reported, and the
   policy hook decides (log / re-dispatch / shrink mesh). On a single
   process this triggers on real CPU contention, which the test exploits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerMonitor:
    deadline_factor: float = 3.0
    ewma_alpha: float = 0.2
    _ewma: Optional[float] = None
    slow_steps: int = 0
    steps: int = 0

    def observe(self, dt: float) -> bool:
        """Returns True if this step was a straggler."""
        slow = self._ewma is not None and dt > self.deadline_factor * self._ewma
        self._ewma = dt if self._ewma is None else (
            self.ewma_alpha * dt + (1 - self.ewma_alpha) * self._ewma
        )
        self.steps += 1
        if slow:
            self.slow_steps += 1
        return slow


def band_owner(band: int, epoch: int, n_alive: int) -> int:
    """Deterministic re-round-robin after failures (mechanism 2)."""
    return (band + epoch) % n_alive


def run_with_restarts(
    make_state: Callable[[], tuple],
    step_fn: Callable,
    save_fn: Callable,
    restore_fn: Callable,
    n_steps: int,
    save_every: int = 10,
    max_restarts: int = 3,
    fail_at: Optional[Callable[[int], bool]] = None,
):
    """Generic checkpointed driver. ``fail_at(step)`` injects faults (tests).

    Returns (state, completed_steps, restarts)."""
    restarts = 0
    state, start = restore_fn()
    if state is None:
        state = make_state()
        start = 0
    step = start
    monitor = StragglerMonitor()
    while step < n_steps:
        try:
            if fail_at is not None and fail_at(step):
                raise RuntimeError(f"injected node failure at step {step}")
            t0 = time.perf_counter()
            state = step_fn(state, step)
            monitor.observe(time.perf_counter() - t0)
            step += 1
            if step % save_every == 0 or step == n_steps:
                save_fn(state, step)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            state, start = restore_fn()
            assert state is not None, "failure before first checkpoint"
            step = start
    return state, step, restarts
