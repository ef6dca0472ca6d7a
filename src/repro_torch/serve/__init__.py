"""Solve service over the port's warm bucketed ILU(k) solver stack.

The port's counterpart of ``repro.serve``, with the same names.
Multi-tenant request coalescing with a bit-compat guarantee: a request
batched into any coalesced solve returns bits identical to solving it
alone (``solve_with_ilu`` / ``solve_sharded`` on the same values). On a
CUDA device each bucket's GMRES restart is one captured CUDA graph, and a
value update refills the engine's value slots in place, so nothing is
built or captured after warm-up.
"""
from .admission import (
    BREAKDOWN,
    DEADLINE_EXCEEDED,
    AdmissionError,
    AdmissionQueue,
    SolveRequest,
    SolveResponse,
    validate_deadline,
    validate_request,
)
from .cache import CacheEntry, PlanCache, identity_values
from .coalescer import CoalescedBatch, coalesce
from .dispatcher import Dispatcher
from .engine import EngineBinding, LaneResult, ServeEngine, ShardedServeEngine
from .metrics import CompileWatch, LatencyHistogram, ServiceMetrics, compile_count
from .service import ServeConfig, SolveService
from .traffic import TrafficRecord, TrafficResult, run_traffic

__all__ = [
    "AdmissionError",
    "AdmissionQueue",
    "BREAKDOWN",
    "CacheEntry",
    "CoalescedBatch",
    "CompileWatch",
    "DEADLINE_EXCEEDED",
    "Dispatcher",
    "EngineBinding",
    "LaneResult",
    "LatencyHistogram",
    "PlanCache",
    "ServeConfig",
    "ServeEngine",
    "ServiceMetrics",
    "ShardedServeEngine",
    "SolveRequest",
    "SolveResponse",
    "SolveService",
    "TrafficRecord",
    "TrafficResult",
    "coalesce",
    "compile_count",
    "identity_values",
    "run_traffic",
    "validate_deadline",
    "validate_request",
]
