"""The solve service over band-owner ranks: rank 0 leads, the others follow.

The port's counterpart of the JAX package's ``ServeConfig(mesh=…)``: there
one process drives every device of the mesh; here each band owner is a
rank of a :class:`~repro_torch.core.dist.DistBandGroup` (one process per
owner, :func:`repro_torch.launch.dist.run_ranks`), so every rank must run
the same engine operations, issuing the same collectives in the same
order::

    lanes = open_lanes(group, timeout_s)      # every rank, at the same point
    if group.rank == 0:
        with lead(lanes):
            svc = SolveService(ServeConfig(sharded=True, group=group, ...))
            ...  # register, warmup, submit, tick, update_matrix_values, drain
    else:
        follow(lanes)                         # until the leader stops

(:func:`repro_torch.launch.dist.serve_rank` is this, for one
``run_ranks`` call.)

**The leader.** Rank 0 runs the :class:`~repro_torch.serve.service.SolveService`
and its admission, coalescing and policy: every decision is taken there.
Its engines are :class:`LeaderEngine` handles on a
:class:`~repro_torch.serve.engine.ShardedServeEngine` over the group. Before
each engine operation that issues collectives or makes state the solves
read — building an engine, a factorization, an audit, a bind, a shift
rung, an identity-fallback bind (a bind of values), a warm-up or a solve —
the handle announces the operation and its host inputs to the followers
(``broadcast_object_list`` over a control process group): the matrix's
values, the binding's version (chosen by the leader), and for a solve the
bucket's (nb, n) stack with its tolerances, the padding lanes built on the
leader. An operation nested in another (a rung's factorization) is not
announced: the followers run the outer one.

**Two lanes.** A background refactorization (``PlanCache.update_values``)
runs on a thread of its own beside the ticks. Each lane has its own data
group and its own control group — the refactor lane's data group is the
group's :meth:`~repro_torch.core.dist.DistBandGroup.sibling` — and on every
follower a thread of its own, so a refactor's exchanges never interleave
with a solve's on one communicator. Operations of one lane run one at a
time (a lock held from the announcement to the end of the operation).

**Results.** The Krylov vectors are replicated on every rank, so a
response is rank 0's ``x``. Every rank keeps a digest of each solve's
lanes (x, iterations, verdicts); at stop the leader sends its digests and
every follower compares them with its own.

**Failures.** A rank whose operation raises reports it in the ranks' store
(unless another rank's report is already there: then its collective broke
because that rank failed) and raises; a follower's process then exits, so
every collective waiting on it fails at once. The leader turns a failed
operation into a :class:`RankFailure` naming the rank that failed first,
which fails the batch with a structured error (``SOLVE_FAILED``), and
fails every later operation at once. A follower whose leader failed raises
naming the leader. Every wait is bounded by the lanes' timeout.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import hashlib
import itertools
import threading
import time
import traceback
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.sparse import CSRMatrix

from .engine import ShardedServeEngine

#: lanes opened by this process: every rank opens them in the same order,
#: so the count names the same lanes on every rank (a store key prefix)
_LANES_OPENED = itertools.count()
#: the leader of each group that is being led (``lead``)
_LEADERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class RankFailure(RuntimeError):
    """A rank of a ranked service failed: ``rank`` (the first to report),
    ``op`` (the operation the leader was running) and ``detail`` (that
    rank's report)."""

    def __init__(self, rank: int, op: str, detail: str):
        super().__init__(f"rank {rank} failed during {op!r}: {detail}")
        self.rank, self.op, self.detail = rank, op, detail


class _Lane:
    """One lane of a ranked service: a data group (the exchanges of its
    operations), a control process group (the announcements) and the lock
    that runs its operations one at a time on the leader."""

    def __init__(self, name: str, group, control, src: int):
        self.name, self.group, self.control, self.src = name, group, control, src
        self.lock = threading.Lock()

    def send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=self.src, group=self.control)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.control)
        return box[0]


class Lanes:
    """The process groups of a ranked service, on one rank: the solve lane
    (``group`` itself, and a control group) and the refactor lane (a
    sibling of ``group``, and a control group). Made by :func:`open_lanes`
    on every rank at the same point."""

    def __init__(self, group, timeout_s: float):
        if getattr(group, "kind", None) != "ranks":
            raise ValueError("a ranked service needs a DistBandGroup (one band owner per rank)")
        if group.store is None:
            raise ValueError("a ranked service needs the ranks' store on the group (run_ranks "
                             "passes it; DistBandGroup(..., store=...))")
        timeout = datetime.timedelta(seconds=float(timeout_s))
        peers = group.global_ranks
        self.group = group
        self.rank, self.world = group.rank, group.n_devices
        self.timeout_s = float(timeout_s)
        self.solve = _Lane("solve", group, dist.new_group(peers, timeout=timeout, backend="gloo"),
                           peers[0])
        self.refactor = _Lane("refactor", group.sibling(timeout=timeout),
                              dist.new_group(peers, timeout=timeout, backend="gloo"), peers[0])
        self._prefix = f"serve-ranks/{next(_LANES_OPENED)}/failed/"

    # -- failure reports (out of band, through the ranks' store) ---------------
    def failed_rank(self):
        """(rank, report) of the lowest rank that reported a failure, or None."""
        store = self.group.store
        for r in range(self.world):
            key = f"{self._prefix}{r}"
            if store.check([key]):
                return r, store.get(key).decode()
        return None

    def report(self, op: str, exc: BaseException) -> Optional[tuple]:
        """This rank's operation ``op`` raised ``exc``: returns the report of
        the rank that failed first when one is in the store already (this
        rank is its victim), else files this rank's report and returns
        None."""
        first = self.failed_rank()
        if first is not None:
            return first
        text = f"{type(exc).__name__} in {op!r}: {exc}\n{traceback.format_exc()}"
        self.group.store.set(f"{self._prefix}{self.rank}", text)
        return None


def open_lanes(group, timeout_s: float = 600.0) -> Lanes:
    """The lanes of a ranked service over ``group`` (a DistBandGroup):
    collective, so every rank opens them at the same point. ``timeout_s``
    bounds each collective of the lanes."""
    return Lanes(group, timeout_s)


def leader_of(group):
    """The :class:`Leader` leading ``group`` (a DistBandGroup) in this
    process, or None."""
    return _LEADERS.get(group)


def _digest(lanes) -> str:
    h = hashlib.sha1()
    for lane in lanes:
        h.update(np.asarray(lane.x, np.float32).tobytes())
        h.update(f"{lane.iterations}:{lane.verdict};".encode())
    return h.hexdigest()


def _matrix(a: CSRMatrix) -> tuple:
    return (a.n, np.asarray(a.indptr), np.asarray(a.indices), np.asarray(a.data, np.float32))


class Leader:
    """Rank 0's side of a ranked service (:func:`lead` makes it): it
    announces every engine operation on the lane of the calling thread
    (the refactor lane inside :meth:`LeaderEngine.refactoring`) and keeps
    the digests of the solves."""

    def __init__(self, lanes: Lanes):
        if lanes.rank != 0:
            raise ValueError(f"rank {lanes.rank} cannot lead: rank 0 leads, the others follow")
        self.lanes = lanes
        self.group = lanes.group
        self.failure: Optional[RankFailure] = None
        self.digests: list = []
        self.announced = collections.Counter()
        self._eids = itertools.count()
        self._releases = collections.deque()
        self._local = threading.local()

    @contextlib.contextmanager
    def refactoring(self):
        """Within the block, this thread's operations go to the refactor lane."""
        prev = getattr(self._local, "refactor", False)
        self._local.refactor = True
        try:
            yield
        finally:
            self._local.refactor = prev

    @contextlib.contextmanager
    def op(self, name: str, eid=None, **inputs):
        """Announce operation ``name`` of engine ``eid`` with its host
        ``inputs`` to the followers, then run the block (this rank's own
        part) under the lane's lock. Nested in another operation of this
        thread it announces nothing. A failure inside becomes a
        :class:`RankFailure`, and every later operation fails with it."""
        if getattr(self._local, "depth", 0):
            yield
            return
        if self.failure is not None:
            raise self.failure
        lane = self.lanes.refactor if getattr(self._local, "refactor", False) else self.lanes.solve
        with lane.lock:
            self._local.depth = 1
            try:
                releases = []
                while self._releases:
                    releases.append(self._releases.popleft())
                lane.send((name, eid, inputs, releases))
                self.announced[name] += 1
                yield
            except BaseException as e:
                if self.failure is None:
                    first = self.lanes.report(name, e)
                    self.failure = (RankFailure(first[0], name, first[1]) if first is not None
                                    else RankFailure(0, name, f"{type(e).__name__}: {e}"))
                raise self.failure from e
            finally:
                self._local.depth = 0

    def engine(self, a: CSRMatrix, pattern, knobs: dict) -> "LeaderEngine":
        """A :class:`LeaderEngine` over a new ShardedServeEngine of ``a``'s
        structure on the group, built on every rank (``knobs`` are the
        engine's keywords; ``group`` is the led group)."""
        knobs = {k: v for k, v in knobs.items() if k not in ("group", "refactor_group")}
        eid = next(self._eids)
        with self.op("engine", eid, matrix=_matrix(a), k=pattern.k, knobs=knobs):
            engine = ShardedServeEngine(a, pattern, None, group=self.group,
                                        refactor_group=self.lanes.refactor.group, **knobs)
        handle = LeaderEngine(self, eid, engine)
        weakref.finalize(handle, self._releases.append, ("engine", eid, None))
        return handle

    def _track(self, eid, binding):
        if binding is not None:
            weakref.finalize(binding, self._releases.append, ("binding", eid, binding.version))
        return binding

    def stop(self) -> None:
        """End the followers' lanes (the refactor lane after its operation in
        flight), hand them the solve digests and collect every rank's
        verdict on them; raises when a follower's digests differ."""
        if self.failure is not None:
            raise self.failure
        for lane in (self.lanes.refactor, self.lanes.solve):
            with lane.lock:
                lane.send(("stop", None, dict(digests=list(self.digests)), []))
        verdicts = [None] * self.lanes.world
        dist.all_gather_object(verdicts, (0, "ok"), group=self.lanes.solve.control)
        bad = [(r, v) for r, v in verdicts if v != "ok"]
        if bad:
            self.failure = RankFailure(bad[0][0], "stop", bad[0][1])
            raise self.failure


class LeaderEngine:
    """Rank 0's handle on a :class:`~repro_torch.serve.engine.ShardedServeEngine`
    of a ranked service: the serve surface the cache and the service call
    (``factor``, ``audit``, ``bind``, ``bind_degraded``, ``warm``,
    ``solve``), each announced to the followers before it runs here; every
    other attribute is the engine's."""

    def __init__(self, leader: Leader, eid: int, engine: ShardedServeEngine):
        self._leader, self.eid, self.engine = leader, eid, engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    @contextlib.contextmanager
    def refactoring(self):
        """The refactor lane for this thread: the followers' refactor
        thread, the engine's refactor group."""
        with self._leader.refactoring(), self.engine.refactoring():
            yield

    def factor(self, a: CSRMatrix):
        with self._leader.op("factor", self.eid, data=np.asarray(a.data, np.float32)):
            return self.engine.factor(a)

    def audit(self, factored, pivot_tol=None):
        if isinstance(factored, np.ndarray) or (pivot_tol is None
                                                and factored.health is not None):
            return self.engine.audit(factored, pivot_tol)  # on the host, or already done
        with self._leader.op("audit", self.eid, pivot_tol=pivot_tol):
            return self.engine.audit(factored, pivot_tol)

    def bind(self, a: CSRMatrix, factored, version: Optional[int] = None):
        version = self.engine._next_version() if version is None else version
        vals = np.asarray(factored, np.float32) if isinstance(factored, np.ndarray) else None
        with self._leader.op("bind", self.eid, data=np.asarray(a.data, np.float32),
                             version=version, vals=vals):
            return self._leader._track(self.eid, self.engine.bind(a, factored, version=version))

    def bind_degraded(self, a: CSRMatrix, shift: float, factorize=None,
                      version: Optional[int] = None):
        # ``factorize`` (the cache's) is this engine's own factor, which the
        # followers run too: the rung factors through the engine itself
        version = self.engine._next_version() if version is None else version
        with self._leader.op("rung", self.eid, data=np.asarray(a.data, np.float32),
                             shift=float(shift), version=version):
            return self._leader._track(self.eid,
                                       self.engine.bind_degraded(a, shift, version=version))

    def warm(self, binding, buckets=None) -> dict:
        with self._leader.op("warm", self.eid, version=binding.version,
                             buckets=None if buckets is None else tuple(buckets)):
            return self.engine.warm(binding, buckets)

    def solve(self, binding, bs, tols):
        nb = np.shape(bs)[0]
        bs, tols = self.engine.pad(bs, tols)
        with self._leader.op("solve", self.eid, version=binding.version, bs=bs, tols=tols):
            lanes = self.engine.solve_bucket(binding, bs, tols)
        self._leader.digests.append(_digest(lanes))
        return lanes[:nb]


@contextlib.contextmanager
def lead(lanes: Lanes):
    """Lead ``lanes`` (on rank 0): within the block, a ``SolveService`` over
    ``ServeConfig(sharded=True, group=lanes.group)`` builds
    :class:`LeaderEngine` handles, so every rank runs its engine
    operations. On a clean exit the followers stop (:meth:`Leader.stop`);
    when the block raises, or an operation failed, the followers learn it
    (an announcement, or the store when a collective broke)."""
    leader = Leader(lanes)
    _LEADERS[lanes.group] = leader
    try:
        yield leader
        leader.stop()
    except BaseException as e:
        if leader.failure is None:  # the followers wait for an announcement
            leader.failure = RankFailure(0, "lead", f"{type(e).__name__}: {e}")
            lanes.report("lead", e)
            for lane in (lanes.refactor, lanes.solve):
                with contextlib.suppress(Exception), lane.lock:
                    lane.send(("abort", None, dict(detail=str(leader.failure)), []))
        raise
    finally:
        _LEADERS.pop(lanes.group, None)


class _Follower:
    """A follower's mirror of the leader's engines: engines by id, bindings
    by (engine id, version), each lane's factorization in flight, and the
    solve digests."""

    def __init__(self, lanes: Lanes):
        self.lanes = lanes
        self.engines: dict = {}
        self.bindings: dict = {}
        self.released: set = set()
        self.facts: dict = {}
        self.digests: list = []
        self.ops = collections.Counter()
        self.cond = threading.Condition()
        self.failure: Optional[BaseException] = None
        self.verdict = None

    def _wait(self, table: dict, key, what: str):
        """``table[key]``, waiting for the other lane to make it (bounded)."""
        with self.cond:
            if not self.cond.wait_for(lambda: key in table or self.failure is not None,
                                      timeout=self.lanes.timeout_s):
                raise TimeoutError(f"rank {self.lanes.rank}: {what} {key} never arrived")
            if key not in table:
                raise RuntimeError(f"rank {self.lanes.rank}: {what} {key} lost to a failure")
            return table[key]

    def _keep_binding(self, eid, binding) -> None:
        if binding is None:
            return
        with self.cond:
            key = (eid, binding.version)
            if key not in self.released:
                self.bindings[key] = binding
            self.cond.notify_all()

    def _release(self, releases) -> None:
        with self.cond:
            for kind, eid, version in releases:
                if kind == "engine":
                    self.engines.pop(eid, None)
                    for key in [k for k in self.bindings if k[0] == eid]:
                        del self.bindings[key]
                else:
                    self.released.add((eid, version))
                    self.bindings.pop((eid, version), None)

    def _apply(self, lane: _Lane, name: str, eid, inp: dict) -> None:
        from .cache import bind_stream

        if name == "engine":
            from repro_torch.core.api import _symbolic

            a = CSRMatrix.from_arrays(*inp["matrix"])
            engine = ShardedServeEngine(a, _symbolic(a, inp["k"], "sum"), None,
                                        group=self.lanes.solve.group,
                                        refactor_group=self.lanes.refactor.group, **inp["knobs"])
            with self.cond:
                self.engines[eid] = engine
                self.cond.notify_all()
            return
        engine = self._wait(self.engines, eid, "engine")
        refactor = engine.refactoring() if lane.name == "refactor" else contextlib.nullcontext()
        with refactor:
            if name in ("factor", "audit", "bind", "rung"):
                a = None
                if "data" in inp:
                    h = engine.host
                    a = CSRMatrix(n=h.n, indptr=h.indptr, indices=h.indices, data=inp["data"])
                with bind_stream(engine.device):
                    if name == "factor":
                        self.facts[lane.name] = engine.factor(a)
                    elif name == "audit":
                        engine.audit(self.facts[lane.name], inp["pivot_tol"])
                    elif name == "bind":
                        factored = (inp["vals"] if inp["vals"] is not None
                                    else self.facts.pop(lane.name))
                        self._keep_binding(eid, engine.bind(a, factored, version=inp["version"]))
                    else:
                        self._keep_binding(eid, engine.bind_degraded(a, inp["shift"],
                                                                     version=inp["version"]))
                return
            binding = self._wait(self.bindings, (eid, inp["version"]), "binding")
            if name == "warm":
                engine.warm(binding, inp["buckets"])
            elif name == "solve":
                self.digests.append(_digest(engine.solve_bucket(binding, inp["bs"], inp["tols"])))
            else:
                raise ValueError(f"rank {self.lanes.rank}: unknown operation {name!r}")

    def _stop(self, inp: dict) -> None:
        """The leader's digests against this rank's; the verdict goes back
        to the leader (an all-gather on the solve lane's control group)."""
        theirs = inp["digests"]
        if theirs == self.digests:
            self.verdict = "ok"
        else:
            diff = next((i for i, (p, q) in enumerate(zip(theirs, self.digests)) if p != q),
                        min(len(theirs), len(self.digests)))
            self.verdict = (f"solve digests differ from rank 0's from batch {diff} on "
                            f"({len(self.digests)} here, {len(theirs)} there)")
        dist.all_gather_object([None] * self.lanes.world, (self.lanes.rank, self.verdict),
                               group=self.lanes.solve.control)

    def run_lane(self, lane: _Lane, card: Optional[int]) -> None:
        """Receive and run the leader's operations of ``lane`` until stop,
        on ``card`` (the rank's current CUDA device; None on the CPU)."""
        if card is not None:
            torch.cuda.set_device(card)
        name = "recv"
        try:
            while True:
                name, eid, inp, releases = lane.recv()
                self._release(releases)
                if name == "stop":
                    if lane.name == "solve":
                        self._stop(inp)
                    return
                if name == "abort":
                    raise RuntimeError(f"the leader (rank 0) failed: {inp['detail']}")
                self._apply(lane, name, eid, inp)
                self.ops[name] += 1
        except BaseException as e:
            first = self.lanes.report(f"{lane.name}:{name}", e)
            with self.cond:
                if self.failure is None:
                    self.failure = (e if first is None else RuntimeError(
                        f"rank {self.lanes.rank}: {lane.name} lane broke during {name!r} "
                        f"because rank {first[0]} failed: {first[1]}"))
                self.cond.notify_all()


def follow(lanes: Lanes) -> dict:
    """Run the leader's operations on this rank (≠ 0) until it stops: one
    thread per lane. Raises as soon as a lane fails (the process then
    ends, which breaks the collectives that wait on it), or when this
    rank's digests differ from the leader's. Returns this rank's digests,
    the operations it ran and its group's counts."""
    if lanes.rank == 0:
        raise ValueError("rank 0 leads (lead); the other ranks follow")
    f = _Follower(lanes)
    card = torch.cuda.current_device() if lanes.group.device.type == "cuda" else None
    threads = [threading.Thread(target=f.run_lane, args=(lane, card), daemon=True,
                                name=f"follow-{lane.name}")
               for lane in (lanes.solve, lanes.refactor)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + lanes.timeout_s
    while any(t.is_alive() for t in threads):
        with f.cond:
            if f.failure is not None:
                raise f.failure
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {lanes.rank}: the leader did not stop the service within "
                               f"{lanes.timeout_s} s")
        for t in threads:
            t.join(timeout=0.05)
    if f.failure is not None:
        raise f.failure
    if f.verdict != "ok":
        raise RuntimeError(f"rank {lanes.rank}: {f.verdict}")
    return dict(rank=lanes.rank, digests=list(f.digests), ops=dict(f.ops),
                counts=lanes.group.counts())
