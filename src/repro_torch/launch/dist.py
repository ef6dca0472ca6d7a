"""Run a function on D spawned ranks, one band owner each.

    results = run_ranks(fn, world=4, backend="gloo", devices=["cpu"] * 4,
                        init_file="/tmp/x/store", timeout_s=300, args=(a_arg,))

Every rank is a process started with the ``spawn`` method. It joins the
process group through a file store (``dist.FileStore``: a new file per run,
so parallel runs never compete for a TCP port), makes a
:class:`~repro_torch.core.dist.DistBandGroup` on its device (the store
attached, for out-of-band reports) and returns
``fn(group, *args)``, which must be picklable, as must ``fn`` (a module
level function, imported anew by each rank). ``run_ranks`` returns the
results in rank order and raises when a rank raises, dies or outlives
``timeout_s``: it never hangs, and it stops every process it started. When
ranks fail, the one ``RuntimeError`` carries every failed rank's traceback
in rank order, so the rank whose own code raised is always in it, beside
the ranks whose collectives broke when it died.

When the ranks use CUDA the kernels are built once in the calling process
first, so the ranks find the library instead of racing D ``nvcc`` builds.

The rank bodies of the port's own drivers live here too:
:func:`solve_rank` (``python -m repro_torch.launch.solve --ranks N``) and
:func:`serve_rank` (a solve service over the ranks: rank 0 serves, the
others follow).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch

#: after the first failure, how long run_ranks waits for the other ranks'
#: reports before it stops them
FAILURE_GRACE_S = 5.0


def rank_devices(world: int, backend: str, devices=None) -> list:
    """One torch device per rank. ``None``: NCCL ranks take ``cuda:r``
    (one card each), gloo ranks all take ``cuda`` (several ranks on one
    card, staged through the host). NCCL refuses two ranks on one card and
    CPU tensors: such a list raises."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if devices is None:
        devices = [f"cuda:{r}" for r in range(world)] if backend == "nccl" else ["cuda"] * world
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("NCCL ranks need CUDA devices; use gloo for the CPU")
        cards = [torch.device("cuda", d.index or 0) for d in devices]
        if len(set(cards)) != len(cards):
            raise ValueError("NCCL refuses two ranks on one card: give each rank its own "
                             "cuda:<i>, or use gloo")
    return devices


def _rank_main(rank, world, backend, device, init_file, timeout_s, fn, args, results):
    import torch.distributed as dist

    from repro_torch.core.dist import DistBandGroup

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        store = dist.FileStore(init_file, world)
        dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(DistBandGroup(device=dev, backend=backend, store=store), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def _next_report(procs, results, got, failed, wait_s):
    """The next ``(rank, ok, out)`` from the ranks' queue, or None after
    ``wait_s``. A rank that exited without a report (after a further 2 s
    for one in flight) is entered in ``failed`` with its exit code."""
    try:
        return results.get(timeout=wait_s)
    except queue.Empty:
        pass
    dead = [r for r, p in enumerate(procs)
            if r not in got and r not in failed and p.exitcode is not None]
    if not dead:
        return None
    try:  # a rank that failed reports before it exits
        return results.get(timeout=2.0)
    except queue.Empty:
        for r in dead:
            failed[r] = f"exited with code {procs[r].exitcode} and no result"
    return None


def run_ranks(fn, world: int, backend: str = "gloo", devices=None, init_file=None,
              timeout_s: float = 600.0, args=()) -> list:
    """``[fn(group_r, *args) for each rank r]``, each in its own process
    (see the module docstring). ``init_file`` is the file store's path (a
    new file in a temporary directory when None; an existing file raises);
    ``timeout_s`` bounds the whole run and each rank's collectives."""
    devices = rank_devices(world, backend, devices)
    if any(d.type == "cuda" for d in devices):
        from repro_torch.kernels import build

        build.build()
    own_dir = None
    if init_file is None:
        own_dir = tempfile.mkdtemp(prefix="repro_ranks_")
        init_file = os.path.join(own_dir, "store")
    elif os.path.exists(init_file):
        raise ValueError(f"run_ranks: the file store {init_file} exists; give each run a new one")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, str(devices[r]), str(init_file), timeout_s, fn,
                               tuple(args), results))
             for r in range(world)]
    got, failed, started = {}, {}, []
    try:
        for p in procs:
            p.start()
            started.append(p)
        deadline = time.monotonic() + timeout_s
        while len(got) < world and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world - len(got)} of {world} ranks not done "
                                   f"after {timeout_s} s")
            report = _next_report(procs, results, got, failed, min(left, 0.5))
            if report is not None:
                rank, ok, out = report
                (got if ok else failed)[rank] = out
        if failed:
            # the first failure read is often a victim: a rank whose
            # collective broke when the failing rank died. Read on until
            # every rank has reported or exited, for a few seconds at most.
            grace = time.monotonic() + FAILURE_GRACE_S
            while len(got) + len(failed) < world and time.monotonic() < grace:
                report = _next_report(procs, results, got, failed, 0.2)
                if report is not None:
                    rank, ok, out = report
                    (got if ok else failed)[rank] = out
            raise RuntimeError(f"run_ranks: rank {', '.join(map(str, sorted(failed)))} of "
                               f"{world} failed:\n" + "\n".join(f"--- rank {r} ---\n{failed[r]}"
                                                               for r in sorted(failed)))
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        results.join_thread()
        if own_dir is not None:
            shutil.rmtree(own_dir, ignore_errors=True)
    return [got[r] for r in range(world)]


def solve_rank(group, n, density, k, method, broadcast, band_rows, ordering, seed):
    """The rank body of ``python -m repro_torch.launch.solve --ranks N``:
    the CLI's ``matgen`` system, rebuilt on the rank from the seed, solved
    by ``solve_sharded`` over ``group``. Returns what the CLI prints, and
    the group's counts."""
    import numpy as np

    from repro_torch.core.matgen import matgen
    from repro_torch.core.solvers import solve_sharded

    a = matgen(n, density=density, seed=seed)
    b = np.random.default_rng(seed + 1).standard_normal(n).astype(np.float32)
    t0 = time.perf_counter()
    res, fact = solve_sharded(a, b, k=k, group=group, band_rows=band_rows, broadcast=broadcast,
                              method=method, ordering=ordering)
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    return dict(rank=group.rank, x=res.x, iterations=res.iterations, residual=res.residual,
                converged=res.converged, verdict=res.verdict, seconds=time.perf_counter() - t0,
                nnz=a.nnz, fill=fact.nnz, symbolic=fact.symbolic_seconds,
                numeric=fact.numeric_seconds, supersteps=fact.plan.n_supersteps,
                counts=group.counts(), exchange_seconds=group.exchange_seconds,
                staged_bytes=group.staged_bytes)


def _response_record(r) -> dict:
    """A SolveResponse as plain values (what a rank returns through its queue)."""
    return dict(request_id=r.request_id, tenant=r.tenant, matrix_id=r.matrix_id, ok=r.ok,
                x=r.x, iterations=r.iterations, residual=r.residual, verdict=r.verdict,
                version=r.matrix_version, lanes=r.batch_lanes, latency=r.latency_seconds,
                error_reason=r.error_reason, error=r.error)


def serve_rank(group, config: dict, matrices: dict, steps=(), timeout_s: float = 600.0) -> dict:
    """A solve service over the ranks of ``group``, one band owner each
    (``repro_torch.serve.ranks``): rank 0 serves ``SolveService(ServeConfig(
    sharded=True, group=group, **config))``, every other rank follows it.

    Rank 0 registers ``matrices`` ({id: (n, indptr, indices, data)}), warms
    up, and runs ``steps`` in order: ``("traffic", kw)`` drives
    ``run_traffic(svc, ids, **kw)``, ``("update", id, values)`` pushes new
    values in the background, ``("wait",)`` joins the refactorizations in
    flight; then it drains, stops the followers and
    returns the responses, the traffic records, each matrix's version at
    registration and at the end, the metrics snapshot (taken before the
    stop), the seconds of registration, warm-up and traffic, the solve
    digests, the operations it announced, the group's counts, those of the
    traffic alone with its staged bytes and exchange seconds (the solve
    lane's; the refactor lane exchanges over a group of its own) and the
    process's ``engine_events()``. A follower returns its digests, the operations it
    ran and its group's counts. When an operation failed on some rank, rank 0 raises a
    :class:`~repro_torch.serve.ranks.RankFailure` naming it, with the
    structured errors of the requests that failed. ``timeout_s`` bounds
    each collective of the service."""
    from repro_torch.core.solvers import engine_events
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.serve import ServeConfig, SolveService, ranks, run_traffic

    lanes = ranks.open_lanes(group, timeout_s)
    if group.rank != 0:
        return ranks.follow(lanes)
    out = dict(rank=0, responses=[], records=[], seconds={})
    with ranks.lead(lanes) as leader:
        svc = SolveService(ServeConfig(sharded=True, group=group, **config))
        t0 = time.perf_counter()
        for mid, m in matrices.items():
            svc.register_matrix(mid, CSRMatrix.from_arrays(*m))
        out["versions"] = {mid: [svc.cache.entry(mid).version] for mid in matrices}
        t1 = time.perf_counter()
        svc.warmup()
        at_warm = (group.counts(), group.staged_bytes, group.exchange_seconds)
        t2 = time.perf_counter()
        for step in steps:
            if step[0] == "traffic":
                res = run_traffic(svc, list(matrices), **step[1])
                out["responses"] += [_response_record(r) for r in res.responses]
                out["records"] += [dict(request_id=r.request_id, matrix_id=r.matrix_id, b=r.b,
                                        tol=r.tol, version=r.expected_version)
                                   for r in res.records]
            elif step[0] == "update":
                svc.update_matrix_values(step[1], step[2], background=True)
            elif step[0] == "wait":
                svc.cache.wait_refactors()
            else:
                raise ValueError(f"serve_rank: unknown step {step[0]!r}")
        svc.drain()
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        t3 = time.perf_counter()
        for mid in matrices:
            out["versions"][mid].append(svc.cache.entry(mid).version)
        out["metrics"] = svc.metrics_snapshot()
        out["seconds"] = dict(register=t1 - t0, warmup=t2 - t1, traffic=t3 - t2)
        if leader.failure is not None:
            failed = [(r["request_id"], r["error_reason"], r["error"])
                      for r in out["responses"] if not r["ok"]]
            raise ranks.RankFailure(leader.failure.rank, leader.failure.op,
                                    f"{leader.failure.detail}\n{len(failed)} request(s) "
                                    f"failed; the first: {failed[:1]}")
    counts = group.counts()
    out.update(digests=list(leader.digests), announced=dict(leader.announced), counts=counts,
               events=engine_events(),
               traffic=dict(counts={k: counts[k] - at_warm[0][k] for k in counts},
                            staged_bytes=group.staged_bytes - at_warm[1],
                            exchange_seconds=group.exchange_seconds - at_warm[2]))
    return out
