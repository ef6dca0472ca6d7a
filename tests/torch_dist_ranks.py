"""Rank bodies of the rank-group tests (``tests/test_torch_dist*.py``).

Each function here runs on every rank of a
:func:`repro_torch.launch.dist.run_ranks` group, over the rank's
:class:`~repro_torch.core.dist.DistBandGroup`, and returns what the test
compares in the parent: NumPy arrays, counts and verdicts. This module
imports torch and the port only, never jax, so a spawned rank (which
imports the module that defines its function) loads no JAX and never the
parent's test module. Matrices arrive as ``(n, indptr, indices, data)``.
"""
import contextlib
import traceback

import torch

#: the Tensor methods that read a tensor back to the host
HOST_READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__")


def _csr(m):
    from repro_torch.core.sparse import CSRMatrix

    return CSRMatrix.from_arrays(*m)


def factor_case(group, case: dict) -> dict:
    """``ilu_sharded`` over ``group`` of one case (``matrix``, ``k``,
    ``ordering``, ``broadcast``, ``band_rows``), then, with ``applies``,
    the sweep and inverse applies on the case's right-hand sides (nb = 1
    and 3), and with ``adopt`` (CSR-aligned factor values of the case's
    system) the sweep apply of those values adopted through
    ``ShardedILUFactorization.from_values``. The same function runs the
    one-device group in the parent."""
    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.top_ilu import ShardedILUFactorization

    a = _csr(case["matrix"])
    group.reset_counts()
    f = ilu_sharded(a, case["k"], band_rows=case["band_rows"], broadcast=case["broadcast"],
                    ordering=case["ordering"], group=group)
    out = dict(counts=group.counts(), vals=f.values_csr(), shape=tuple(f.loc_vals.shape),
               state_bytes=f.loc_vals.untyped_storage().nbytes(),
               per_device=f.per_device_value_bytes(), replicated=f.plan.replicated_value_bytes(),
               halo_bytes=f.plan.halo_bytes_per_superstep(),
               replicated_halo=f.plan.replicated_bytes_per_superstep(),
               supersteps=f.plan.n_supersteps, applies={})
    for b in case.get("applies", ()):
        bt = torch.as_tensor(b, device=f.device)
        for method in ("sweep", "inverse"):
            apply = f.precond(method=method)
            group.reset_counts()
            out["applies"][method, b.ndim] = (apply(bt).cpu().numpy(), group.counts())
    if case.get("adopt") is not None:
        g = ShardedILUFactorization.from_values(f.a, f.pattern, case["adopt"],
                                                band_rows=case["band_rows"], group=group,
                                                broadcast=case["broadcast"])
        b = case["applies"][0]
        out["adopted_shape"] = tuple(g.loc_vals.shape)
        out["adopted"] = g.precond()(torch.as_tensor(b, device=g.device)).cpu().numpy()
    return out


def factor_cases(group, cases) -> list:
    return [factor_case(group, c) for c in cases]


def solve_case(group, case: dict) -> dict:
    """``solve_sharded`` over ``group`` of one case (``matrix``, ``b``, and
    ``solve_sharded``'s keywords in ``kw``); with ``on_breakdown`` in
    ``kw`` also the ladder's outcome. Returns every lane's ``x``,
    iterations and verdict, the group's counts and the factor's health."""
    from repro_torch.core.solvers import solve_sharded

    a = _csr(case["matrix"])
    group.reset_counts()
    res, fact = solve_sharded(a, case["b"], group=group, **case["kw"])
    lanes = res if isinstance(res, list) else [res]
    h = fact.health
    return dict(x=[r.x for r in lanes], iterations=[r.iterations for r in lanes],
                verdict=[r.verdict for r in lanes], shift=[r.report.shift for r in lanes],
                counts=group.counts(), health=(h.ok, h.shift, h.attempts, h.worst_row,
                                               h.worst_ratio, h.n_small_pivots),
                vals=fact.values_csr())


@contextlib.contextmanager
def no_host_reads():
    """Within the block, every Tensor method of ``HOST_READS`` raises
    ``HostRead`` (what a CUDA graph capture forbids: reading a device tensor
    back to the host)."""
    saved = {name: torch.Tensor.__dict__.get(name) for name in HOST_READS}

    def refuse(name):
        def method(self, *args, **kwargs):
            raise HostRead(f"Tensor.{name}")
        return method

    for name in HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)


class HostRead(AssertionError):
    pass


def restart_case(group, case: dict) -> dict:
    """One GMRES restart body (``WarmRestart._step``, what a CUDA graph
    captures) over the ranked row-block matvec and preconditioner of one
    case (``matrix``, ``b`` (nb, n), and in ``kw``: ``k``, ``band_rows``,
    ``ordering``, ``broadcast``, ``precond_method``, ``restart``, ``tol``),
    run under :func:`no_host_reads`. Returns ``x`` and the true residual
    norms after it, the group's counts of the restart, the host read that
    raised (``"Tensor.<name> at file:line"``, or None), and whether the
    sweep tables' host copies equal their tensors."""
    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.bitmath import bitnorm
    from repro_torch.core.solvers import WarmRestart, make_sharded_ell_matvec

    kw = case["kw"]
    a = _csr(case["matrix"])
    f = ilu_sharded(a, kw["k"], band_rows=kw["band_rows"], broadcast=kw["broadcast"],
                    ordering=kw["ordering"], group=group)
    M = f.precond(broadcast=kw["broadcast"], method=kw["precond_method"])
    matvec = make_sharded_ell_matvec(f.a, group)
    b = torch.as_tensor(case["b"], device=group.device)
    eng = WarmRestart(matvec, M, b.shape[0], a.n, kw["restart"], 20, group.device)
    bnorm = bitnorm(b)
    # the state of a solve's first restart: x = 0, r = b, ‖r‖ = ‖b‖, running
    for dst, src in zip((eng.bs, eng.bnorm, eng.tolb, eng.state[1], eng.state[3]),
                        (b, bnorm, kw["tol"] * bnorm, b, bnorm)):
        dst.copy_(src)
    tables_ok = True
    if kw["precond_method"] == "sweep":
        for side in (M.sweep.tables.l, M.sweep.tables.u):
            tables_ok &= (getattr(side, "ex_after_host", None) == tuple(side.ex_after.tolist())
                          and getattr(side, "ex_off_host", None) == tuple(side.ex_off.tolist()))
    group.reset_counts()
    host_read = None
    try:
        with no_host_reads():
            eng._step()
    except HostRead as e:
        frame = next((fr for fr in reversed(traceback.extract_tb(e.__traceback__))
                      if "repro_torch" in fr.filename), None)
        where = "" if frame is None else f" at {frame.filename.split('src/')[-1]}:{frame.lineno}"
        host_read = f"{e}{where}"
    return dict(x=eng.state[0].numpy(), rtrue=eng.rtrue.numpy(), counts=group.counts(),
                host_read=host_read, tables_ok=tables_ok)


def run_case(group, case: dict) -> dict:
    """:func:`restart_case` for a case of ``kind`` "restart", else
    :func:`solve_case`."""
    return (restart_case if case.get("kind") == "restart" else solve_case)(group, case)


def solve_cases(group, cases) -> list:
    return [run_case(group, c) for c in cases]


def fail_on_rank(group, bad_rank: int) -> int:
    """Rank ``bad_rank`` raises at once; the others wait in a collective
    that can never complete."""
    if group.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    group.gather_owners(torch.zeros((1, 4), device=group.device))
    return group.rank
