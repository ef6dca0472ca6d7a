"""Rank bodies of the rank-group tests (``tests/test_torch_dist*.py``).

Each function here runs on every rank of a
:func:`repro_torch.launch.dist.run_ranks` group, over the rank's
:class:`~repro_torch.core.dist.DistBandGroup`, and returns what the test
compares in the parent: NumPy arrays, counts and verdicts. This module
imports torch and the port only, never jax, so a spawned rank (which
imports the module that defines its function) loads no JAX and never the
parent's test module. Matrices arrive as ``(n, indptr, indices, data)``.
"""
import torch


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


def solve_cases(group, cases) -> list:
    return [solve_case(group, c) for c in cases]


def fail_on_rank(group, bad_rank: int) -> int:
    """Rank ``bad_rank`` raises at once; the others wait in a collective
    that can never complete."""
    if group.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    group.gather_owners(torch.zeros((1, 4), device=group.device))
    return group.rank
