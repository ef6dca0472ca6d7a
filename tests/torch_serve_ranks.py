"""Rank bodies of ``tests/test_torch_serve_ranks.py``: a solve service over
the ranks of a :class:`~repro_torch.core.dist.DistBandGroup`
(:func:`repro_torch.launch.dist.serve_rank`), rank 0 leading, the others
following. This module imports torch and the port only, never jax, so a
spawned rank loads no JAX and never the parent's test module.
"""
import torch


def serve_cases(group, cases) -> list:
    """One ranked service per case, in order, on every rank: each case is
    ``serve_rank``'s (config, matrices, steps, timeout_s). CPU ranks run one
    intra-op thread each, so the ranks do not crowd the host's cores."""
    from repro_torch.launch.dist import serve_rank

    torch.set_num_threads(1)
    return [serve_rank(group, *case) for case in cases]


def serve_with_failing_follower(group, bad_rank: int, bad_solve: int, case) -> dict:
    """``serve_rank`` of ``case`` where rank ``bad_rank`` raises inside its
    ``bad_solve``-th bucketed solve (counted from 1), after the solve's
    first collectives have started on the other ranks."""
    from repro_torch.launch.dist import serve_rank
    from repro_torch.serve.engine import ShardedServeEngine

    torch.set_num_threads(1)
    if group.rank == bad_rank:
        solve_bucket = ShardedServeEngine.solve_bucket
        calls = [0]

        def failing(self, binding, bs, tols):
            calls[0] += 1
            if calls[0] == bad_solve:
                self.matvec(torch.zeros((bs.shape[0], self.n), device=self.device))
                raise ValueError(f"rank {group.rank} fails inside solve {bad_solve} on purpose")
            return solve_bucket(self, binding, bs, tols)

        ShardedServeEngine.solve_bucket = failing
    return serve_rank(group, *case)
