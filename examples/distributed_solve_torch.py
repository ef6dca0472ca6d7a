"""TOP-ILU's band owners as processes: a distributed solve over D ranks of
``torch.distributed``, bitwise equal to the same solve over D owners on one
device.

    PYTHONPATH=src python examples/distributed_solve_torch.py --device cpu
    PYTHONPATH=src python examples/distributed_solve_torch.py            # on a GPU

Each of the D ranks (``repro_torch.launch.dist.run_ranks``: spawned
processes joined through a file store) holds one band owner's slice of the
factors, of A and of the sweep tables; the Krylov vectors are replicated.
With ``--device cpu`` the ranks are gloo ranks on the CPU (a few seconds at
the default size); without it they share the one card through gloo, each
exchange staged through pinned host memory. The script factors and solves
``poisson_2d(--nx)`` over the ranks and over a one-device ``BandGroup`` of
the same D, and prints "bitwise equal" when every rank's ``x``, steps,
verdict and exchange counts are the one-device solve's.
"""
import argparse
import time

import numpy as np


def rank_solve(group, nx, band_rows, ordering, broadcast):
    """One rank's share: the whole solve over ``group``; returns ``x``, the
    steps, the verdict, the counts and the collective wall."""
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded

    a = poisson_2d(nx)
    b = np.random.default_rng(1).standard_normal(a.n).astype(np.float32)
    t0 = time.perf_counter()
    res, fact = solve_sharded(a, b, k=1, group=group, band_rows=band_rows, ordering=ordering,
                              broadcast=broadcast)
    wall = time.perf_counter() - t0
    return dict(x=res.x, steps=res.iterations, verdict=res.verdict, counts=group.counts(),
                wall=wall, local_block=tuple(fact.loc_vals.shape),
                # the group over processes keeps these; the one-device group has no collective
                collective_s=getattr(group, "exchange_seconds", 0.0),
                staged=getattr(group, "staged_bytes", 0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--nx", type=int, default=12)
    ap.add_argument("--band-rows", type=int, default=8)
    ap.add_argument("--ordering", default="fusion", choices=["natural", "rcm", "fusion"])
    ap.add_argument("--broadcast", default="gather", choices=["gather", "ring"])
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = ap.parse_args()

    from repro_torch.core.top_ilu import BandGroup
    from repro_torch.launch.dist import run_ranks

    D = args.ranks
    t0 = time.perf_counter()
    out = run_ranks(rank_solve, D, "gloo", None if args.device is None else [args.device] * D,
                    timeout_s=600, args=(args.nx, args.band_rows, args.ordering, args.broadcast))
    wall = time.perf_counter() - t0
    one = rank_solve(BandGroup(D, args.device), args.nx, args.band_rows, args.ordering,
                     args.broadcast)
    print(f"poisson_2d({args.nx}) ILU(1), {D} gloo ranks of {args.band_rows}-row bands, "
          f"{args.ordering} ordering, {args.broadcast}: {one['steps']} steps, {one['verdict']}; "
          f"{wall:.1f} s with the spawn")
    same = True
    for r, o in enumerate(out):
        eq = (np.array_equal(o["x"].view(np.int32), one["x"].view(np.int32))
              and (o["steps"], o["verdict"], o["counts"]) == (one["steps"], one["verdict"],
                                                              one["counts"]))
        same &= eq
        print(f"rank {r}: block {o['local_block']}, solve {o['wall']:.2f} s of which collectives "
              f"{o['collective_s']:.2f} s ({o['counts']['collectives']}), staged {o['staged']} B; "
              + ("bitwise equal to the one-device group" if eq else "DIFFERS"))
    print("x on every rank bitwise equal to the one-device BandGroup: "
          + ("bitwise equal" if same else "NOT EQUAL"))
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
