"""ILU(k)-preconditioned solver CLI of the port (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.solve --n 2000 --k 1 \
        [--method gmres|bicgstab|cg] [--backend torch|oracle|topilu] [--devices D] \
        [--broadcast gather|ring] [--band-rows R] [--ordering natural|rcm|fusion] \
        [--device cuda|cpu] [--ranks N [--dist-backend gloo|nccl]]

The twin of ``repro.launch.solve``: a random diagonally dominant ``matgen``
matrix, a right-hand side from the seed, and the Krylov method — through
``solve_with_ilu`` (``--backend torch|oracle``), or through the distributed
``solve_sharded`` over D band owners of R-row bands (``--backend topilu``).
``--ordering`` solves the permuted system. ``--device`` defaults to CUDA.
``--ranks N`` runs the distributed solve over N band owners as N processes
(``repro_torch.launch.dist.run_ranks``: gloo ranks share the one card, or
the CPU with ``--device cpu``; NCCL ranks take one card each), and checks
that every rank's ``x`` is the same bits.
"""
import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--density", type=float, default=None)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--method", default="gmres", choices=["gmres", "bicgstab", "cg"])
    ap.add_argument("--ordering", default="natural", choices=["natural", "rcm", "fusion"])
    ap.add_argument("--backend", default="torch", choices=["torch", "oracle", "topilu"])
    ap.add_argument("--devices", type=int, default=1, help="band owners (topilu)")
    ap.add_argument("--broadcast", default="gather", choices=["gather", "ring"])
    ap.add_argument("--band-rows", type=int, default=32)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=0,
                    help="band owners as processes (topilu over torch.distributed)")
    ap.add_argument("--dist-backend", default="gloo", choices=["gloo", "nccl"])
    args = ap.parse_args()
    if args.ranks:
        return main_ranks(args)

    import numpy as np

    from repro_torch.core.matgen import matgen
    from repro_torch.core.solvers import solve_sharded, solve_with_ilu

    density = args.density or min(0.08, 20.0 / args.n)
    a = matgen(args.n, density=density, seed=args.seed)
    b = np.random.default_rng(args.seed + 1).standard_normal(args.n).astype(np.float32)
    t0 = time.perf_counter()
    if args.backend == "topilu":
        res, fact = solve_sharded(a, b, k=args.k, n_devices=args.devices,
                                  band_rows=args.band_rows, broadcast=args.broadcast,
                                  method=args.method, ordering=args.ordering,
                                  device=args.device)
        where = (f"devices={fact.n_devices} broadcast={args.broadcast} "
                 f"band_rows={args.band_rows} supersteps={fact.plan.n_supersteps}")
    else:
        res, fact = solve_with_ilu(a, b, k=args.k, method=args.method, backend=args.backend,
                                   band_rows=args.band_rows, ordering=args.ordering,
                                   device=args.device)
        where = ""
    dt = time.perf_counter() - t0
    print(f"n={args.n} nnz={a.nnz} k={args.k} backend={args.backend} device={fact.device} "
          f"ordering={args.ordering} {where}".rstrip())
    print(f"fill {a.nnz} -> {fact.nnz}; symbolic {fact.symbolic_seconds:.3f}s "
          f"numeric {fact.numeric_seconds:.3f}s")
    print(f"{args.method}: {res.iterations} iterations, residual {res.residual:.2e}, "
          f"total {dt:.2f}s, converged={res.converged} ({res.verdict})")


def main_ranks(args):
    import numpy as np

    from repro_torch.launch.dist import run_ranks, solve_rank

    density = args.density or min(0.08, 20.0 / args.n)
    devices = [args.device] * args.ranks if args.device == "cpu" else None
    t0 = time.perf_counter()
    out = run_ranks(solve_rank, args.ranks, args.dist_backend, devices,
                    args=(args.n, density, args.k, args.method, args.broadcast, args.band_rows,
                          args.ordering, args.seed))
    dt = time.perf_counter() - t0
    r0 = out[0]
    same = all(np.array_equal(o["x"].view(np.int32), r0["x"].view(np.int32)) for o in out)
    print(f"n={args.n} nnz={r0['nnz']} k={args.k} ranks={args.ranks} backend={args.dist_backend} "
          f"ordering={args.ordering} broadcast={args.broadcast} band_rows={args.band_rows} "
          f"supersteps={r0['supersteps']}")
    print(f"fill {r0['nnz']} -> {r0['fill']}; symbolic {r0['symbolic']:.3f}s "
          f"numeric {r0['numeric']:.3f}s")
    for o in out:
        print(f"rank {o['rank']}: {o['seconds']:.2f}s, collectives {o['counts']['collectives']} "
              f"({o['exchange_seconds']:.2f}s), staged {o['staged_bytes']} B")
    print(f"{args.method}: {r0['iterations']} iterations, residual {r0['residual']:.2e}, "
          f"total {dt:.2f}s, converged={r0['converged']} ({r0['verdict']}); x on every rank "
          + ("bitwise equal" if same else "DIFFERS"))
    if not same:
        raise SystemExit("the ranks' solutions differ")


if __name__ == "__main__":
    main()
