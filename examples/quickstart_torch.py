"""Quickstart with the PyTorch port: factor a diagonally-dominant sparse
matrix with ILU(k) and solve Ax=b with preconditioned BiCGSTAB, the
paper's end-to-end use case; then hold the factor to the sequential oracle
bit for bit.

    python examples/quickstart_torch.py [n] [k]                # on the GPU
    python examples/quickstart_torch.py [n] [k] --device cpu   # the plain versions
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import matgen
from repro_torch.core.api import ilu
from repro_torch.core.solvers import solve_with_ilu


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=1000)
    ap.add_argument("k", type=int, nargs="?", default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n, k, dev = args.n, args.k, args.device

    print(f"matgen: n={n}, density={min(0.08, 20.0/n):.4f}")
    a = matgen.matgen(n, density=min(0.08, 20.0 / n), seed=0)

    print(f"\n-- ILU({k}) factorization --")
    fact = ilu(a, k, device=dev)
    print(f"entries: {a.nnz} -> {fact.nnz} " f"(fill ratio {fact.nnz / a.nnz:.2f})")
    print(f"symbolic {fact.symbolic_seconds*1e3:.1f} ms, "
          f"numeric {fact.numeric_seconds*1e3:.1f} ms")

    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    print("\n-- BiCGSTAB --")
    plain, _ = solve_with_ilu(a, b, k=None, method="bicgstab", maxiter=400, device=dev)
    pre, _ = solve_with_ilu(a, b, k=k, method="bicgstab", maxiter=400, device=dev)
    print(f"no preconditioner : {plain.iterations:4d} iters, residual {plain.residual:.2e}")
    print(f"ILU({k})            : {pre.iterations:4d} iters, residual {pre.residual:.2e}")
    assert pre.converged
    print("\nbit-compat check vs sequential oracle ...", end=" ")
    ref = ilu(a, k, backend="oracle", device=dev)
    assert np.array_equal(np.asarray(fact.vals).view(np.int32), np.asarray(ref.vals).view(np.int32))
    print("BITWISE EQUAL ✓")


if __name__ == "__main__":
    main()
