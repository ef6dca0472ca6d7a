"""TOP-ILU over 8 band owners: the paper's Fig-4 pipeline, on the PyTorch port.

    PYTHONPATH=src python examples/ilu_pipeline_demo_torch.py                # on a GPU
    PYTHONPATH=src python examples/ilu_pipeline_demo_torch.py --device cpu
    PYTHONPATH=src python examples/ilu_pipeline_demo_torch.py --device cpu --ranks --owners 4

The counterpart of ``examples/ilu_pipeline_demo.py``: the same matrix
(``matgen(512, density=0.02, seed=3)``), PILU(1), 16-row bands owned
round-robin by the owners, factored by ``topilu_numeric`` with the
``"psum"`` broadcast (the port's name for it is ``"gather"``: one
all-gather per superstep) and with the explicit ``"ring"`` (D-1 hops per
superstep), each held to the sequential oracle ``numeric_ilu_ref`` on int32
views. By default the owners are one :class:`BandGroup` on the card (one
persistent ``superstep_factor`` launch per factorization); ``--ranks`` runs
them as gloo processes through ``run_ranks``, one owner each (the
counterpart of the reference's simulated devices), on the card or, with
``--device cpu``, on the CPU.
"""
import argparse
import time

import numpy as np

N, DENSITY, SEED, BAND_ROWS = 512, 0.02, 3, 16
BROADCASTS = ("psum", "ring")


def demo_matrix():
    from repro_torch.core.matgen import matgen
    from repro_torch.core.symbolic import pilu1_symbolic

    a = matgen(N, density=DENSITY, seed=SEED)
    return a, pilu1_symbolic(a)  # PILU(1): the symbolic phase needs no communication


def factor_both(group) -> dict:
    """``topilu_numeric`` of the demo matrix over ``group`` under each
    broadcast: {broadcast: (CSR-aligned values, seconds, the group's
    counts)}. Runs on every rank of a group over processes."""
    import torch

    from repro_torch.core.top_ilu import topilu_numeric

    a, pat = demo_matrix()
    out = {}
    for broadcast in BROADCASTS:
        group.reset_counts()
        t0 = time.perf_counter()
        vals = topilu_numeric(a, pat, band_rows=BAND_ROWS, group=group, broadcast=broadcast)
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        out[broadcast] = (vals, time.perf_counter() - t0, group.counts())
    return out


def run(owners: int = 8, device=None, ranks: bool = False) -> dict:
    """Factor the demo matrix over ``owners`` band owners (one
    ``BandGroup`` on ``device``, or ``owners`` gloo ranks) under both
    broadcasts; returns {broadcast: (bitwise equal to numeric_ilu_ref,
    seconds, counts)} and prints one line per broadcast."""
    import torch

    from repro_torch.core.device import resolve_device
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.planner import make_plan
    from repro_torch.core.top_ilu import BandGroup
    from repro_torch.launch.dist import run_ranks

    dev = resolve_device(device)
    a, pat = demo_matrix()
    plan = make_plan(a, pat, band_rows=BAND_ROWS, n_devices=owners)
    where = (f"{owners} gloo ranks on {dev.type}" if ranks
             else f"one BandGroup of {owners} owners on {dev}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"band owners: {owners} ({where}, {name})")
    print(f"n={N} nnz={pat.nnz}  bands={plan.n_bands} x {BAND_ROWS} rows, round-robin over "
          f"{owners} owners, {plan.n_supersteps} supersteps")
    want = numeric_ilu_ref(a, pat).view(np.int32)
    if ranks:
        per_rank = run_ranks(factor_both, owners, "gloo", [dev] * owners, timeout_s=600)
    else:
        per_rank = [factor_both(BandGroup(owners, dev))]
    out = {}
    for broadcast in BROADCASTS:
        got = [r[broadcast] for r in per_rank]
        ok = all(np.array_equal(g[0].view(np.int32), want) for g in got)
        seconds, counts = max(g[1] for g in got), got[0][2]
        out[broadcast] = (ok, seconds, counts)
        print(f"broadcast={broadcast:5s}: {seconds * 1e3:7.1f} ms  {counts['exchanges']} "
              f"exchanges, {counts['collectives']} collectives  "
              f"bitwise-equal={'YES' if ok else 'NO'}")
    print("\n\"psum\" is one all-gather of each superstep's finished rows; \"ring\" forwards "
          "them owner to owner, D-1 hops, the pipeline the paper builds by hand (Fig 4).")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--owners", type=int, default=8)
    ap.add_argument("--ranks", action="store_true", help="one gloo process per owner")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = ap.parse_args()
    out = run(args.owners, args.device, args.ranks)
    return 0 if all(ok for ok, _, _ in out.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
