"""Why the dry run's cost pass uses the unrolled-prefix attention.

    python examples/dryrun_cost_form_torch.py [--arch smollm-135m] [--shape prefill_32k]

Counts the FLOPs of the dry run's 1- and 2-layer cost configs of one cell
on ``meta`` (no memory, no card), once with the KV-chunk walk of
``chunked_attention`` and once with ``attn_unroll=True`` (one block per
query chunk over its whole prefix of keys), on the 16x16 mesh's logical
axes. The two forms do the same multiply-adds, so the counts must be equal;
the walk dispatches one block per (query chunk, KV chunk) pair, so its
count takes longer on the host. Prints both counts and both wall times.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import _depth, count_flops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--shape", default="prefill_32k", choices=list(SHAPES))
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    sizes = {"data": 16, "model": 16}
    counts = {}
    for unroll in (False, True):
        t0 = time.perf_counter()
        counts[unroll] = [count_flops(_depth(cfg, nl, scan_layers=False, attn_unroll=unroll),
                                      args.shape, sizes) for nl in (1, 2)]
        wall = time.perf_counter() - t0
        print(f"{args.arch} {args.shape} {'unrolled prefix' if unroll else 'KV-chunk walk'}: "
              f"FLOPs at 1 and 2 layers {counts[unroll]}, counted in {wall:.2f} s on the host")
    assert counts[False] == counts[True], counts
    print("counts equal")


if __name__ == "__main__":
    main()
