"""Batched greedy decoding with a KV cache on the PyTorch port.

    PYTHONPATH=src python examples/serve_decode_torch.py [--arch smollm-135m] [--tokens 16]
        [--batch 4] [--device cpu]

The port's counterpart of ``examples/serve_decode.py``: a model with
weights drawn from seed 0, then ``--tokens`` greedy steps of
``make_serve_step`` for ``--batch`` sequences. It runs on the card unless
``--device cpu`` is given (and raises where there is no GPU). The config
is ``ModelConfig.reduced()``, as in the JAX example.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.step import make_serve_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    print(f"arch={args.arch} (reduced), batch={args.batch}, device={dev}")
    model = M.Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    cache = M.init_cache(cfg, args.batch, cache_len=args.tokens + 8, device=dev)
    serve = make_serve_step(cfg)

    gen = torch.Generator(device=dev).manual_seed(0)
    tok = torch.randint(0, cfg.vocab_real, (args.batch, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    seqs = [tok[:, 0]]
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        tok, logits, cache = serve(model, cache, tok)
        seqs.append(tok[:, 0])
    out = torch.stack(seqs, dim=1).cpu()
    dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({args.tokens * args.batch / dt:.1f} tok/s on {dev})")
    for b in range(args.batch):
        print(f"  seq[{b}]: {out[b].tolist()}")


if __name__ == "__main__":
    main()
