"""Training launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 100 \
        [--reduced] [--ckpt /path] [--seq-len 128] [--batch 8] [--microbatches 2] \
        [--device cpu]

The flags of ``python -m repro.launch.train``, plus ``--device``: the card
by default; without a GPU it raises unless ``--device cpu`` is given.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.train.loop import train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = train(
        cfg, n_steps=args.steps, ckpt_dir=args.ckpt, seq_len=args.seq_len,
        global_batch=args.batch, microbatches=args.microbatches, device=args.device,
        opt_cfg=adamw.AdamWConfig(lr=args.lr, warmup_steps=min(10, args.steps // 5),
                                  total_steps=args.steps),
    )
    print(f"done: {res.steps} steps, final loss {res.losses[-1]:.4f}, "
          f"stragglers {res.straggler_steps}")
    return res


if __name__ == "__main__":
    main()
