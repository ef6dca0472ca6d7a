"""End-to-end training on the PyTorch port: a smollm-135m-family model on
synthetic data.

    PYTHONPATH=src python examples/train_smollm_torch.py [--steps 60] [--device cpu]
        [--ckpt /path] [--seq-len 128] [--batch 8]

The port's counterpart of ``examples/train_smollm.py``, through
``repro_torch.train.loop.train``. On ``--device cpu`` the config is the
reduced one widened as the JAX example's (4 layers, d = 128, d_ff 256,
float32); on the card (the default; it raises where there is no GPU) it is
smollm-135m at its published size, in bf16 with remat ``"dots"``. It prints
the mean of the first five and of the last five losses.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.train.loop import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config("smollm-135m")
    if dev.type == "cpu":
        cfg = dataclasses.replace(cfg.reduced(), n_layers=4, d_model=128, d_ff=256)
    print(f"arch={cfg.arch} layers={cfg.n_layers} d={cfg.d_model} "
          f"params~{cfg.param_count()['total'] / 1e6:.1f}M device={dev}")
    res = train(
        cfg,
        n_steps=args.steps,
        ckpt_dir=args.ckpt,
        seq_len=args.seq_len,
        global_batch=args.batch,
        opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps),
        device=dev,
    )
    first = sum(res.losses[:5]) / 5
    last = sum(res.losses[-5:]) / 5
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"({'IMPROVED' if last < first else 'no improvement'})")
    if res.restored_from is not None:
        print(f"(restored from checkpoint step {res.restored_from})")


if __name__ == "__main__":
    main()
