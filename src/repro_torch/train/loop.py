"""Training loop: data -> step -> metrics -> checkpoint, with fault hooks.

The port's copy of ``repro.train.loop``: the driver that
``examples/train_smollm_torch.py`` and ``python -m repro_torch.launch.train``
use. It draws the model from ``torch.Generator(device).manual_seed(seed)``,
resumes from the latest checkpoint under ``ckpt_dir`` when there is one
(the model's parameters and the optimizer's state are overwritten in
place), and runs the steps eagerly: JAX's ``donate_argnums`` is the train
step's in-place update. On the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from ..checkpoint.ckpt import AsyncCheckpointer, latest_step, restore
from ..core.device import resolve_device
from ..data.pipeline import SyntheticLM
from ..models import model as M
from ..models.convert import flatten, param_tree
from ..optim import adamw
from ..runtime.fault import StragglerMonitor
from .step import make_train_step


@dataclasses.dataclass
class TrainResult:
    losses: list
    steps: int
    restored_from: Optional[int]
    straggler_steps: int
    #: host seconds of each step run (each ends when its loss is read)
    step_seconds: list = dataclasses.field(default_factory=list)
    #: the trained model and optimizer state, to go on from or to inspect
    model: Any = None
    opt_state: Any = None


def train(
    cfg,
    n_steps: int = 50,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
    ckpt_dir: Optional[str] = None,
    save_every: int = 20,
    seed: int = 0,
    log_every: int = 10,
    seq_len: int = 128,
    global_batch: int = 8,
    microbatches: int = 1,
    device=None,
) -> TrainResult:
    dev = resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=n_steps)
    data = SyntheticLM(cfg.vocab_real, seq_len, global_batch)
    model = M.Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    opt_state = adamw.init(param_tree(model))
    start = 0
    restored = None
    ck = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state = (param_tree(model), opt_state)
        saved, manifest = restore(ckpt_dir, None, state, device=dev)
        with torch.no_grad():
            for dst, src in zip(flatten(state), flatten(saved)):
                dst.copy_(src)
        start = manifest["step"]
        restored = start

    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    losses, seconds = [], []
    monitor = StragglerMonitor()
    for step in range(start, n_steps):
        batch = data.batch_at(step)
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        seconds.append(time.perf_counter() - t0)
        monitor.observe(seconds[-1])
        losses.append(loss)
        if log_every and (step % log_every == 0 or step == n_steps - 1):
            print(f"step {step:5d}  loss {loss:.4f}  lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        if ck and ((step + 1) % save_every == 0 or step + 1 == n_steps):
            ck.save_async(step + 1, (param_tree(model), opt_state))
    if ck:
        ck.wait()
    return TrainResult(
        losses=losses, steps=n_steps - start, restored_from=restored,
        straggler_steps=monitor.slow_steps, step_seconds=seconds, model=model,
        opt_state=opt_state,
    )
