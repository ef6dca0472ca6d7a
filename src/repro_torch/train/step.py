"""train_step / serve_step / prefill_step factories.

The port's copy of ``repro.train.step``. ``make_train_step`` closes over
the config and the optimizer's config and returns

    train_step(model, opt_state, batch) -> (model, opt_state, metrics)

which takes the gradient of ``loss_fn`` (optionally accumulated over
``microbatches`` contiguous slices of the batch, in float32 buffers),
optionally compresses it (``ef_compress_tree``), and applies
``adamw.update`` to the model's parameters in place; ``metrics`` holds
``loss``, ``grad_norm`` and ``lr`` as scalar tensors. The batch's arrays
(NumPy or tensors) are moved to the model's device.

``make_serve_step`` returns one greedy decode step:

    serve_step(model, cache, tokens) -> (next_tokens, logits, cache)

``make_prefill_step`` returns the forward pass that keeps the last
position's logits. Both run without autograd.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import model as M
from ..models.convert import flatten, param_tree, unflatten
from ..optim import adamw
from ..optim.compression import ef_compress_tree


def batch_to(batch, device) -> dict:
    """``batch``'s arrays as tensors on ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, microbatches: int = 1,
                    compress_grads: bool = False):
    def loss_and_grads(model, leaves, batch):
        with torch.enable_grad():
            loss = M.loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def train_step(model, opt_state, batch):
        M.trainable(model)
        batch = batch_to(batch, model.device)
        params = param_tree(model)
        leaves = flatten(params)
        if microbatches > 1:
            n = next(iter(batch.values())).shape[0] // microbatches
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                loss, g = loss_and_grads(model, leaves,
                                         {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                for acc, gi in zip(gsum, g):
                    acc.add_(gi.float())
                lsum = lsum + loss
            mbs = torch.tensor(float(microbatches), dtype=torch.float32, device=model.device)
            grads = [acc / mbs for acc in gsum]
            loss = lsum / mbs
        else:
            loss, grads = loss_and_grads(model, leaves, batch)
        grads = unflatten(params, grads)
        if compress_grads:
            grads, _ = ef_compress_tree(grads)  # stateless form
        _, opt_state, metrics = adamw.update(opt_cfg, grads, opt_state, params)
        return model, opt_state, dict(metrics, loss=loss)

    return train_step


def make_serve_step(cfg):
    def serve_step(model, cache, tokens):
        with torch.no_grad():
            logits, cache = M.decode_step(cfg, model, cache, tokens)
            next_tok = torch.argmax(logits[..., :cfg.vocab_real], dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return serve_step


def make_prefill_step(cfg):
    """The forward pass of the prefill shapes; returns only the last
    position's logits (what serving needs)."""

    def prefill_step(model, batch):
        with torch.no_grad():
            return M.forward(cfg, model, batch)[:, -1, :]

    return prefill_step
