"""serve_step / prefill_step factories.

The port's copy of the serving half of ``repro.train.step``.
``make_serve_step`` returns one greedy decode step:

    serve_step(model, cache, tokens) -> (next_tokens, logits, cache)

``make_prefill_step`` returns the forward pass that keeps the last
position's logits. Both run without autograd. ``make_train_step`` waits
for the training slice (ROADMAP Queue A item 13b).
"""
from __future__ import annotations

import torch

from ..models import model as M


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
