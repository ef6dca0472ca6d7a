"""Feed-forward layers: the dense SwiGLU / GELU MLP.

The port's copy of the dense half of ``repro.models.ffn``. The
Mixture-of-Experts waits for the slice of the other families (ROADMAP Queue
A item 13c).
"""
from __future__ import annotations

import math

from .common import dense_init, gelu, swiglu


def init_mlp(cfg, generator, device):
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    if cfg.mlp_act == "swiglu":
        return {
            "w_gate": dense_init(generator, (d, f), dt, device),
            "w_up": dense_init(generator, (d, f), dt, device),
            "w_down": dense_init(generator, (f, d), dt, device, scale=out_scale),
        }
    return {
        "w_up": dense_init(generator, (d, f), dt, device),
        "w_down": dense_init(generator, (f, d), dt, device, scale=out_scale),
    }


def mlp(p, x, cfg):
    if cfg.mlp_act == "swiglu":
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    return gelu(x @ p["w_up"]) @ p["w_down"]
