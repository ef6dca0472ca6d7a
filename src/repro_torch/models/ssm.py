"""Selective SSM (Mamba-style) branch: hymba's parallel heads.

The port's copy of ``repro.models.ssm``. Diagonal selective state space,
per channel c and state dim n:

    h_t = exp(dt_t * A) ⊙ h_{t-1} + dt_t * B_t * x_t
    y_t = C_t · h_t + D ⊙ x_t

with input-dependent dt, B, C; a depthwise causal conv of kernel 4 (as
shifted adds) before it. ``a_log`` (deterministic: log 1..N per channel),
``d_skip`` and ``dt_bias`` are float32 leaves in a model of any dtype, the
state ``h`` is float32, the conv state is in the parameters' dtype.

The recurrence is a loop over time, in blocks of ``SCAN_BLOCK`` steps:
the decays and inputs of a block's steps are computed at once
(elementwise, the JAX step's own expressions), so a step is one product
and one sum over (B, d_inner, N), and the readout C_t · h_t of the block's
steps is one contraction after its loop. The state is carried from block
to block, so memory is O(B · SCAN_BLOCK · d_inner · N) whatever S is
(the JAX scan holds O(B · d_inner · N)). Under a gradient a block's loop
runs through ``scan_utils.chunked_remat_scan``, as the JAX scan does: its
chunks of at most 128 steps keep their input state and their states for
the readout, not each step's saved tensors. Prefill and decode (no
gradient) run the plain loop; decode is the same with S = 1, from the
carried state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import scan_utils
from .common import dense_init

SCAN_BLOCK = 256  # time steps whose decays, inputs and states are held at once


def init_ssm(cfg, generator, device):
    d = cfg.d_model
    di = cfg.ssm_inner or d
    N = cfg.ssm_state
    dtr = max(d // 16, 1)
    dt = cfg.param_dtype
    f32 = torch.float32
    return {
        "in_proj": dense_init(generator, (d, di), dt, device),
        "conv_w": dense_init(generator, (4, di), dt, device, scale=0.5),  # depthwise, k = 4
        "a_log": torch.log(torch.arange(1, N + 1, dtype=f32, device=device)[None, :]
                           .repeat(di, 1)),  # (di, N)
        "d_skip": torch.ones((di,), dtype=f32, device=device),
        "w_bc": dense_init(generator, (di, 2 * N), dt, device),
        "w_dt1": dense_init(generator, (di, dtr), dt, device),
        "w_dt2": dense_init(generator, (dtr, di), dt, device),
        "dt_bias": torch.zeros((di,), dtype=f32, device=device),
        "out_proj": dense_init(generator, (di, d), dt, device,
                               scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _causal_conv4(u, w, state=None):
    """Depthwise causal conv, kernel 4, via shifted adds. u: (B,S,di), w:
    (4,di), state (B,3,di) or None (zeros). Returns (y, new_state (B,3,di))."""
    if state is None:
        state = torch.zeros((u.shape[0], 3, u.shape[2]), dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)  # (B, S+3, di)
    y = ext[:, 0:-3] * w[0] + ext[:, 1:-2] * w[1] + ext[:, 2:-1] * w[2] + ext[:, 3:] * w[3]
    return y, ext[:, -3:]


def _ssm_step(h, x):
    """One step of the recurrence: h_t = decay_t ⊙ h_{t-1} + inp_t; the new
    state is both the carry and the output."""
    decay_t, inp_t = x
    h = h * decay_t + inp_t
    return h, h


def _ssm_scan(u, dt_, B_, C_, a, h0):
    """u, dt_: (B,S,di); B_, C_: (B,S,N); a: (di,N) negative; h0: (B,di,N).
    Returns (h_S, y (B,S,di)). Runs in blocks of ``SCAN_BLOCK`` steps, the
    state carried between them, so memory does not grow with S. A block's
    steps go through ``chunked_remat_scan``: under a gradient, chunks of at
    most ``scan_utils.REMAT_CHUNK`` steps keep their input state and their
    output states (the readout's operand), and recompute the rest in the
    backward; without one (prefill, decode) the plain loop."""
    h = h0
    ys = []
    for s in range(0, u.shape[1], SCAN_BLOCK):
        blk = slice(s, s + SCAN_BLOCK)
        decay = torch.exp(dt_[:, blk, :, None] * a)  # (B,T,di,N)
        inp = (dt_[:, blk] * u[:, blk])[..., None] * B_[:, blk, None, :]
        h, hs = scan_utils.chunked_remat_scan(_ssm_step, h, (decay, inp))
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, C_[:, blk]))
    return h, torch.cat(ys, dim=1)


def ssm_forward(p, x, cfg, state=None):
    """x: (B,S,d), state None or {'h': (B,di,N) f32, 'conv': (B,3,di)}.
    Returns (y (B,S,d), new_state)."""
    B, S, d = x.shape
    di = cfg.ssm_inner or d
    N = cfg.ssm_state
    u = x @ p["in_proj"]
    u, conv_state = _causal_conv4(u, p["conv_w"], None if state is None else state["conv"])
    u = F.silu(u)
    bc = (u @ p["w_bc"]).float()
    B_, C_ = bc[..., :N], bc[..., N:]
    dt_ = F.softplus(((u @ p["w_dt1"]) @ p["w_dt2"]).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])  # (di, N), negative: a stable decay
    h0 = (torch.zeros((B, di, N), dtype=torch.float32, device=x.device) if state is None
          else state["h"])
    h, y = _ssm_scan(u.float(), dt_, B_, C_, a, h0)
    y = y + u.float() * p["d_skip"]
    return y.to(x.dtype) @ p["out_proj"], {"h": h, "conv": conv_state}


def ssm_decode(p, x, cfg, state):
    """One-token step; ``state`` ({'h', 'conv'}, as :func:`init_ssm_state`
    makes it) is updated in place. Returns (B, 1, d)."""
    out, new = ssm_forward(p, x, cfg, state=state)
    for k, t in new.items():
        state[k].copy_(t)
    return out


def init_ssm_state(cfg, batch, device):
    di = cfg.ssm_inner or cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, di), dtype=cfg.param_dtype, device=device)}
