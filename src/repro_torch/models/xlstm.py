"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory + recurrence).

The port's copy of ``repro.models.xlstm`` (arXiv:2405.04517 at xlstm-125m
scale):

* mLSTM, per head: a matrix memory C (hd × hd), a normalizer n (hd) and an
  exponential input gate stabilized by a running max m:
      m_t = max(log σ(f̃) + m_{t-1}, ĩ)
      C_t = exp(log σ(f̃) + m_{t-1} - m_t) C_{t-1} + exp(ĩ - m_t) v k^T
      y_t = C_t q / max(|n_t · q|, 1)
* sLSTM: a scalar memory with per-head block-diagonal recurrent weights on
  h_{t-1} feeding all four gates; the recurrent product of a head comes out
  as its four gates' hd entries side by side and is interleaved back into
  four gates of d (as ``xlstm.py:120-122`` of the JAX package).

The gates and states are float32 whatever the model's dtype. The
recurrences are loops over time (a decode step is one iteration from the
carried state); the log-forget gates of every step are computed before the
loop.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init, rms_norm


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
def init_mlstm(cfg, generator, device):
    d, H = cfg.d_model, cfg.n_heads
    di = 2 * d
    dt = cfg.param_dtype
    return {
        "up": dense_init(generator, (d, 2 * di), dt, device),  # [mlstm input | output gate]
        "wq": dense_init(generator, (di, di), dt, device),
        "wk": dense_init(generator, (di, di), dt, device),
        "wv": dense_init(generator, (di, di), dt, device),
        "w_if": dense_init(generator, (di, 2 * H), dt, device, scale=0.01),
        "norm": torch.ones((di,), dtype=dt, device=device),
        "down": dense_init(generator, (di, d), dt, device,
                           scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def mlstm_state(cfg, batch, device):
    H = cfg.n_heads
    hd = 2 * cfg.d_model // H
    f32 = torch.float32
    return (torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
            torch.zeros((batch, H, hd), dtype=f32, device=device),
            torch.zeros((batch, H), dtype=f32, device=device))


def _mlstm_scan(q, k, v, i_pre, f_pre, state):
    """q, k, v: (B,S,H,hd); i_pre, f_pre: (B,S,H); state (C, n, m)."""
    C, n, m = state
    logf_all = F.logsigmoid(f_pre)  # the forget gate in log space
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt, it, logf = q[:, t], k[:, t], v[:, t], i_pre[:, t], logf_all[:, t]
        m_new = torch.maximum(logf + m, it)
        fg = torch.exp(logf + m - m_new)[..., None]  # (B,H,1)
        ig = torch.exp(it - m_new)[..., None]
        C = fg[..., None] * C + ig[..., None] * (vt[..., :, None] * kt[..., None, :])
        n = fg * n + ig * kt
        num = torch.matmul(C, qt[..., None])[..., 0]
        den = torch.clamp(torch.abs(torch.sum(n * qt, dim=-1))[..., None], min=1.0)
        ys.append(num / den)
        m = m_new
    return (C, n, m), torch.stack(ys, dim=1)  # (B,S,H,hd)


def mlstm_forward(p, x, cfg, state=None):
    """x: (B,S,d). Returns (y (B,S,d), new_state (C, n, m))."""
    B, S, d = x.shape
    H = cfg.n_heads
    di = 2 * d
    hd = di // H
    up = x @ p["up"]
    u, og = up[..., :di], up[..., di:]
    q = (u @ p["wq"]).reshape(B, S, H, hd).float() / math.sqrt(hd)
    k = (u @ p["wk"]).reshape(B, S, H, hd).float()
    v = (u @ p["wv"]).reshape(B, S, H, hd).float()
    gif = (u @ p["w_if"]).float()
    if state is None:
        state = mlstm_state(cfg, B, x.device)
    state, y = _mlstm_scan(q, k, v, gif[..., :H], gif[..., H:], state)
    y = rms_norm(y.reshape(B, S, di).to(x.dtype), p["norm"]) * F.silu(og)
    return y @ p["down"], state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def init_slstm(cfg, generator, device):
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    dt = cfg.param_dtype
    return {
        "w_gates": dense_init(generator, (d, 4 * d), dt, device),  # i, f, z, o from x
        "r_gates": dense_init(generator, (H, hd, 4 * hd), dt, device, scale=1.0 / math.sqrt(hd)),
        "norm": torch.ones((d,), dtype=dt, device=device),
        "down": dense_init(generator, (d, d), dt, device,
                           scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def slstm_state(cfg, batch, device):
    return tuple(torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
                 for _ in range(4))


def _slstm_scan(gx, r, state, H, hd):
    """gx: (B,S,4d); r: (H,hd,4hd) float32; state (c, n, h, m), each (B,d)."""
    c, n, h, m = state
    B = gx.shape[0]
    d_ = H * hd
    ys = []
    for t in range(gx.shape[1]):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, hd), r)
        # each head's 4·hd entries back into 4 gates of d
        rec = rec.reshape(B, H, 4, hd).transpose(1, 2).reshape(B, 4 * d_)
        g = gx[:, t] + rec
        i_pre, f_pre, z_pre, o_pre = g[:, :d_], g[:, d_:2 * d_], g[:, 2 * d_:3 * d_], g[:, 3 * d_:]
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        ig = torch.exp(i_pre - m_new)
        fg = torch.exp(logf + m - m_new)
        c = fg * c + ig * torch.tanh(z_pre)
        n = fg * n + ig
        h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)
        m = m_new
        ys.append(h)
    return (c, n, h, m), torch.stack(ys, dim=1)


def slstm_forward(p, x, cfg, state=None):
    """x: (B,S,d). Returns (y (B,S,d), new_state (c, n, h, m))."""
    B, S, d = x.shape
    H = cfg.n_heads
    gx = (x @ p["w_gates"]).float()
    if state is None:
        state = slstm_state(cfg, B, x.device)
    state, y = _slstm_scan(gx, p["r_gates"].float(), state, H, d // H)
    y = rms_norm(y.to(x.dtype), p["norm"])
    return y @ p["down"], state
