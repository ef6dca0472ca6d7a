"""Attention: GQA with chunked (flash-style) online softmax, MLA, decode.

The port's copy of ``repro.models.attention``, in plain PyTorch and
computing what the JAX package computes:

* Prefill attention never materializes S×S scores: a static loop over
  query chunks walks exactly the causal prefix of KV chunks (and skips the
  chunks wholly below a sliding window), with the same running max / sum
  rescaling as the JAX scan. Scores are float32, masked with ``NEG_INF``
  (-1e30, not -inf: a fully masked chunk must not give NaN), and the
  output is cast back to the activation dtype. ``causal=False`` (whisper's
  encoder and the cross-attention) visits every KV chunk with no mask.
* Decode attends one query position against the cache with a length mask;
  ``gqa_decode`` writes the new K/V at slot ``pos % L`` in place into the
  preallocated cache (a plain append when L is the max length, a ring
  buffer when L is the sliding window).
* MLA (DeepSeek) caches only the normalized latent ``c`` (r wide) and the
  shared rope key ``r`` (d_r wide). The prefill expands per-head K/V from
  the latent (q/k heads of nope + rope, v heads of ``mla_v_dim``); the
  decode is the absorbed form: W_uk folded into the query, the scores and
  the latent output in float32, W_uv applied after.

The ``unroll_prefix`` cost-pass form is not ported (ROADMAP Queue A item
13d).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .common import apply_rope, dense_init, rms_norm, rope_angles

NEG_INF = -1e30


# --------------------------------------------------------------------------
# chunked causal attention (q: (B,S,H,D), k/v: (B,Skv,Hkv,D))
# --------------------------------------------------------------------------
def _attend_block(q, k, v, scale, mask):
    """One (q-chunk, kv-chunk) block; ``mask`` (1 or B, cq, ck) is True
    where a query may see a key (None: every key). Returns (scores_max, exp_sum, out)."""
    B, cq, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, cq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return m, l, o


def _pick(size, c):
    """The largest divisor of ``size`` not above ``c``."""
    c = min(c, size)
    while size % c:
        c -= 1
    return c


def chunked_attention(q, k, v, positions_q=None, positions_kv=None, *, causal: bool = True,
                      window: Optional[int] = None, q_chunk: int = 1024, kv_chunk: int = 1024):
    """Flash-style attention. Shapes: q (B,S,H,D), k/v (B,Skv,Hkv,Dv);
    positions_q (S,), positions_kv (Skv,) (default: 0, 1, ...), read only
    when ``causal``."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    scale = 1.0 / math.sqrt(D)
    cq = _pick(S, q_chunk)
    ck = _pick(Skv, kv_chunk)
    nq, nk = S // cq, Skv // ck
    g = H // Hkv
    if causal and positions_q is None:
        positions_q = torch.arange(S, device=q.device)
    if causal and positions_kv is None:
        positions_kv = torch.arange(Skv, device=q.device)

    outs = []
    for qi in range(nq):
        qs = q[:, qi * cq:(qi + 1) * cq]
        # static causal prefix: kv chunks lo..hi-1; a sliding window skips below lo
        hi = min(nk, ((qi + 1) * cq + ck - 1) // ck) if causal else nk
        lo = max(0, (qi * cq - window) // ck) if causal and window is not None else 0
        m_run = torch.full((B, cq, Hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((B, cq, Hkv, g), dtype=torch.float32, device=q.device)
        o_run = torch.zeros((B, cq, Hkv, g, Dv), dtype=torch.float32, device=q.device)
        for kc in range(lo, hi):
            ks = k[:, kc * ck:(kc + 1) * ck]
            vs = v[:, kc * ck:(kc + 1) * ck]
            mask = None
            if causal:
                pos_q = positions_q[qi * cq:(qi + 1) * cq]
                pos_k = positions_kv[kc * ck:(kc + 1) * ck]
                mask = pos_q[None, :, None] >= pos_k[None, None, :]
                if window is not None:
                    mask &= pos_q[None, :, None] - pos_k[None, None, :] < window
            m_b, l_b, o_b = _attend_block(qs, ks, vs, scale, mask)
            m_new = torch.maximum(m_run, m_b)
            a1 = torch.exp(m_run - m_new)
            a2 = torch.exp(m_b - m_new)
            l_run = l_run * a1 + l_b * a2
            o_run = o_run * a1[..., None] + o_b * a2[..., None]
            m_run = m_new
        o = o_run / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(o.reshape(B, cq, H, Dv).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def decode_attention(q, k_cache, v_cache, n_valid):
    """One-token decode: q (B,1,H,D) vs cache (B,L,Hkv,D).

    ``n_valid`` (B,) is the number of written slots. For ring-buffer
    (sliding-window) caches, L == window and wrapped slots are all valid:
    slot order does not matter, since RoPE was applied at insertion and the
    softmax is permutation-invariant."""
    B, _, H, D = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, 1, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k_cache.float()) * scale
    valid = torch.arange(L, device=q.device)[None, :] < n_valid[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


# --------------------------------------------------------------------------
# standard GQA block params + apply
# --------------------------------------------------------------------------
def init_gqa(cfg, generator, device):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    wo_scale = 1.0 / math.sqrt(2 * cfg.n_layers * H * hd / d) / math.sqrt(d)
    p = {
        "wq": dense_init(generator, (d, H * hd), dt, device),
        "wk": dense_init(generator, (d, Hkv * hd), dt, device),
        "wv": dense_init(generator, (d, Hkv * hd), dt, device),
        "wo": dense_init(generator, (H * hd, d), dt, device, scale=wo_scale),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((Hkv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((Hkv * hd,), dtype=dt, device=device)
    return p


def gqa_project_qkv(p, x, cfg, positions):
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.use_rope:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def gqa_attention(p, x, cfg, positions=None, cross_kv=None):
    """Full-sequence (prefill) GQA self-attention, positions (S,) (default
    0, 1, ...); or cross-attention when ``cross_kv`` carries the raw
    encoder states (B, T, d), projected here with this layer's wk / wv (no
    RoPE, no K/V bias, no mask)."""
    B, S, d = x.shape
    if cross_kv is not None:
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        T = cross_kv.shape[1]
        q = x @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
        q = q.reshape(B, S, H, hd)
        k = (cross_kv @ p["wk"]).reshape(B, T, Hkv, hd)
        v = (cross_kv @ p["wv"]).reshape(B, T, Hkv, hd)
        o = chunked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        return o.reshape(B, S, -1) @ p["wo"]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    o = chunked_attention(q, k, v, positions, positions, window=cfg.sliding_window,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return o.reshape(B, S, -1) @ p["wo"]


def gqa_decode(p, x, cfg, cache):
    """One-token decode. ``cache``: {k, v: (B,L,Hkv,hd), len: (B,) int32},
    all updated in place (K/V written at slot ``len % L``, ``len`` raised by
    one). Returns the attention's output (B, 1, d)."""
    B, S, d = x.shape
    assert S == 1
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = cache["len"]
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    k = (x @ p["wk"]).reshape(B, 1, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, 1, Hkv, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(1, 1, H, hd)
        k = k + p["bk"].reshape(1, 1, Hkv, hd)
        v = v + p["bv"].reshape(1, 1, Hkv, hd)
    if cfg.use_rope:
        cos, sin = rope_angles(pos[:, None].float(), hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    k_cache, v_cache = cache["k"], cache["v"]
    L = k_cache.shape[1]
    slot = pos.long() % L  # ring buffer (L == window) or plain append (L == max_len)
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    n_valid = torch.clamp(pos + 1, max=L)
    o = decode_attention(q, k_cache, v_cache, n_valid)
    pos += 1
    return o.reshape(B, 1, -1) @ p["wo"]


# --------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# --------------------------------------------------------------------------
def init_mla(cfg, generator, device):
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    r = cfg.mla_kv_lora
    dt = cfg.param_dtype
    return {
        "wq": dense_init(generator, (d, H * (dn + dr)), dt, device),
        "w_dkv": dense_init(generator, (d, r + dr), dt, device),
        "kv_norm": torch.ones((r,), dtype=dt, device=device),
        "w_uk": dense_init(generator, (r, H * dn), dt, device),
        "w_uv": dense_init(generator, (r, H * dv), dt, device),
        "wo": dense_init(generator, (H * dv, d), dt, device,
                         scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def mla_attention(p, x, cfg, positions=None):
    """Prefill MLA: per-head K/V expanded from the latent; q/k heads of
    nope + rope (scale 1/sqrt(nope + rope)), one rope key shared by every
    head, v heads of ``mla_v_dim``."""
    B, S, d = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    r = cfg.mla_kv_lora
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = x @ p["w_dkv"]  # (B, S, r + dr)
    c_kv, k_rope = ckv[..., :r], ckv[..., r:]
    c_kv = rms_norm(c_kv, p["kv_norm"])
    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, dn)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, dv)
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)  # the single shared rope head
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    o = chunked_attention(qf, kf, v, positions, positions, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk)
    return o.reshape(B, S, H * dv) @ p["wo"]


def mla_decode(p, x, cfg, cache):
    """Absorbed-form one-token decode. ``cache``: {c: (B,L,r), r: (B,L,dr),
    len: (B,) int32}, all updated in place (the new latent and rope key at
    slot ``len % L``, ``len`` raised by one). Slots below ``len + 1`` are
    attended: once the cache wraps, all of them. Returns (B, 1, d)."""
    B, S, d = x.shape
    assert S == 1
    H = cfg.n_heads
    dn, dr, dv = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    r = cfg.mla_kv_lora
    pos = cache["len"]
    q = (x @ p["wq"]).reshape(B, 1, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_angles(pos[:, None].float(), dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    ckv = x @ p["w_dkv"]
    c_new, kr_new = ckv[..., :r], ckv[..., r:]
    c_new = rms_norm(c_new, p["kv_norm"])
    kr_new = apply_rope(kr_new[:, :, None, :], cos, sin)[:, 0, 0]
    c_cache, r_cache = cache["c"], cache["r"]
    L = c_cache.shape[1]
    bidx = torch.arange(B, device=x.device)
    slot = pos.long() % L
    c_cache[bidx, slot] = c_new[:, 0].to(c_cache.dtype)
    r_cache[bidx, slot] = kr_new.to(r_cache.dtype)
    # absorb W_uk into q: q_lat (B, 1, H, r)
    w_uk = p["w_uk"].reshape(r, H, dn).float()
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk)
    s_lat = torch.einsum("bshr,blr->bshl", q_lat, c_cache.float())
    s_rope = torch.einsum("bshd,bld->bshl", q_rope.float(), r_cache.float())
    s = (s_lat + s_rope) * (1.0 / math.sqrt(dn + dr))
    valid = torch.arange(L, device=x.device)[None, :] < (pos + 1)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bshl,blr->bshr", pattn, c_cache.float())  # (B, 1, H, r)
    w_uv = p["w_uv"].reshape(r, H, dv).float()
    o = torch.einsum("bshr,rhd->bshd", o_lat, w_uv).to(x.dtype)
    pos += 1
    return o.reshape(B, 1, H * dv) @ p["wo"]
