"""The port's MLA and non-causal attention (``repro_torch.models.attention``)
against the JAX package.

Reduced deepseek-v2-lite in float32 (latent r = 32, nope 16 + rope 8 for
q/k, v 16), the JAX parameters carried over by ``params_from_jax``:

* ``mla_attention`` (prefill: per-head K/V expanded from the latent, scale
  1/sqrt(nope + rope)) within 1e-4·max|out| of JAX's, over several query
  and KV chunks;
* ``mla_decode`` (the absorbed form) step by step over a cache of 4 slots
  that wraps twice: every output within 1e-4·max|out|, and the cached
  latent ``c`` and rope key ``r`` and the lengths equal to JAX's cache,
  written in place;
* ``chunked_attention(causal=False)`` (whisper's encoder, cross-attention):
  every KV chunk visited, no mask, a value width other than the query's;
* deepseek-v2-lite-16b as a whole: ``loss_fn`` (with the MoE auxiliary
  loss) within 1e-5 relative of JAX's, and decode against the port's own
  forward at ``test_decode_consistency.py``'s bound (every expert at full
  capacity, as there).
"""
import dataclasses

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.attention import chunked_attention, mla_attention, mla_decode
from repro_torch.models.convert import params_from_jax

from test_torch_decode import check_decode_matches_own_forward, check_loss_matches_jax
from test_torch_models import REL, jax_params, port_config

ARCH = "deepseek-v2-lite-16b"


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max(), np.abs(got - want).max()


def mla_pair(seed, **changes):
    import jax

    jcfg, tree = jax_params(ARCH, seed=seed, **changes)
    cfg = port_config(ARCH, **changes)
    model = params_from_jax(cfg, tree, device="cpu")
    return jcfg, jax.tree.map(lambda a: a[0], tree["layers"]["attn"]), cfg, model.layers[0]["attn"]


def test_mla_attention_matches_jax():
    import jax
    import jax.numpy as jnp

    from repro.models import attention as JA

    jcfg, jp, cfg, p = mla_pair(60, q_chunk=8, kv_chunk=8)
    assert p["w_dkv"].shape == (cfg.d_model, cfg.mla_kv_lora + cfg.mla_rope_dim)
    x = np.random.default_rng(61).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24)
    want = jax.jit(lambda q, y: JA.mla_attention(q, y, jcfg, jnp.asarray(pos)))(jp, jnp.asarray(x))
    got = mla_attention(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    close(got.numpy(), want)


def test_mla_decode_over_a_wrapping_cache_matches_jax():
    import jax
    import jax.numpy as jnp

    from repro.models import attention as JA

    jcfg, jp, cfg, p = mla_pair(62)
    B, L, steps = 3, 4, 10
    rng = np.random.default_rng(63)
    xs = rng.standard_normal((steps, B, 1, cfg.d_model)).astype(np.float32)
    r, dr = cfg.mla_kv_lora, cfg.mla_rope_dim
    jcache = {"c": jnp.zeros((B, L, r)), "r": jnp.zeros((B, L, dr)),
              "len": jnp.zeros((B,), jnp.int32)}
    cache = {"c": torch.zeros((B, L, r)), "r": torch.zeros((B, L, dr)),
             "len": torch.zeros((B,), dtype=torch.int32)}
    c0 = cache["c"]
    step = jax.jit(lambda q, y, c: JA.mla_decode(q, y, jcfg, c))
    for t in range(steps):
        want, jcache = step(jp, jnp.asarray(xs[t]), jcache)
        got = mla_decode(p, torch.from_numpy(xs[t]), cfg, cache)
        close(got.numpy(), want)
    assert cache["c"] is c0 and cache["len"].tolist() == [steps] * B
    for k in ("c", "r"):
        close(cache[k].numpy(), jcache[k])
    np.testing.assert_array_equal(cache["len"].numpy(), np.asarray(jcache["len"]))


def test_non_causal_chunked_attention_matches_jax():
    import jax.numpy as jnp

    from repro.models import attention as JA

    rng = np.random.default_rng(64)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 30, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 30, 2, 12)).astype(np.float32)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                q_chunk=8, kv_chunk=10)
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False,
                            q_chunk=8, kv_chunk=10)
    close(got.numpy(), want)
    one = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False,
                            q_chunk=24, kv_chunk=30)
    assert np.abs(one.numpy() - got.numpy()).max() <= REL * np.abs(got.numpy()).max()


def test_deepseek_loss_matches_jax():
    cfg, _ = check_loss_matches_jax(ARCH, 65)
    assert cfg.attention == "mla" and cfg.n_routed_experts and cfg.moe_aux_weight > 0


def test_deepseek_decode_matches_own_forward():
    cfg = dataclasses.replace(port_config(ARCH, q_chunk=16, kv_chunk=16), moe_capacity_factor=8.0)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(66), device="cpu")
    check_decode_matches_own_forward(cfg, model, B=2, S=24, seed=67)
