"""The port's whisper encoder-decoder (``repro_torch.models.model``) against
the JAX package.

Reduced whisper-tiny in float32 (24 seeded frame embeddings, the JAX
stub's input), the JAX parameters carried over by ``params_from_jax``:

* ``precompute_cross_kv`` (the bidirectional encoder, then every decoder
  layer's cross K/V), over several query and KV chunks: within
  1e-4·max|.| of JAX's, written into the cache in place; a cache without
  cross K/V of the encoder's shape is refused;
* 12 serve steps after ``precompute_cross_kv`` against the jitted JAX
  ``decode_step``: logits within 1e-4·max|logits|, the same tokens;
* the reference quirk kept: without ``precompute_cross_kv`` the cache's
  cross K/V are the zeros of ``init_cache``, decode attends to them and
  ignores ``frames`` (as JAX does, token for token), so its logits differ
  from the filled cache's; with no cross K/V in the cache at all, decode
  encodes ``frames`` at every step and agrees with the filled cache;
* decode against the port's own forward at ``test_decode_consistency.py``'s
  bound, and ``loss_fn`` within 1e-5 relative of JAX's.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.train.step import make_serve_step

from test_torch_decode import (GREEDY, PROMPT, assert_decode_close,
                               check_decode_matches_own_forward, check_loss_matches_jax,
                               jax_decode, port_decode, prompt_then_greedy)
from test_torch_models import REL, frames_of, jax_params, port_config

ARCH = "whisper-tiny"


def pair(seed, **changes):
    jcfg, tree = jax_params(ARCH, seed=seed, **changes)
    cfg = port_config(ARCH, **changes)
    return jcfg, tree, cfg, params_from_jax(cfg, tree, device="cpu")


def test_precompute_cross_kv_matches_jax():
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM

    jcfg, tree, cfg, model = pair(90, q_chunk=8, kv_chunk=8)
    frames = frames_of(cfg, 2, 91)
    want = jax.jit(lambda p, c, f: JM.precompute_cross_kv(jcfg, p, c, f))(
        tree, JM.init_cache(jcfg, 2, 16), jnp.asarray(frames))
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    k0 = cache["cross_k"]
    got = M.precompute_cross_kv(cfg, model, cache, torch.from_numpy(frames))
    assert got is cache and got["cross_k"] is k0
    assert k0.shape == (cfg.n_layers, 2, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    for k in ("cross_k", "cross_v"):
        w = np.asarray(want[k])
        assert np.abs(got[k].numpy() - w).max() <= REL * np.abs(w).max(), k


def test_precompute_cross_kv_refuses_a_cache_of_another_shape():
    cfg = port_config(ARCH)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(102), device="cpu")
    short = torch.from_numpy(frames_of(cfg, 2, 103)[:, :-1])  # one frame fewer
    with torch.no_grad():
        with pytest.raises(ValueError, match="cross_k"):
            M.precompute_cross_kv(cfg, model, M.init_cache(cfg, 2, 16, device="cpu"), short)
        cache = M.init_cache(cfg, 2, 16, device="cpu")
        del cache["cross_k"], cache["cross_v"]
        with pytest.raises(ValueError, match="cross_k"):
            M.precompute_cross_kv(cfg, model, cache, torch.from_numpy(frames_of(cfg, 2, 103)))


def test_serve_steps_after_precompute_match_jax():
    jcfg, tree, cfg, model = pair(92)
    frames = frames_of(cfg, 2, 93)
    feed = prompt_then_greedy(cfg, B=2, prompt=PROMPT, greedy=GREEDY, seed=94)
    want = jax_decode(jcfg, tree, 2, 16, feed, frames=frames)
    got = port_decode(cfg, model, 2, 16, feed, frames=frames)
    assert_decode_close(got, want, cfg.vocab_real)


def test_decode_without_precompute_attends_to_zeros_as_jax():
    jcfg, tree, cfg, model = pair(95)
    frames = torch.from_numpy(frames_of(cfg, 2, 96))
    feed = prompt_then_greedy(cfg, B=2, prompt=PROMPT, greedy=0, seed=97)
    serve = make_serve_step(cfg)

    def run(cache, **kw):
        out = []
        for t in range(feed.shape[1]):
            _, logits, cache = serve(model, cache, torch.from_numpy(feed[:, t:t + 1]), **kw)
            out.append(logits[:, 0].numpy())
        return np.stack(out, 1)

    zeros = run(M.init_cache(cfg, 2, 16, device="cpu"), frames=frames)  # frames ignored
    assert np.array_equal(zeros, run(M.init_cache(cfg, 2, 16, device="cpu")))
    want, _ = jax_decode(jcfg, tree, 2, 16, feed)  # JAX's init_cache: zero cross K/V too
    assert np.abs(zeros - want).max() <= REL * np.abs(want).max()
    filled = run(M.precompute_cross_kv(cfg, model, M.init_cache(cfg, 2, 16, device="cpu"),
                                       frames))
    assert np.abs(filled - zeros).max() > 1e-3 * np.abs(zeros).max()
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    del cache["cross_k"], cache["cross_v"]  # no cross K/V: the encoder runs at every step
    per_step = run(cache, frames=frames)
    assert np.abs(per_step - filled).max() <= REL * np.abs(filled).max()


def test_decode_matches_own_forward():
    cfg = port_config(ARCH, q_chunk=16, kv_chunk=16)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(98), device="cpu")
    check_decode_matches_own_forward(cfg, model, B=2, S=24, seed=99, frames=frames_of(cfg, 2, 100))


def test_loss_matches_jax():
    check_loss_matches_jax(ARCH, 101)
