"""The port's KV-cache decode against the JAX package and against its own forward.

* For each dense or vlm config, reduced and in float32, with the JAX
  parameters carried over by ``params_from_jax``: 12 steps of the port's
  ``make_serve_step`` (4 prompt tokens, then 8 greedy ones) against the
  jitted ``repro.models.model.decode_step``, with logits within
  1e-4·max|logits| and the same token at every step, at each config's
  published head layout on the reduced width and depth.
* The sliding-window ring buffer: ``sliding_window=8`` and a cache of 8
  slots over 20 steps, so that the ring wraps twice, against JAX.
* The port's decode against the port's forward, teacher-forced on the same
  tokens, at ``tests/test_decode_consistency.py``'s bound (max
  log-softmax error < 0.05, argmax equal everywhere), also with the
  window.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.train.step import make_serve_step

from test_torch_models import REL, SERVED, head_layout, jax_params, port_config

PROMPT, GREEDY = 4, 8


def jax_decode(jcfg, tree, B, cache_len, feed):
    """Logits (B, steps, V) and tokens of the jitted JAX decode_step: step t
    reads ``feed[:, t]`` where given, else the argmax of step t-1."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM

    step = jax.jit(lambda p, c, t: JM.decode_step(jcfg, p, c, t))
    cache = JM.init_cache(jcfg, B, cache_len)
    tok = jnp.asarray(feed[:, :1])
    logits, toks = [], []
    for t in range(feed.shape[1]):
        if t and feed[0, t] >= 0:
            tok = jnp.asarray(feed[:, t:t + 1])
        out, cache = step(tree, cache, tok)
        logits.append(np.asarray(out[:, 0], np.float32))
        tok = jnp.argmax(out[..., :jcfg.vocab_real], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok)[:, 0])
    return np.stack(logits, 1), np.stack(toks, 1)


def port_decode(cfg, model, B, cache_len, feed):
    """The same through the port's make_serve_step."""
    serve = make_serve_step(cfg)
    cache = M.init_cache(cfg, B, cache_len, device="cpu")
    tok = torch.from_numpy(feed[:, :1])
    logits, toks = [], []
    for t in range(feed.shape[1]):
        if t and feed[0, t] >= 0:
            tok = torch.from_numpy(feed[:, t:t + 1])
        tok, out, cache = serve(model, cache, tok)
        logits.append(out[:, 0].float().numpy())
        toks.append(tok[:, 0].numpy())
    assert cache["kv"]["len"].tolist() == [[feed.shape[1]] * B] * cfg.n_layers
    return np.stack(logits, 1), np.stack(toks, 1)


def prompt_then_greedy(cfg, B, prompt, greedy, seed):
    """Token feed: ``prompt`` seeded tokens, then -1 (greedy) ``greedy`` times."""
    feed = np.full((B, prompt + greedy), -1, np.int32)
    feed[:, :prompt] = np.random.default_rng(seed).integers(0, cfg.vocab_real, (B, prompt))
    return feed


def assert_decode_close(got, want, vocab_real):
    (gl, gt), (wl, wt) = got, want
    assert np.abs(gl - wl).max() <= REL * np.abs(wl).max(), np.abs(gl - wl).max()
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gl[..., :vocab_real].argmax(-1), wt)


@pytest.mark.parametrize("arch", SERVED)
def test_serve_steps_match_jax_decode(arch):
    changes = head_layout(arch)
    jcfg, tree = jax_params(arch, seed=20, **changes)
    cfg = port_config(arch, **changes)
    model = params_from_jax(cfg, tree, device="cpu")
    feed = prompt_then_greedy(cfg, B=2, prompt=PROMPT, greedy=GREEDY, seed=21)
    assert_decode_close(port_decode(cfg, model, 2, 16, feed),
                        jax_decode(jcfg, tree, 2, 16, feed), cfg.vocab_real)


@pytest.mark.parametrize("arch", ["smollm-135m", "starcoder2-15b"])
def test_sliding_window_ring_buffer_wraps_as_jax(arch):
    changes = dict(sliding_window=8)
    jcfg, tree = jax_params(arch, seed=22, **changes)
    cfg = port_config(arch, **changes)
    model = params_from_jax(cfg, tree, device="cpu")
    feed = prompt_then_greedy(cfg, B=3, prompt=20, greedy=0, seed=23)
    assert_decode_close(port_decode(cfg, model, 3, 8, feed),
                        jax_decode(jcfg, tree, 3, 8, feed), cfg.vocab_real)


def log_softmax_err(got, want, vocab_real):
    def lsm(x):
        x = x[..., :vocab_real]
        return x - np.max(x, axis=-1, keepdims=True)

    return np.max(np.abs(lsm(got) - lsm(want)))


@pytest.mark.parametrize("arch,window", [("smollm-135m", None), ("qwen1.5-0.5b", None),
                                         ("stablelm-12b", None), ("smollm-135m", 8)])
def test_decode_matches_own_forward(arch, window):
    cfg = port_config(arch, q_chunk=16, kv_chunk=16, sliding_window=window)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(24), device="cpu")
    B, S = 2, 40
    tokens = np.random.default_rng(25).integers(0, cfg.vocab_real, (B, S)).astype(np.int32)
    with torch.no_grad():
        full = M.forward(cfg, model, {"tokens": torch.from_numpy(tokens)}).numpy()
    got, _ = port_decode(cfg, model, B, window or S, tokens)
    assert log_softmax_err(got, full, cfg.vocab_real) < 0.05
    np.testing.assert_array_equal(got[..., :cfg.vocab_real].argmax(-1),
                                  full[..., :cfg.vocab_real].argmax(-1))


def test_decode_writes_the_cache_in_place():
    cfg = dataclasses.replace(port_config("smollm-135m"), sliding_window=4)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(26), device="cpu")
    cache = M.init_cache(cfg, 2, 4, device="cpu")
    k = cache["kv"]["k"]
    serve = make_serve_step(cfg)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for step in range(6):
        tok, logits, out = serve(model, cache, tok)
        assert out is cache and out["kv"]["k"] is k
        written = (k[0].abs().sum(dim=(-1, -2)) != 0).sum(dim=1)
        assert written.tolist() == [min(step + 1, 4)] * 2
        assert logits.shape == (2, 1, cfg.vocab) and tok.dtype == torch.int32
        assert int(tok.max()) < cfg.vocab_real
