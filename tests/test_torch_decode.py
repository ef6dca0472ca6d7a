"""The port's KV-cache decode against the JAX package and against its own forward.

* For each config, reduced and in float32, with the JAX parameters
  carried over by ``params_from_jax``: 12 steps of the port's
  ``make_serve_step`` (4 prompt tokens, then 8 greedy ones) against the
  jitted ``repro.models.model.decode_step`` (whisper's cross K/V left at
  the zeros of ``init_cache``, as JAX leaves them; the whisper tests fill
  them), with logits within
  1e-4·max|logits| and the same token at every step, at each config's
  published head layout on the reduced width and depth.
* The sliding-window ring buffer: ``sliding_window=8`` and a cache of 8
  slots over 20 steps, so that the ring wraps twice, against JAX.
* The port's decode against the port's forward, teacher-forced on the same
  tokens, at ``tests/test_decode_consistency.py``'s bound (max
  log-softmax error < 0.05, argmax equal everywhere), also with the
  window.
* In bf16, the five other families' decode strays from the float32
  forward no further than the JAX package's bf16 decode does (within
  ``BF16_STRAY`` times its median over positions of the max log-softmax
  error).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.train.step import make_serve_step

from test_torch_models import (REL, SERVED, batch_of, frames_of, head_layout, jax_params,
                               port_config)

PROMPT, GREEDY = 4, 8
BF16_STRAY = 1.5  # bf16 decode's distance from float32: the port's within this x JAX's


def jax_decode(jcfg, tree, B, cache_len, feed, frames=None):
    """Logits (B, steps, V) and tokens of the jitted JAX decode_step: step t
    reads ``feed[:, t]`` where given, else the argmax of step t-1. With
    ``frames`` (audio), the cache's cross K/V are filled by
    ``precompute_cross_kv`` first."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM

    step = jax.jit(lambda p, c, t: JM.decode_step(jcfg, p, c, t))
    cache = JM.init_cache(jcfg, B, cache_len)
    if frames is not None:
        cache = JM.precompute_cross_kv(jcfg, tree, cache, jnp.asarray(frames))
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


def port_decode(cfg, model, B, cache_len, feed, frames=None):
    """The same through the port's make_serve_step."""
    serve = make_serve_step(cfg)
    cache = M.init_cache(cfg, B, cache_len, device="cpu")
    if frames is not None:
        cache = M.precompute_cross_kv(cfg, model, cache, torch.from_numpy(frames))
    tok = torch.from_numpy(feed[:, :1])
    logits, toks = [], []
    for t in range(feed.shape[1]):
        if t and feed[0, t] >= 0:
            tok = torch.from_numpy(feed[:, t:t + 1])
        tok, out, cache = serve(model, cache, tok)
        logits.append(out[:, 0].float().numpy())
        toks.append(tok[:, 0].numpy())
    if cfg.family == "ssm":
        assert cache["len"].tolist() == [feed.shape[1]] * B
    else:
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


def true_log_softmax(x, vocab_real):
    x = x[..., :vocab_real].astype(np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen2-moe-a2.7b", "hymba-1.5b",
                                  "xlstm-125m", "whisper-tiny"])
def test_bf16_decode_strays_from_float32_no_further_than_jax(arch):
    """In bf16, the configs' own dtype, and on the same bf16 weights (MoE at
    full capacity): the port's teacher-forced decode stays within
    BF16_STRAY times the JAX decode's distance from the float32 forward on
    those weights, each the median over positions of the max log-softmax
    error. The median, since a router near-tie that bf16 flips at one
    position (in the port or in JAX, by the luck of rounding) moves that
    position by O(1); the bulk is the family's bf16 numerics."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.models import model as JM

    base = port_config(arch)
    changes = dict(n_layers=4) if base.family != "ssm" else {}
    if base.n_routed_experts:
        changes["moe_capacity_factor"] = float(base.n_routed_experts)
    jcfg32, tree = jax_params(arch, seed=27, **changes)
    jcfg = dataclasses.replace(jcfg32, param_dtype=jnp.bfloat16, act_dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k), jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a, s: np.asarray(a).astype(s.dtype), tree, shapes)
    tree32 = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), tree)
    cfg = port_config(arch, param_dtype=torch.bfloat16, act_dtype=torch.bfloat16, **changes)
    model = params_from_jax(cfg, tree, device="cpu")
    B, S = 2, 24
    tokens = np.random.default_rng(28).integers(0, cfg.vocab_real, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    frames = None
    if cfg.family == "audio":  # bf16-exact frames, the same for every run
        frames = frames_of(cfg, B, 29).astype(ml_dtypes.bfloat16).astype(np.float32)
        batch["frames"] = jnp.asarray(frames)
    full = np.asarray(jax.jit(lambda p, b: JM.forward(jcfg32, p, b))(tree32, batch))
    want, _ = jax_decode(jcfg, tree, B, S, tokens, frames=frames)
    got, _ = port_decode(cfg, model, B, S, tokens, frames=frames)
    ref = true_log_softmax(full, cfg.vocab_real)
    e_jax = np.median(np.abs(true_log_softmax(want, cfg.vocab_real) - ref).max(-1))
    e_port = np.median(np.abs(true_log_softmax(got, cfg.vocab_real) - ref).max(-1))
    assert e_port <= BF16_STRAY * e_jax, (e_port, e_jax)


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


# --------------------------------------------------------------------------
# helpers of the families' test files (test_torch_moe / _mla / _recurrent / _whisper)
# --------------------------------------------------------------------------
def check_decode_matches_own_forward(cfg, model, B, S, seed, frames=None):
    """Teacher-forced decode of S seeded tokens against the port's forward
    over them, at test_decode_consistency's bound; whisper's cache filled by
    precompute_cross_kv from ``frames``."""
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_real, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    with torch.no_grad():
        full = M.forward(cfg, model, batch).numpy()
    got, _ = port_decode(cfg, model, B, S, tokens, frames=frames)
    assert log_softmax_err(got, full, cfg.vocab_real) < 0.05
    np.testing.assert_array_equal(got[..., :cfg.vocab_real].argmax(-1),
                                  full[..., :cfg.vocab_real].argmax(-1))


def check_loss_matches_jax(arch, seed, B=2, S=24, **changes):
    """``loss_fn`` of the port within 1e-5 relative of the JAX package's, on
    the same parameters and a seeded batch with labels."""
    import jax.numpy as jnp

    from repro.models import model as JM

    jcfg, tree = jax_params(arch, seed=seed, **changes)
    cfg = port_config(arch, **changes)
    model = params_from_jax(cfg, tree, device="cpu")
    batch = batch_of(cfg, B, S, seed + 1)
    batch["labels"] = np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_real, (B, S)).astype(np.int32)
    want = float(JM.loss_fn(jcfg, tree, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(M.loss_fn(cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    return cfg, model
