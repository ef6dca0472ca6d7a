"""The port's recurrent blocks (``repro_torch.models.ssm``, ``.xlstm``)
against the JAX package.

Reduced configs in float32, the JAX parameters carried over by
``params_from_jax`` (``a_log``, ``d_skip`` and ``dt_bias`` drawn around
their init values):

* hymba's mamba branch, ``ssm_forward``, from a zero state and from a
  seeded state (the conv state and h): output and new state within
  1e-4·max|.| of JAX's; the scan in many time blocks against one block;
  ``ssm_decode`` writes the state in place.
* xLSTM's ``mlstm_forward`` and ``slstm_forward``, from zero and from a
  seeded state (C, n, m / c, n, h, m): the same bound on output and state.
* hymba-1.5b and xlstm-125m as a whole: ``loss_fn`` within 1e-5 relative
  of JAX's, decode against the port's own forward at
  ``test_decode_consistency.py``'s bound, and the float32 leaves of a bf16
  hymba staying float32.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.ssm import init_ssm_state, ssm_decode, ssm_forward
from repro_torch.models.xlstm import mlstm_forward, slstm_forward

from test_torch_decode import check_decode_matches_own_forward, check_loss_matches_jax
from test_torch_models import REL, jax_params, port_config


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max(), np.abs(got - want).max()


def seeded_state(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_forward_matches_jax(with_state):
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as JS

    jcfg, tree = jax_params("hymba-1.5b", seed=70)
    cfg = port_config("hymba-1.5b")
    p = params_from_jax(cfg, tree, device="cpu").layers[1]["ssm"]
    jp = jax.tree.map(lambda a: a[1], tree["layers"]["ssm"])
    B, S, di, N = 2, 12, cfg.ssm_inner, cfg.ssm_state
    x = np.random.default_rng(71).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jstate = state = None
    if with_state:
        h, conv = seeded_state([(B, di, N), (B, 3, di)], 72)
        jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        state = {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}
    want, wst = jax.jit(lambda q, y, s: JS.ssm_forward(q, y, jcfg, state=s))(
        jp, jnp.asarray(x), jstate)
    got, gst = ssm_forward(p, torch.from_numpy(x), cfg, state=state)
    close(got.numpy(), want)
    close(gst["h"].numpy(), wst["h"])
    np.testing.assert_array_equal(gst["conv"].numpy(), np.asarray(wst["conv"]))


def test_ssm_scan_in_time_blocks_matches_one_block(monkeypatch):
    """A sequence of many scan blocks (the last one short) gives what one
    block over the whole sequence gives, output and state."""
    from repro_torch.models import ssm as S_

    cfg = port_config("hymba-1.5b")
    p = M.Transformer(cfg, generator=torch.Generator().manual_seed(79), device="cpu").layers[0]
    p = p["ssm"]
    B, S, di, N = 2, 23, cfg.ssm_inner, cfg.ssm_state
    x = torch.from_numpy(np.random.default_rng(80).standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))
    h, conv = seeded_state([(B, di, N), (B, 3, di)], 81)
    runs = []
    for block in (S, 5):
        monkeypatch.setattr(S_, "SCAN_BLOCK", block)
        with torch.no_grad():
            runs.append(ssm_forward(p, x, cfg, state={"h": torch.from_numpy(h),
                                                      "conv": torch.from_numpy(conv)}))
    (want, wst), (got, gst) = runs
    close(got.numpy(), want.numpy())
    close(gst["h"].numpy(), wst["h"].numpy())
    np.testing.assert_array_equal(gst["conv"].numpy(), wst["conv"].numpy())


def test_ssm_decode_steps_match_forward_and_write_in_place():
    cfg = port_config("hymba-1.5b")
    p = M.Transformer(cfg, generator=torch.Generator().manual_seed(73), device="cpu").layers[0]
    p = p["ssm"]
    x = torch.from_numpy(np.random.default_rng(74).standard_normal((2, 6, cfg.d_model))
                         .astype(np.float32))
    with torch.no_grad():
        full, fst = ssm_forward(p, x, cfg)
        state = init_ssm_state(cfg, 2, "cpu")
        h0 = state["h"]
        steps = [ssm_decode(p, x[:, t:t + 1], cfg, state) for t in range(6)]
    assert state["h"] is h0 and state["conv"].dtype == cfg.param_dtype
    close(torch.cat(steps, 1).numpy(), full.numpy())
    close(state["h"].numpy(), fst["h"].numpy())


@pytest.mark.parametrize("kind", ["m", "s"])
@pytest.mark.parametrize("with_state", [False, True])
def test_xlstm_blocks_match_jax(kind, with_state):
    import jax
    import jax.numpy as jnp

    from repro.models import xlstm as JX

    jcfg, tree = jax_params("xlstm-125m", seed=75)
    cfg = port_config("xlstm-125m")
    i = cfg.block_types.index(kind)
    p = params_from_jax(cfg, tree, device="cpu").blocks[i]
    jp = tree["blocks"][i]
    B, S, d, H = 2, 10, cfg.d_model, cfg.n_heads
    hd = 2 * d // H
    x = np.random.default_rng(76).standard_normal((B, S, d)).astype(np.float32)
    shapes = [(B, H, hd, hd), (B, H, hd), (B, H)] if kind == "m" else [(B, d)] * 4
    st = seeded_state(shapes, 77) if with_state else None
    jfn, fn = (JX.mlstm_forward, mlstm_forward) if kind == "m" else (JX.slstm_forward,
                                                                      slstm_forward)
    want, wst = jax.jit(lambda q, y, s: jfn(q, y, jcfg, state=s))(
        jp, jnp.asarray(x), None if st is None else tuple(jnp.asarray(a) for a in st))
    got, gst = fn(p, torch.from_numpy(x), cfg,
                  state=None if st is None else tuple(torch.from_numpy(a) for a in st))
    close(got.numpy(), want)
    assert len(gst) == len(wst)
    for g, w in zip(gst, wst):
        close(g.numpy(), w)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_loss_matches_jax(arch):
    check_loss_matches_jax(arch, 78)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_decode_matches_own_forward(arch):
    cfg = port_config(arch, q_chunk=16, kv_chunk=16)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(79), device="cpu")
    check_decode_matches_own_forward(cfg, model, B=2, S=24, seed=80)


def test_bf16_hymba_keeps_its_float32_leaves():
    cfg = port_config("hymba-1.5b", param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(81), device="cpu")
    ssm = model.layers[0]["ssm"]
    assert {k: ssm[k].dtype for k in ("a_log", "d_skip", "dt_bias")} == dict.fromkeys(
        ("a_log", "d_skip", "dt_bias"), torch.float32)
    assert ssm["in_proj"].dtype == torch.bfloat16
    N = cfg.ssm_state
    assert torch.equal(ssm["a_log"][0], torch.log(torch.arange(1, N + 1, dtype=torch.float32)))
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    assert cache["ssm"]["h"].dtype == torch.float32
    assert cache["ssm"]["conv"].dtype == torch.bfloat16
    logits, _ = M.decode_step(cfg, model, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
