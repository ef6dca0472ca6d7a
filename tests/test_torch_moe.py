"""The port's Mixture-of-Experts (``repro_torch.models.ffn``) against the JAX package.

Reduced configs in float32, the JAX parameters carried over by
``params_from_jax``:

* Routing: ``_route_group`` on tokens that contend for one slot (capacity
  1, two identical tokens): the tokens per slot, the sorted tokens, which
  assignments are kept and their slots equal JAX's exactly, the weights
  within 1e-6; the later contender in the stable sort is the one dropped.
* ``moe_ffn`` within 1e-4·max|out| of JAX's, at a prefill and a decode
  shape and with capacity dropping, for deepseek's reduced layer (a shared
  expert, normalized top-k) and qwen2-moe's with 6 experts padded to 8
  (unnormalized); ``moe_aux_loss`` within 1e-5 relative.
* The combine adds each token's contributions in the sorted order from
  zero: bitwise in bf16 against a sequential scatter-add loop.
* qwen2-moe-a2.7b as a whole: ``loss_fn`` (with the auxiliary loss) within
  1e-5 relative of JAX's; decode against the port's own forward at
  ``test_decode_consistency.py``'s bound, with every expert at full
  capacity as there (capacity dropping depends on the batch's make-up).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.models.convert import params_from_jax
from repro_torch.models.ffn import _combine, _route_group, capacity, moe_aux_loss, moe_ffn

from test_torch_decode import check_decode_matches_own_forward, check_loss_matches_jax
from test_torch_models import REL, jax_params, port_config

ARCHS = ["deepseek-v2-lite-16b", "qwen2-moe-a2.7b"]
# qwen2-moe's reduced layer gets 6 experts, padded to 8 (as its 60 pad to 64)
CHANGES = {"deepseek-v2-lite-16b": {}, "qwen2-moe-a2.7b": dict(n_routed_experts=6)}


@functools.lru_cache(maxsize=None)
def _pair(arch):
    import jax

    jcfg, tree = jax_params(arch, seed=40, **CHANGES[arch])
    cfg = port_config(arch, **CHANGES[arch])
    model = params_from_jax(cfg, tree, device="cpu")
    return jcfg, jax.tree.map(lambda a: a[0], tree["layers"]["moe"]), cfg, model.layers[0]["moe"]


def moe_pair(arch, **changes):
    """(jcfg, JAX layer-0 MoE params, cfg, the port's layer-0 MoE params)
    of the reduced ``arch``, the configs with ``changes`` that keep the
    parameters' shapes."""
    jcfg, jp, cfg, p = _pair(arch)
    return dataclasses.replace(jcfg, **changes), jp, dataclasses.replace(cfg, **changes), p


def test_padded_experts_are_never_routed():
    _, _, cfg, p = moe_pair("qwen2-moe-a2.7b")
    assert p["gate"].shape[1] == 8 and p["w_gate"].shape[0] == 8
    xt = torch.from_numpy(np.random.default_rng(41).standard_normal((64, cfg.d_model))
                          .astype(np.float32))
    _, _, _, keep, slot = _route_group(xt, p["gate"], cfg, 64)
    assert bool(keep.all()) and int(slot.max()) < 6 * 64  # experts 6 and 7 hold nothing


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_drops_the_same_assignments_as_jax(arch):
    import jax.numpy as jnp

    from repro.models import ffn as JF

    jcfg, jp, cfg, p = moe_pair(arch)
    rng = np.random.default_rng(43)
    xt = rng.standard_normal((6, cfg.d_model)).astype(np.float32)
    xt[3] = xt[0]  # tokens 0 and 3 pick the same experts and contend for their one slot
    want = JF._route_group(jnp.asarray(xt), jp["gate"], jcfg, 1)
    got = _route_group(torch.from_numpy(xt), p["gate"], cfg, 1)
    for name, g, w in zip(("tok_for_slot", "sorted_t", "sorted_w", "keep", "slot"), got, want):
        w = np.asarray(w)
        if name == "sorted_w":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    tok, sorted_t, _, keep, _ = got
    K = cfg.moe_top_k
    assert int(keep.sum()) < 6 * K  # some assignments are dropped
    kept_tokens = set(tok[tok < 6].tolist())
    assert 0 in kept_tokens and sorted_t[~keep].eq(3).any()  # token 3, the later one, loses


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,cf", [((2, 8), 1.25), ((4, 1), 1.25), ((3, 8), 0.25)])
def test_moe_ffn_matches_jax(arch, shape, cf):
    import jax
    import jax.numpy as jnp

    from repro.models import ffn as JF

    jcfg, jp, cfg, p = moe_pair(arch, moe_capacity_factor=cf)
    x = np.random.default_rng(45).standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    want = np.asarray(jax.jit(lambda q, y: JF.moe_ffn(q, y, jcfg))(jp, jnp.asarray(x)))
    got = moe_ffn(p, torch.from_numpy(x), cfg).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    assert capacity(cfg, shape[0] * shape[1]) == max(
        int(np.ceil(shape[0] * shape[1] * cfg.moe_top_k / 8 * cf)), 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_jax(arch):
    import jax.numpy as jnp

    from repro.models import ffn as JF

    jcfg, jp, cfg, p = moe_pair(arch)
    x = np.random.default_rng(47).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want = float(JF.moe_aux_loss(jp, jnp.asarray(x), jcfg))
    got = float(moe_aux_loss(p, torch.from_numpy(x), cfg))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_combine_adds_in_sorted_order_in_bf16():
    rng = np.random.default_rng(48)
    T, K, d = 5, 3, 16
    sorted_t = torch.from_numpy(rng.permutation(np.repeat(np.arange(T), K)))
    y_assign = torch.from_numpy(rng.standard_normal((T * K, d)).astype(np.float32) * 3)
    y_assign = y_assign.to(torch.bfloat16)
    want = torch.zeros((T, d), dtype=torch.bfloat16)
    for i, t in enumerate(sorted_t.tolist()):  # zeros.at[sorted_t].add, one update at a time
        want[t] = want[t] + y_assign[i]
    got = _combine(y_assign, sorted_t, T, K)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_qwen2_moe_loss_matches_jax():
    cfg, _ = check_loss_matches_jax("qwen2-moe-a2.7b", 49, **CHANGES["qwen2-moe-a2.7b"])
    assert cfg.moe_aux_weight > 0


def test_qwen2_moe_decode_matches_own_forward():
    cfg = dataclasses.replace(port_config("qwen2-moe-a2.7b", q_chunk=16, kv_chunk=16),
                              moe_capacity_factor=8.0)
    from repro_torch.models import model as M

    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(50), device="cpu")
    check_decode_matches_own_forward(cfg, model, B=2, S=24, seed=51)
