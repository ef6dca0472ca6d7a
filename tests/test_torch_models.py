"""The port's model scaffolding (``repro_torch.models``) against the JAX package.

For each config, reduced and in float32, the JAX parameters
are carried over by ``params_from_jax`` (with the biases and the norms'
scales drawn at random, so that those paths count) and the port's
``forward`` is held to ``repro.models.model.forward``: logits within
1e-4·max|logits| and the same argmax over ``vocab_real``, at each
config's published head layout (smollm's 9:3, starcoder2's 48:4,
stablelm's heads of 160) on the reduced width and depth. Also: the
configs and their parameter counts equal the JAX package's, a bf16 tree
crosses over bit for bit, and (on a GPU) the card's logits equal the
CPU's within the same bound. Every config of ``repro_torch.configs`` is
served; whisper's batches carry seeded frame embeddings.

JAX is imported inside the helpers, so the ``cuda`` test runs where JAX is
not installed.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.train.step import make_prefill_step

SERVED = list(ARCHS)
REL = 1e-4  # logits within REL·max|logits|
ONES = ("norm", "kv_norm", "d_skip")  # 1-D leaves that init_params sets to ones
ZEROS = ("dt_bias",)  # and to zeros


def head_layout(arch):
    """The published head layout that ``reduced()`` replaces with 4:2 or
    4:4 heads of 16 (smollm's 9:3, starcoder2's 48:4, stablelm's heads of
    160, ...); the parity tests put it back on the reduced width and depth."""
    c = get_config(arch)
    return dict(n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, head_dim=c.head_dim)


def jax_params(arch, seed=0, **changes):
    """The JAX package's parameters of the reduced ``arch``: numpy leaves in
    the tree ``repro.models.model.init_params`` makes (its shapes, traced
    and not compiled), drawn from ``seed`` at init's scales, with every
    bias and norm parameter drawn too; and its config."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import model as JM

    jcfg = dataclasses.replace(jax_config(arch).reduced(), **changes)
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1].key)
        z = rng.standard_normal(s.shape)
        if name in ("scale", "bias", "bq", "bk", "bv") + ONES + ZEROS:
            a = (1.0 if name in ("scale",) + ONES else 0.0) + 0.1 * z
        elif name == "a_log":  # the SSM's log decay rates, log 1..N per channel
            a = np.log(np.arange(1, s.shape[-1] + 1)) + 0.1 * z
        else:
            a = z * (0.02 if name == "embed" else 1.0 / np.sqrt(s.shape[-2]))
        return a.astype(s.dtype)

    return jcfg, jax.tree_util.tree_map_with_path(draw, shapes)


def port_config(arch, **changes):
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def frames_of(cfg, B, seed):
    """Seeded stand-ins for whisper's precomputed frame embeddings."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)


def batch_of(cfg, B, S, seed, vision=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_real, (B, S)).astype(np.int32)}
    if cfg.family == "vlm" and vision:
        batch["vision_embeds"] = (rng.standard_normal((B, cfg.vision_patches, cfg.d_model))
                                  * 0.02).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = frames_of(cfg, B, seed + 1000)
    return batch


def jax_forward(jcfg, tree, batch):
    import jax.numpy as jnp

    from repro.models import model as JM

    return np.asarray(JM.forward(jcfg, tree, {k: jnp.asarray(v) for k, v in batch.items()}))


def port_forward(cfg, model, batch):
    with torch.no_grad():
        out = M.forward(cfg, model, {k: torch.from_numpy(v).to(model.device)
                                     for k, v in batch.items()})
    return out.float().cpu().numpy()


def assert_logits_close(got, want, vocab_real):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())
    np.testing.assert_array_equal(got[..., :vocab_real].argmax(-1),
                                  want[..., :vocab_real].argmax(-1))


@pytest.mark.parametrize("arch,vision", [(a, False) for a in SERVED]
                         + [("llava-next-mistral-7b", True)])
def test_forward_matches_jax(arch, vision):
    changes = head_layout(arch)
    jcfg, tree = jax_params(arch, **changes)
    cfg = port_config(arch, **changes)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (
        jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim) == tuple(changes.values())
    model = params_from_jax(cfg, tree, device="cpu")
    batch = batch_of(cfg, B=2, S=48, seed=1, vision=vision)
    want = jax_forward(jcfg, tree, batch)
    got = port_forward(cfg, model, batch)
    assert got.shape == (2, 48, cfg.vocab)
    assert_logits_close(got, want, cfg.vocab_real)


@pytest.mark.parametrize("arch", ["smollm-135m", "starcoder2-15b"])
def test_forward_with_window_and_several_chunks_matches_jax(arch):
    changes = dict(q_chunk=8, kv_chunk=16, sliding_window=12)
    jcfg, tree = jax_params(arch, seed=3, **changes)
    cfg = port_config(arch, **changes)
    model = params_from_jax(cfg, tree, device="cpu")
    batch = batch_of(cfg, B=2, S=48, seed=4)
    assert_logits_close(port_forward(cfg, model, batch), jax_forward(jcfg, tree, batch),
                        cfg.vocab_real)


def test_prefill_step_is_the_last_position_of_forward():
    jcfg, tree = jax_params("qwen1.5-0.5b", seed=5)
    cfg = port_config("qwen1.5-0.5b")
    model = params_from_jax(cfg, tree, device="cpu")
    batch = batch_of(cfg, B=3, S=20, seed=6)
    last = make_prefill_step(cfg)(model, {"tokens": torch.from_numpy(batch["tokens"])})
    full = port_forward(cfg, model, batch)
    assert np.array_equal(last.numpy().view(np.int32), full[:, -1].view(np.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_equal_jax(arch):
    from repro.configs import get_config as jax_config

    want, got = jax_config(arch), get_config(arch)
    assert got.param_count() == want.param_count()
    assert got.reduced().param_count() == want.reduced().param_count()
    for f in dataclasses.fields(got):
        if f.name in ("param_dtype", "act_dtype"):
            assert str(getattr(got, f.name)).split(".")[-1] == np.dtype(
                getattr(want, f.name)).name
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.vocab, got.cache_len("decode_32k")) == (want.vocab, want.cache_len("decode_32k"))


def test_model_holds_every_parameter_of_init_params():
    cfg = port_config("starcoder2-15b")
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    n = sum(p.numel() for p in model.parameters())
    biases_and_norms = cfg.n_layers * (2 * 2 * cfg.d_model + cfg.d_head_total
                                       + 2 * cfg.n_kv_heads * cfg.head_dim) + 2 * cfg.d_model
    assert n == cfg.param_count()["total"] + biases_and_norms
    assert not any(p.requires_grad for p in model.parameters())
    again = M.Transformer(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_bf16_tree_crosses_bit_for_bit():
    import jax
    import ml_dtypes

    _, tree = jax_params("smollm-135m", seed=7)
    tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    cfg = port_config("smollm-135m", param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    model = params_from_jax(cfg, tree, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert np.array_equal(model.embed.view(torch.int16).numpy(),
                          tree["embed"].view(np.int16))
    for i, lp in enumerate(model.layers):
        for group in ("attn", "mlp", "attn_norm", "mlp_norm"):
            for k, t in lp[group].items():
                want = tree["layers"][group][k][i].view(np.int16)
                assert np.array_equal(t.view(torch.int16).numpy(), want), (i, group, k)
    t = tensor_from_numpy(np.array([1.0, -2.5, 3e-40], dtype=ml_dtypes.bfloat16))  # a subnormal
    assert t.dtype == torch.bfloat16 and t.view(torch.int16).tolist() == [16256, -16352, 3]


def test_params_from_jax_refuses_a_tree_of_another_shape():
    _, tree = jax_params("smollm-135m", seed=8)
    with pytest.raises(ValueError, match="leading axis"):
        params_from_jax(port_config("smollm-135m", n_layers=3), tree, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        params_from_jax(port_config("smollm-135m", d_ff=64), tree, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(port_config("smollm-135m", tie_embeddings=False), tree, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        params_from_jax(port_config("smollm-135m", param_dtype=torch.bfloat16), tree,
                        device="cpu")


def test_model_needs_a_generator_or_params():
    cfg = port_config("smollm-135m")
    with pytest.raises(ValueError, match="Generator"):
        M.Transformer(cfg, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "starcoder2-15b"])
def test_card_logits_equal_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = port_config(arch)
    cpu = M.Transformer(cfg, generator=torch.Generator().manual_seed(11), device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    batch = batch_of(cfg, B=2, S=40, seed=12)
    want = port_forward(cfg, cpu, batch)
    got = port_forward(cfg, card, batch)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen2-moe-a2.7b", "hymba-1.5b",
                                  "whisper-tiny", "xlstm-125m"])
def test_card_equals_cpu_for_the_other_families(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    from repro_torch.train.step import make_serve_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = port_config(arch)
    cpu = M.Transformer(cfg, generator=torch.Generator().manual_seed(13), device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    batch = batch_of(cfg, B=2, S=40, seed=14)
    want = port_forward(cfg, cpu, batch)
    got = port_forward(cfg, card, batch)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    serve = make_serve_step(cfg)
    logits = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        cache = M.init_cache(cfg, 2, 16, device=dev)
        if cfg.family == "audio":
            cache = M.precompute_cross_kv(cfg, model, cache,
                                          torch.from_numpy(batch["frames"]).to(dev))
        out = []
        for t in range(8):
            _, lg, cache = serve(model, cache, torch.from_numpy(batch["tokens"][:, t:t + 1])
                                 .to(dev))
            out.append(lg.float().cpu())
        logits.append(torch.stack(out).numpy())
    assert np.abs(logits[1] - logits[0]).max() <= REL * np.abs(logits[0]).max()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "hymba-1.5b", "whisper-tiny",
                                  "xlstm-125m"])
def test_family_trees_cross_both_ways(arch):
    """The E-leading MoE leaves, the ``blocks`` list, the stacked encoder and
    mixed-dtype leaves: a bf16 JAX tree (float32 leaves kept float32) into
    the port and back, keyed in JAX's flatten order, bit for bit."""
    import jax
    import ml_dtypes

    from repro_torch.models.convert import (keyed_leaves, param_tree, tree_to_jax,
                                            unflatten_keyed)

    _, tree = jax_params(arch, seed=15)
    f32 = ("gate", "a_log", "d_skip", "dt_bias")  # float32 leaves of a bf16 model
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a if str(path[-1].key) in f32 else a.astype(ml_dtypes.bfloat16), tree)
    cfg = port_config(arch, param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    model = params_from_jax(cfg, tree, device="cpu")
    back = tree_to_jax(param_tree(model))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = keyed_leaves(back)
    assert [k for k, _ in got] == ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                            for p in path) for path, _ in want]
    for (k, g), (_, w) in zip(got, want):
        g = g.detach()
        assert str(g.dtype).split(".")[-1] == w.dtype.name, k
        bits = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
        assert np.array_equal(g.view(bits).numpy(), w.view(np.int16 if bits == torch.int16
                                                           else np.int32)), k
    again = unflatten_keyed(param_tree(model), [v for _, v in got])
    assert [k for k, _ in keyed_leaves(tree_to_jax(again))] == [k for k, _ in got]


def test_params_from_jax_refuses_family_trees_of_another_shape():
    _, tree = jax_params("whisper-tiny", seed=16)
    with pytest.raises(ValueError, match="encoder/layers"):
        params_from_jax(port_config("whisper-tiny", encoder_layers=3), tree, device="cpu")
    _, tree = jax_params("xlstm-125m", seed=17)
    with pytest.raises(ValueError, match="list of 3"):
        params_from_jax(port_config("xlstm-125m", block_types=["m", "s", "m"]), tree,
                        device="cpu")
    _, tree = jax_params("qwen2-moe-a2.7b", seed=18)
    with pytest.raises(ValueError, match=r"\['moe'\]\['gate'\]: \(64, 8\)"):
        params_from_jax(port_config("qwen2-moe-a2.7b", n_routed_experts=12), tree,
                        device="cpu")
