"""Training of the four remaining families (MoE with MLA, the hybrid SSM,
xLSTM, whisper) in the port, against the JAX package.

Reduced configs in float32, the JAX parameters carried over by
``params_from_jax`` (``jax_params``: biases, norms and the SSM's leaves
drawn too). Tolerances, those of ``test_torch_train.py``:

* the gradient of ``loss_fn`` against ``jax.value_and_grad`` for
  deepseek-v2-lite-16b, qwen2-moe-a2.7b (6 experts padded to 8), hymba-1.5b,
  xlstm-125m and whisper-tiny, each under its full config's remat
  ``"dots"`` (whisper's encoder layers too): leaves in JAX's order, the loss
  within 1e-5 relative, each leaf within 1e-4·max|g|; xlstm also at S = 160,
  where both sides chunk their scans (two chunks of 80);
* remat ``"dots"`` and ``"full"`` against ``"none"`` for hymba (whose
  chunked scan then runs as a checkpoint inside the layer's) and deepseek,
  and xLSTM's chunked scans against the plain loop: bitwise;
* three ``make_train_step`` steps of xlstm (``blocks`` a list) and whisper
  (``encoder``; frames sliced per microbatch) at microbatches 1 and 2 and
  with ``compress_grads``: losses within 1e-5 relative, parameters within
  1e-5·max|p| per leaf but for at most 8 entries in all, each within twice
  the learning rates' sum (AdamW near eps);
* every config of ``ARCHS`` reduced: the loss and the gradient's norm
  finite, the norm above 0 (``test_models_smoke.py``'s check);
* on a GPU (``cuda``): each family's gradient on the card against the CPU's
  within 1e-4·max|g| per leaf.

JAX is imported inside the tests that use it, so the ``cuda`` test runs
where JAX is not installed.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import model as M
from repro_torch.models import scan_utils
from repro_torch.models.convert import (flatten, keyed_leaves, param_tree, params_from_jax,
                                        tree_to_jax)
from repro_torch.optim import adamw
from repro_torch.train.step import batch_to, make_train_step

from test_torch_models import batch_of, frames_of, jax_params, port_config
from test_torch_train import (GRAD_REL, LOSS_REL, STEP_OUTLIERS, STEP_REL, assert_tree_close,
                              jax_opt, jnp_batch, port_grads)

FAMILIES = ["deepseek-v2-lite-16b", "qwen2-moe-a2.7b", "hymba-1.5b", "xlstm-125m",
            "whisper-tiny"]
# qwen2-moe's reduced layer gets 6 experts, padded to 8 (as its 60 pad to 64)
CHANGES = {"qwen2-moe-a2.7b": dict(n_routed_experts=6)}


def configs(arch, **changes):
    """(JAX config, numpy parameter tree, port config) of the reduced
    ``arch`` with ``changes``."""
    changes = dict(CHANGES.get(arch, {}), **changes)
    seed = changes.pop("seed", 0)
    jcfg, tree = jax_params(arch, seed=seed, **changes)
    return jcfg, tree, port_config(arch, **changes)


def train_batch(cfg, B, S, seed):
    """``batch_of``'s tokens (and whisper's frames) with seeded labels, a
    few of them ignored."""
    batch = batch_of(cfg, B, S, seed)
    batch["labels"] = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_real, (B, S)).astype(np.int32)
    batch["labels"][0, :3] = -100
    return batch


def grads_on(cfg, model, batch):
    """(loss, gradient in the JAX layout, on the CPU) of the port's loss_fn
    on ``model``'s device."""
    M.trainable(model)
    params = param_tree(model)
    loss = M.loss_fn(cfg, model, batch_to(batch, model.device))
    grads = torch.autograd.grad(loss, flatten(params))
    return float(loss.detach()), [g.cpu() for g in grads]


def jax_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def bitwise(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(flatten(a), flatten(b)))


@pytest.mark.parametrize("arch,S", [(a, 24) for a in FAMILIES] + [("xlstm-125m", 160)])
def test_gradients_match_jax(arch, S):
    import jax

    from repro.models import model as JM

    jcfg, tree, cfg = configs(arch, remat="dots", seed=10)
    batch = train_batch(cfg, B=2, S=S, seed=11)
    want_loss, want = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jnp_batch(batch)))(tree)
    loss, got = port_grads(cfg, params_from_jax(cfg, tree, device="cpu"), batch)
    assert abs(loss - float(want_loss)) <= LOSS_REL * abs(float(want_loss)), (loss, want_loss)
    assert [k for k, _ in keyed_leaves(got)] == [
        jax_path(path) for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert_tree_close(got, want, GRAD_REL, f"grad {arch}")
    if arch == "whisper-tiny":  # the decoder's cross-attention carries a gradient to every
        # encoder leaf
        assert all(float(g.abs().max()) > 0 for _, g in keyed_leaves(got["encoder"]))


@pytest.mark.parametrize("arch,S", [("hymba-1.5b", 160), ("deepseek-v2-lite-16b", 24)])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_is_bitwise_equal_to_none(arch, S, remat):
    _, tree, _ = configs(arch, seed=12)
    batch = train_batch(port_config(arch), B=2, S=S, seed=13)
    out = {}
    for policy in ("none", remat):
        cfg = configs(arch, remat=policy, seed=12)[2]
        out[policy] = port_grads(cfg, params_from_jax(cfg, tree, device="cpu"), batch)
    assert out["none"][0] == out[remat][0]
    assert bitwise(out["none"][1], out[remat][1])


def test_xlstm_chunked_scans_are_bitwise_the_plain_loop(monkeypatch):
    _, tree, cfg = configs("xlstm-125m", seed=14)
    batch = train_batch(cfg, B=2, S=160, seed=15)  # two chunks of 80
    chunked = port_grads(cfg, params_from_jax(cfg, tree, device="cpu"), batch)
    monkeypatch.setattr(scan_utils, "REMAT_CHUNK", 1)
    plain = port_grads(cfg, params_from_jax(cfg, tree, device="cpu"), batch)
    assert chunked[0] == plain[0]
    assert bitwise(chunked[1], plain[1])


def lm_data(cfg, S, B):
    """SyntheticLM's batches, with seeded frames for whisper."""
    data = SyntheticLM(cfg.vocab_real, S, B)

    def batch_at(i):
        batch = data.batch_at(i)
        if cfg.family == "audio":
            batch["frames"] = frames_of(cfg, B, 20 + i)
        return batch

    return batch_at


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-tiny"])
@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False), (1, True)])
def test_train_step_matches_jax(arch, microbatches, compress):
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw
    from repro.train.step import make_train_step as jax_train_step

    jcfg, tree, cfg = configs(arch, remat="dots", seed=16)
    c = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch_at = lm_data(cfg, 16, 4)
    model = params_from_jax(cfg, tree, device="cpu")
    state = adamw.init(param_tree(model))
    step = make_train_step(cfg, c, microbatches=microbatches, compress_grads=compress)
    jstep = jax.jit(jax_train_step(jcfg, jax_opt(c), microbatches=microbatches,
                                   compress_grads=compress))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jadamw.init(jparams)
    lr_sum = 0.0
    for i in range(3):
        batch = batch_at(i)
        model, state, m = step(model, state, batch)
        jparams, jstate, jm = jstep(jparams, jstate, jnp_batch(batch))
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= LOSS_REL * abs(want), (i, float(m["loss"]), want)
        lr_sum += float(jm["lr"])
        assert_tree_close(tree_to_jax(param_tree(model)), jparams, STEP_REL, f"step {i}",
                          outliers=(STEP_OUTLIERS, 2 * lr_sum))
    assert int(state["count"]) == 3
    assert_tree_close(tree_to_jax(state["mu"]), jstate["mu"], STEP_REL, "mu",
                      outliers=(STEP_OUTLIERS, 2 * lr_sum))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grads_finite(arch):
    """The port's ``test_models_smoke.py::test_train_step_grads_finite``."""
    cfg = port_config(arch)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    batch = train_batch(cfg, B=2, S=64, seed=1)
    loss, grads = port_grads(cfg, model, batch)
    gnorm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for _, g in keyed_leaves(grads))))
    assert np.isfinite(loss) and np.isfinite(gnorm), (loss, gnorm)
    assert gnorm > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_card_gradients_equal_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(port_config(arch, **CHANGES.get(arch, {})), remat="dots")
    cpu = M.Transformer(cfg, generator=torch.Generator().manual_seed(17), device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    batch = train_batch(cfg, B=2, S=160 if cfg.family == "ssm" else 24, seed=18)
    want_loss, want = grads_on(cfg, cpu, batch)
    got_loss, got = grads_on(cfg, card, batch)
    assert abs(got_loss - want_loss) <= LOSS_REL * abs(want_loss)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a - b).abs().max() <= GRAD_REL * b.abs().max(), i
