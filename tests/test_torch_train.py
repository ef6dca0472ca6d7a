"""The port's training path (``repro_torch.{models,optim,train,data}``) against
the JAX package.

Reduced smollm-135m (and llava for the vlm label mask) in float32, the JAX
parameters carried over by ``params_from_jax``. Tolerances, each stated
where it is checked:

* ``cross_entropy_loss`` and ``loss_fn`` (dense and vlm): within 1e-5
  relative of JAX's;
* the gradient of ``loss_fn`` against ``jax.value_and_grad``: per leaf of
  the JAX tree, max|Δ| ≤ 1e-4·max|g|;
* three ``adamw.update`` steps from equal gradients: parameters and
  moments within 1e-6·max|·| per leaf, ``lr`` within one ulp (PyTorch's
  float32 ``sqrt`` and ``cos`` on the CPU are not correctly rounded);
* three ``make_train_step`` steps at microbatches 1 and 2 and with
  ``compress_grads``: losses within 1e-5 relative, parameters within
  1e-5·max|p| per leaf, except at most 0.1% of a leaf's entries (AdamW
  divides by |g| + eps: an entry whose gradient is near eps moves by up
  to lr on gradient differences far inside 1e-4·max|g|), each within
  twice the learning rates' sum;
* the compressors, int8 and ``SyntheticLM``: bitwise;
* remat ``"dots"`` and ``"full"`` against ``"none"``: bitwise (the CPU
  recomputes the same ops);
* on a GPU (``cuda``): one float32 train step on the card against the CPU,
  loss within 1e-5 relative, parameters within 1e-4·max|p|.

JAX is imported inside the tests that use it, so the ``cuda`` test runs
where JAX is not installed.
"""
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models import model as M
from repro_torch.models.common import cross_entropy_loss
from repro_torch.models.convert import (flatten, keyed_leaves, param_tree, params_from_jax,
                                        tree_to_jax, unflatten)
from repro_torch.optim import adamw
from repro_torch.optim.compression import (ef_compress_tree, ef_init, ef_step,
                                           int8_dequantize, int8_quantize, topk_sparsify)
from repro_torch.train.step import batch_to, make_train_step

from test_torch_models import jax_params, port_config

ROOT = Path(__file__).resolve().parent.parent
LOSS_REL = 1e-5  # losses within LOSS_REL relative
GRAD_REL = 1e-4  # gradients within GRAD_REL·max|g| per leaf
OPT_REL = 1e-6  # adamw from equal gradients: within OPT_REL·max|·| per leaf
STEP_REL = 1e-5  # three train steps: parameters within STEP_REL·max|p| per leaf, but for
# AdamW divides by |g| + eps, so an entry whose gradient is near eps (cancellation
# leaves |g| ~ 1e-9 on rare tokens' embedding rows) moves by up to lr on tiny
# gradient differences: at most STEP_OUTLIERS entries of the whole tree may exceed
# STEP_REL·max|p|, each within twice the learning rates' sum (2 to 3 of the 32,768
# embed entries do; the gradients themselves are held at GRAD_REL with none)
STEP_OUTLIERS = 8


def at(tree, key):
    """The leaf of a nested dict (or tuple) at a JAX path key ``a/b/c``."""
    for k in key.split("/"):
        tree = tree[int(k)] if isinstance(tree, (tuple, list)) else tree[k]
    return tree


def lm_batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_real, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -100  # some ignored positions
    if cfg.family == "vlm":
        batch["vision_embeds"] = (np.random.default_rng(seed + 1).standard_normal(
            (B, cfg.vision_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def jnp_batch(batch):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_grads(cfg, model, batch):
    """(loss, gradient in the JAX layout) of the port's loss_fn."""
    M.trainable(model)
    params = param_tree(model)
    loss = M.loss_fn(cfg, model, batch_to(batch, "cpu"))
    grads = torch.autograd.grad(loss, flatten(params))
    return float(loss.detach()), tree_to_jax(unflatten(params, grads))


def assert_tree_close(got, want, rel, what, outliers=None):
    """Every leaf of the JAX-layout torch tree ``got`` against the numpy /
    JAX tree ``want``: |Δ| ≤ rel·max|want| per leaf. ``outliers=(n, cap)``
    lets at most ``n`` entries of the whole tree exceed that, each by no
    more than ``cap``."""
    beyond = {}
    for key, g in keyed_leaves(got):
        w = np.asarray(at(want, key), np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape, (what, key)
        err, bound = np.abs(g - w), rel * np.abs(w).max()
        if outliers is None:
            assert err.max() <= bound, (what, key, err.max(), bound)
        else:
            assert err.max() <= outliers[1], (what, key, err.max(), outliers[1])
            beyond[key] = int((err > bound).sum())
    if outliers is not None:
        assert sum(beyond.values()) <= outliers[0], (what, beyond)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
def test_cross_entropy_loss_matches_jax():
    import jax.numpy as jnp

    from repro.models.common import cross_entropy_loss as jax_ce

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 20, 512)).astype(np.float32) * 3
    labels = rng.integers(0, 503, (3, 20)).astype(np.int32)
    labels[1, 5:9] = -100
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels), 503))
    got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), 503))
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    # the padded columns count for nothing, even huge; all positions ignored gives 0
    big = logits.copy()
    big[..., 503:] = 1e4
    assert float(cross_entropy_loss(torch.from_numpy(big), torch.from_numpy(labels), 503)) == got
    none = torch.full((3, 20), -100, dtype=torch.int32)
    assert float(cross_entropy_loss(torch.from_numpy(logits), none, 503)) == 0.0


@pytest.mark.parametrize("arch", ["smollm-135m", "llava-next-mistral-7b"])
def test_loss_fn_matches_jax(arch):
    from repro.models import model as JM

    jcfg, tree = jax_params(arch, seed=30)
    cfg = port_config(arch)
    model = params_from_jax(cfg, tree, device="cpu")
    batch = lm_batch(cfg, B=2, S=24, seed=31)
    want = float(JM.loss_fn(jcfg, tree, jnp_batch(batch)))
    with torch.no_grad():
        got = float(M.loss_fn(cfg, model, batch_to(batch, "cpu")))
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    if cfg.family == "vlm":  # the image positions take no loss
        masked = dict(batch, labels=batch["labels"].copy())
        masked["labels"][:, :cfg.vision_patches] = 7
        with torch.no_grad():
            assert float(M.loss_fn(cfg, model, batch_to(masked, "cpu"))) == got


@pytest.mark.parametrize("arch", ["smollm-135m", "llava-next-mistral-7b"])
def test_gradients_match_jax(arch):
    import jax

    from repro.models import model as JM

    jcfg, tree = jax_params(arch, seed=32)
    cfg = port_config(arch)
    batch = lm_batch(cfg, B=2, S=24, seed=33)
    want_loss, want = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jnp_batch(batch)))(tree)
    loss, got = port_grads(cfg, params_from_jax(cfg, tree, device="cpu"), batch)
    assert abs(loss - float(want_loss)) <= LOSS_REL * abs(float(want_loss))
    assert [k for k, _ in keyed_leaves(got)] == [
        "/".join(str(getattr(p, "key", p)) for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert_tree_close(got, want, GRAD_REL, "grad")


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_is_bitwise_equal_to_none(remat):
    _, tree = jax_params("smollm-135m", seed=34)
    batch = lm_batch(port_config("smollm-135m"), B=2, S=24, seed=35)
    out = {}
    for policy in ("none", remat):
        cfg = port_config("smollm-135m", remat=policy)
        out[policy] = port_grads(cfg, params_from_jax(cfg, tree, device="cpu"), batch)
    assert out["none"][0] == out[remat][0]
    for (k, a), (_, b) in zip(keyed_leaves(out["none"][1]), keyed_leaves(out[remat][1])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k


def test_dots_remat_saves_products_and_recomputes_the_rest(monkeypatch):
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models import transformer as T

    seen, save_dots = [], T._save_dots

    def spy(ctx, op, *args, **kwargs):
        policy = save_dots(ctx, op, *args, **kwargs)
        seen.append((op, policy))
        return policy

    cfg = port_config("smollm-135m")
    model = M.trainable(M.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                                      device="cpu"))
    batch = batch_to(lm_batch(cfg, B=2, S=24, seed=36), "cpu")
    outer = {}
    for policy in ("none", "dots", "full"):
        c = dataclasses.replace(cfg, remat=policy)
        n = [0]

        def pack(t, n=n):
            n[0] += t.numel()
            return t

        monkeypatch.setattr(T, "_save_dots", spy)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            M.loss_fn(c, model, batch).backward()
        monkeypatch.undo()
        outer[policy] = n[0]
    # the layers' saved tensors move into the checkpoints: the graph outside keeps less
    assert outer["dots"] == outer["full"] < outer["none"], outer
    saved = [op for op, p in seen if p == CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * (7 * cfg.n_layers)  # q, k, v, o, gate, up, down
    assert {p for op, p in seen if op is torch.ops.aten.bmm.default} == {
        CheckpointPolicy.PREFER_RECOMPUTE}
    assert sum(op is torch.ops.aten.bmm.default for op, _ in seen) >= 2 * cfg.n_layers
    with torch.no_grad():  # no gradient taken: no checkpoint at all
        seen.clear()
        monkeypatch.setattr(T, "_save_dots", spy)
        M.forward(dataclasses.replace(cfg, remat="dots"), model, batch)
        assert not seen


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------
def jax_opt(c):
    from repro.optim import adamw as jadamw

    return jadamw.AdamWConfig(**dataclasses.asdict(c))


def test_adamw_update_matches_jax():
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw

    jcfg, tree = jax_params("smollm-135m", seed=40)
    cfg = port_config("smollm-135m")
    c = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5)
    model = params_from_jax(cfg, tree, device="cpu")
    params = param_tree(model)
    state = adamw.init(params)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jadamw.init(jparams)
    jupdate = jax.jit(lambda g, s, p: jadamw.update(jax_opt(c), g, s, p))
    rng = np.random.default_rng(41)
    for step in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
                         tree)
        gp = params_from_jax(cfg, g, device="cpu")
        _, _, m = adamw.update(c, param_tree(gp), state, params)
        jparams, jstate, jm = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        assert int(state["count"]) == int(jstate["count"]) == step + 1
        lr, jlr = np.float32(m["lr"]), np.asarray(jm["lr"], np.float32)
        assert abs(int(lr.view(np.int32)) - int(jlr.view(np.int32))) <= 1, (lr, jlr)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(
            jm["grad_norm"])
        assert_tree_close(tree_to_jax(params), jparams, OPT_REL, f"params {step}")
        assert_tree_close(tree_to_jax(state["mu"]), jstate["mu"], OPT_REL, f"mu {step}")
        assert_tree_close(tree_to_jax(state["nu"]), jstate["nu"], OPT_REL, f"nu {step}")


@pytest.mark.parametrize("step", [0, 1, 3, 9, 10, 55, 100, 101])
def test_schedule_matches_jax(step):
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw

    c = adamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    got = np.float32(adamw.schedule(c, torch.tensor(step, dtype=torch.int32)))
    want = np.asarray(jadamw.schedule(jax_opt(c), jnp.asarray(step, jnp.int32)), np.float32)
    assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1, (got, want)


def test_adamw_keeps_float32_moments_for_bf16_params():
    cfg = port_config("smollm-135m", param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params = param_tree(model)
    state = adamw.init(params)
    assert all(t.dtype == torch.float32 for t in flatten(state["mu"]) + flatten(state["nu"]))
    assert state["count"].dtype == torch.int32 and state["count"].shape == ()
    before = [p.clone() for p in flatten(params)]
    grads = unflatten(params, [torch.ones_like(p) for p in flatten(params)])
    adamw.update(adamw.AdamWConfig(lr=1e-2, warmup_steps=0), grads, state, params)
    assert all(p.dtype == torch.bfloat16 for p in flatten(params))
    assert any(not torch.equal(a, b) for a, b in zip(before, flatten(params)))


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False), (1, True)])
def test_train_step_matches_jax(microbatches, compress):
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw
    from repro.train.step import make_train_step as jax_train_step

    jcfg, tree = jax_params("smollm-135m", seed=50)
    cfg = port_config("smollm-135m")
    c = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    data = SyntheticLM(cfg.vocab_real, 24, 4)
    model = params_from_jax(cfg, tree, device="cpu")
    state = adamw.init(param_tree(model))
    step = make_train_step(cfg, c, microbatches=microbatches, compress_grads=compress)
    jstep = jax.jit(jax_train_step(jcfg, jax_opt(c), microbatches=microbatches,
                                   compress_grads=compress))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jadamw.init(jparams)
    lr_sum = 0.0
    for i in range(3):
        batch = data.batch_at(i)
        model, state, m = step(model, state, batch)
        jparams, jstate, jm = jstep(jparams, jstate, jnp_batch(batch))
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= LOSS_REL * abs(want), (i, float(m["loss"]), want)
        lr_sum += float(jm["lr"])
        assert_tree_close(tree_to_jax(param_tree(model)), jparams, STEP_REL, f"step {i}",
                          outliers=(STEP_OUTLIERS, 2 * lr_sum))
    assert int(state["count"]) == 3


def test_train_step_moves_numpy_batches_and_lowers_the_loss():
    cfg = port_config("smollm-135m")
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    state = adamw.init(param_tree(model))
    step = make_train_step(cfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20))
    batch = SyntheticLM(cfg.vocab_real, 16, 4).batch_at(0)
    losses = []
    for _ in range(8):
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        assert set(m) == {"loss", "grad_norm", "lr"}
    assert losses[-1] < losses[0], losses
    assert all(p.grad is None for p in model.parameters())  # grads never land in .grad


# --------------------------------------------------------------------------
# compression, int8, data
# --------------------------------------------------------------------------
def test_topk_keeps_the_lower_index_on_ties():
    import jax.numpy as jnp

    from repro.optim.compression import topk_sparsify as jax_topk

    x = np.array([1, 3, 3, 2], np.float32)
    assert topk_sparsify(torch.from_numpy(x), 0.5).tolist() == [0, 3, 3, 0]
    ties = np.array([2, -5, 5, 1, -5, 5, 0.5, 5], np.float32)  # four entries of |x| = 5
    for frac in (0.125, 0.25, 0.375, 0.5):
        want = np.asarray(jax_topk(jnp.asarray(ties), frac))
        got = topk_sparsify(torch.from_numpy(ties), frac).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), (frac, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_and_int8_are_bitwise_equal_to_jax(dtype):
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.optim import compression as JC

    from repro_torch.models.convert import tensor_from_numpy

    rng = np.random.default_rng(60)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    tree = {"a": rng.standard_normal((40, 30)).astype(np_dt),
            "b": {"c": (rng.standard_normal(77) * 1e-3).astype(np_dt),
                  "d": np.round(rng.standard_normal((8, 8)) * 4).astype(np_dt)},  # ties
            "layers": {"w": rng.standard_normal((3, 10, 7)).astype(np_dt)}}
    # the port's tree holds the layers as a list; JAX's top-k runs over the stack
    ttree = jax.tree.map(tensor_from_numpy, tree)
    ttree["layers"] = [{"w": ttree["layers"]["w"][i]} for i in range(3)]

    def bits(x):
        a = np.asarray(x)
        return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32 if a.dtype.itemsize == 4
                      else np.int8)

    def tbits(t):
        return bits(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy())

    jcomp, jerr = JC.ef_compress_tree(jax.tree.map(jnp.asarray, tree), frac=0.1)
    comp, err = ef_compress_tree(ttree, frac=0.1)
    assert isinstance(comp["layers"], list) and len(comp["layers"]) == 3
    for key, leaf in keyed_leaves(tree_to_jax(comp)):
        assert np.array_equal(tbits(leaf), bits(at(jcomp, key))), key
        assert np.array_equal(tbits(at(tree_to_jax(err), key)), bits(at(jerr, key))), key
    e = ef_init(ttree)
    assert all(t.dtype == torch.float32 and not t.any() for t in flatten(e))
    g = ttree["a"]
    c1, e1 = ef_step(g, e["a"], 0.05)
    jc1, je1 = JC.ef_step(jnp.asarray(tree["a"]), jnp.zeros((40, 30), jnp.float32), 0.05)
    c2, e2 = ef_step(g, e1, 0.05)  # the residual carried into the next step
    jc2, je2 = JC.ef_step(jnp.asarray(tree["a"]), je1, 0.05)
    for got, want in ((c1, jc1), (e1, je1), (c2, jc2), (e2, je2)):
        assert np.array_equal(tbits(got), bits(want))
    for leaf in keyed_leaves(tree_to_jax(ttree)):
        leaf = leaf[1]
        q, s = int8_quantize(leaf)
        jq, js = JC.int8_quantize(jnp.asarray(leaf.float().numpy()).astype(
            jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
        assert np.array_equal(tbits(s), bits(js))
        assert np.array_equal(tbits(int8_dequantize(q, s)), bits(JC.int8_dequantize(jq, js)))


def test_synthetic_lm_is_bitwise_equal_to_jax():
    from repro.data.pipeline import SyntheticLM as JaxLM

    for args in ((503, 32, 4), (49152, 64, 8, 1, 2), (1000, 17, 6, 2, 3, 99)):
        mine, theirs = SyntheticLM(*args), JaxLM(*args)
        for step in (0, 1, 7):
            a, b = mine.batch_at(step), theirs.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (args, step, k)
    pf = Prefetcher(SyntheticLM(503, 8, 2), start_step=3)
    try:
        for step in (3, 4, 5):
            got = pf.next()
            assert np.array_equal(got["tokens"], JaxLM(503, 8, 2).batch_at(step)["tokens"])
    finally:
        pf.close()


# --------------------------------------------------------------------------
# the CLI and the example
# --------------------------------------------------------------------------
def test_launch_train_cli_on_the_cpu(capsys):
    from repro_torch.launch import train as cli

    res = cli.main(["--arch", "smollm-135m", "--reduced", "--steps", "3", "--seq-len", "16",
                    "--batch", "4", "--microbatches", "2", "--device", "cpu"])
    assert res.steps == 3 and len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert "done: 3 steps" in capsys.readouterr().out


def test_example_loss_falls_on_the_cpu():
    # one thread: the test runs beside others, and idle OpenMP threads spin
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "train_smollm_torch.py"),
                          "--device", "cpu", "--steps", "30", "--seq-len", "64"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IMPROVED" in out.stdout, out.stdout[-2000:]


@pytest.mark.cuda
def test_card_train_step_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = port_config("smollm-135m")
    cpu = M.Transformer(cfg, generator=torch.Generator().manual_seed(70), device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    c = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = SyntheticLM(cfg.vocab_real, 32, 4).batch_at(0)
    out = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        state = adamw.init(param_tree(model))
        model, state, m = make_train_step(cfg, c)(model, state, batch)
        out[name] = (float(m["loss"]), [p.detach().cpu() for p in flatten(param_tree(model))])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= LOSS_REL * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
