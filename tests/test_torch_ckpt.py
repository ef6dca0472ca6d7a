"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) and the training
loop's resume, against the JAX package's on-disk layout.

* The layout: ``step_XXXXXXXX/manifest.json`` and ``arrays/<i>.npy`` with
  the JAX keys and indices (``0/embed``, ``0/layers/attn/wq`` stacked on
  L, ``1/count``, ``1/mu/...``), for the ``(params, opt_state)`` pair the
  loop saves.
* Both directions, float32, bitwise: what the port writes,
  ``repro.checkpoint.ckpt.restore`` reads back to the same bits and the
  same manifest entries; what the JAX package writes, the port restores
  bitwise. Also for xlstm-125m (``blocks`` a list) and whisper-tiny (the
  ``encoder``'s layers stacked) after two train steps on either side.
* bf16, bitwise: the port's round trip, and a bf16 checkpoint written by
  the JAX package read by the port. (The JAX ``restore`` without
  ``shardings`` returns such leaves as 2-byte voids: a reference fault,
  recorded by a ``reference_fault`` test.)
* Atomic saves and retention; the asynchronous save snapshots at call
  time; a leaf of another shape raises.
* The loop: 6 steps against 3 steps, a restore and 3 more, bitwise on the
  CPU (losses and the final checkpoints).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore, save
from repro_torch.models import model as M
from repro_torch.models.convert import (flatten, keyed_leaves, param_tree, params_from_jax,
                                        tree_to_jax)
from repro_torch.optim import adamw
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_step

from test_torch_models import frames_of, jax_params, port_config


def trained_state(cfg, seed=0, steps=2):
    """A model and optimizer state after ``steps`` train steps (moments and
    count not zero)."""
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    state = adamw.init(param_tree(model))
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_real, (2, 17)).astype(np.int32)
        model, state, _ = step(model, state, {"tokens": toks[:, :16], "labels": toks[:, 1:]})
    return model, state


def bits(t):
    a = t.detach().cpu()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy()
    return a.numpy().view({4: np.int32, 8: np.int64, 2: np.int16, 1: np.int8}[a.element_size()])


def np_bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view({4: np.int32, 8: np.int64, 2: np.int16, 1: np.int8}[a.dtype.itemsize])


def jax_pair(tree):
    """The JAX package's (params, opt_state) of the numpy tree ``tree``,
    after one update so that the moments are not zero."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw

    params = jax.tree.map(jnp.asarray, tree)
    state = jadamw.init(params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, state, _ = jadamw.update(jadamw.AdamWConfig(), grads, state, params)
    return params, state


def test_layout_has_the_jax_keys(tmp_path):
    cfg = port_config("smollm-135m")
    model, state = trained_state(cfg)
    path = save(str(tmp_path), 7, (param_tree(model), state))
    assert os.path.basename(path) == "step_00000007" and latest_step(str(tmp_path)) == 7
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys = [leaf["key"] for leaf in manifest["leaves"]]
    assert keys[:3] == ["0/embed", "0/final_norm/scale", "0/layers/attn/wk"]
    assert "1/count" in keys and "1/mu/layers/mlp/w_up" in keys and "1/nu/embed" in keys
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    assert by_key["0/layers/attn/wq"]["shape"] == [cfg.n_layers, cfg.d_model, cfg.d_head_total]
    assert by_key["1/count"] == {"key": "1/count", "index": by_key["1/count"]["index"],
                                 "shape": [], "dtype": "int32"}
    assert [leaf["index"] for leaf in manifest["leaves"]] == list(range(len(keys)))
    wq = np.load(os.path.join(path, "arrays", f"{by_key['0/layers/attn/wq']['index']}.npy"))
    assert np.array_equal(wq[1], model.layers[1]["attn"]["wq"].detach().numpy())


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    import jax

    from repro.checkpoint import ckpt as JC

    jcfg, tree = jax_params("smollm-135m", seed=80)
    cfg = port_config("smollm-135m")
    model = params_from_jax(cfg, tree, device="cpu")
    state = adamw.init(param_tree(model))
    adamw.update(adamw.AdamWConfig(), param_tree(params_from_jax(cfg, tree, device="cpu")),
                 state, param_tree(model))
    save(str(tmp_path), 3, (param_tree(model), state))
    like = jax_pair(tree)
    got, manifest = JC.restore(str(tmp_path), None, like)
    assert manifest["step"] == 3
    mine = dict(keyed_leaves((tree_to_jax(param_tree(model)), tree_to_jax(state))))
    paths = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(paths) == len(mine)
    for path, leaf in paths:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        assert leaf.dtype == mine[key].numpy().dtype, key
        assert np.array_equal(np_bits(leaf), bits(mine[key])), key


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    import jax

    from repro.checkpoint import ckpt as JC

    jcfg, tree = jax_params("smollm-135m", seed=81)
    cfg = port_config("smollm-135m")
    pair = jax_pair(tree)
    JC.save(str(tmp_path), 5, pair)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    like = (param_tree(model), adamw.init(param_tree(model)))
    (params, state), manifest = restore(str(tmp_path), 5, like, device="cpu")
    assert manifest["step"] == 5 and int(state["count"]) == 1
    assert isinstance(params["layers"], list) and len(params["layers"]) == cfg.n_layers
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(pair)[0]}
    got = dict(keyed_leaves((tree_to_jax(params), tree_to_jax(state))))
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        assert np.array_equal(bits(leaf), np_bits(want[key])), key


FAMILIES = ["xlstm-125m", "whisper-tiny"]


def jax_key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def family_batches(cfg, n, seed):
    """``n`` seeded train batches of 2 x 16 tokens (whisper's with frames)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_real, (2, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :16], "labels": toks[:, 1:]}
        if cfg.family == "audio":
            batch["frames"] = frames_of(cfg, 2, seed + 1 + i)
        out.append(batch)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_port_checkpoint_restores_in_jax_bitwise(tmp_path, arch):
    import jax

    from repro.checkpoint import ckpt as JC

    _, tree = jax_params(arch, seed=83)
    cfg = port_config(arch)
    model = params_from_jax(cfg, tree, device="cpu")
    state = adamw.init(param_tree(model))
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    for batch in family_batches(cfg, 2, 84):
        model, state, _ = step(model, state, batch)
    save(str(tmp_path), 2, (param_tree(model), state))
    got, manifest = JC.restore(str(tmp_path), None, jax_pair(tree))
    assert manifest["step"] == 2 and int(got[1]["count"]) == 2
    mine = dict(keyed_leaves((tree_to_jax(param_tree(model)), tree_to_jax(state))))
    paths = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax_key(path) for path, _ in paths] == list(mine)
    for path, leaf in paths:
        key = jax_key(path)
        assert leaf.dtype == mine[key].detach().numpy().dtype, key
        assert np.array_equal(np_bits(leaf), bits(mine[key])), key


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_jax_checkpoint_restores_in_the_port_bitwise(tmp_path, arch):
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import ckpt as JC
    from repro.optim import adamw as jadamw
    from repro.train.step import make_train_step as jax_train_step

    jcfg, tree = jax_params(arch, seed=85)
    cfg = port_config(arch)
    jstep = jax.jit(jax_train_step(jcfg, jadamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                            total_steps=10)))
    params = jax.tree.map(jnp.asarray, tree)
    jstate = jadamw.init(params)
    for batch in family_batches(cfg, 2, 86):
        params, jstate, _ = jstep(params, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    JC.save(str(tmp_path), 5, (params, jstate))
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    like = (param_tree(model), adamw.init(param_tree(model)))
    (got_params, state), manifest = restore(str(tmp_path), 5, like, device="cpu")
    assert manifest["step"] == 5 and int(state["count"]) == 2
    if cfg.family == "ssm":
        assert isinstance(got_params["blocks"], list) and len(got_params["blocks"]) == len(
            cfg.block_types)
    else:
        assert len(got_params["encoder"]["layers"]) == cfg.encoder_layers
    want = {jax_key(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path((params, jstate))[0]}
    got = dict(keyed_leaves((tree_to_jax(got_params), tree_to_jax(state))))
    assert list(got) == list(want)
    for key, leaf in got.items():
        assert np.array_equal(bits(leaf), np_bits(want[key])), key


def test_bf16_round_trip_is_bitwise(tmp_path):
    cfg = port_config("smollm-135m", param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    model, state = trained_state(cfg, seed=2)
    pair = (param_tree(model), state)
    save(str(tmp_path), 1, pair)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        dtypes = {leaf["key"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    assert dtypes["0/embed"] == "bfloat16" and dtypes["1/mu/embed"] == "float32"
    fresh = M.Transformer(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    got, _ = restore(str(tmp_path), 1, (param_tree(fresh), adamw.init(param_tree(fresh))),
                     device="cpu")
    for a, b in zip(flatten(got), flatten(pair)):
        assert a.dtype == b.dtype and np.array_equal(bits(a), bits(b))


def test_jax_bf16_checkpoint_restores_in_the_port_bitwise(tmp_path):
    import jax
    import ml_dtypes

    from repro.checkpoint import ckpt as JC

    _, tree = jax_params("smollm-135m", seed=82)
    tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    JC.save(str(tmp_path), 2, tree)
    cfg = port_config("smollm-135m", param_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
    model = M.Transformer(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    got, _ = restore(str(tmp_path), 2, param_tree(model), device="cpu")
    for key, leaf in keyed_leaves(tree_to_jax(got)):
        want = tree
        for k in key.split("/"):
            want = want[k]
        assert leaf.dtype == torch.bfloat16
        assert np.array_equal(bits(leaf), np.asarray(want).view(np.int16)), key


@pytest.mark.reference_fault
def test_jax_restore_returns_bf16_leaves_as_voids(tmp_path):
    """The JAX ``restore`` without ``shardings`` hands back a bf16 leaf as
    NumPy loaded it: 2-byte voids (``|V2``), not bfloat16. The bits are
    right; the port decodes them by the manifest's dtype instead."""
    import ml_dtypes

    from repro.checkpoint import ckpt as JC

    leaf = np.array([1.0, -2.5, 3e-40], dtype=ml_dtypes.bfloat16)
    JC.save(str(tmp_path), 1, {"w": leaf})
    got, manifest = JC.restore(str(tmp_path), 1, {"w": leaf})
    assert manifest["leaves"][0]["dtype"] == "bfloat16"
    assert got["w"].dtype == np.dtype("V2")
    assert np.array_equal(got["w"].view(np.int16), leaf.view(np.int16))
    mine, _ = restore(str(tmp_path), 1, {"w": torch.zeros(3, dtype=torch.bfloat16)},
                      device="cpu")
    assert np.array_equal(bits(mine["w"]), leaf.view(np.int16))
    # what the port writes, the JAX restore reads the same way: voids with the bits
    save(str(tmp_path), 2, mine)
    theirs, _ = JC.restore(str(tmp_path), 2, {"w": leaf})
    assert theirs["w"].dtype.kind == "V" and np.array_equal(theirs["w"].view(np.int16),
                                                            leaf.view(np.int16))


def test_atomic_save_retention_and_shape_check(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # a crashed save is never picked up
    for step in (1, 2, 3, 4):
        save(d, step, tree, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004", "step_00000009.tmp"]
    assert latest_step(d) == 4 and latest_step(os.path.join(d, "none")) is None
    with pytest.raises(ValueError, match="shape"):
        restore(d, None, {"a": torch.zeros(3, 2)}, device="cpu")
    with pytest.raises(KeyError):
        restore(d, None, {"b": torch.zeros(2, 3)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore(os.path.join(d, "none"), None, tree, device="cpu")


def test_async_save_snapshots_at_call_time(tmp_path):
    t = torch.ones(1000, dtype=torch.float32)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save_async(1, {"t": t}, extra={"note": "x"})
    t.mul_(3)  # training goes on writing the tensor while the save runs
    ck.wait()
    got, manifest = restore(str(tmp_path), 1, {"t": t}, device="cpu")
    assert torch.equal(got["t"], torch.ones(1000)) and manifest["extra"] == {"note": "x"}


def test_loop_resume_is_bitwise(tmp_path):
    cfg = port_config("smollm-135m")
    c = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
    kw = dict(opt_cfg=c, seq_len=16, global_batch=4, log_every=0, device="cpu", seed=5)
    whole = train(cfg, n_steps=6, ckpt_dir=str(tmp_path / "a"), save_every=3, **kw)
    first = train(cfg, n_steps=3, ckpt_dir=str(tmp_path / "b"), save_every=3, **kw)
    rest = train(cfg, n_steps=6, ckpt_dir=str(tmp_path / "b"), save_every=3, **kw)
    assert (whole.restored_from, first.restored_from, rest.restored_from) == (None, None, 3)
    assert (whole.steps, first.steps, rest.steps) == (6, 3, 3)
    losses = np.array(first.losses + rest.losses, np.float64)
    assert np.array_equal(losses, np.array(whole.losses, np.float64)), (losses, whole.losses)
    for a, b in zip(flatten((param_tree(whole.model), whole.opt_state)),
                    flatten((param_tree(rest.model), rest.opt_state))):
        assert np.array_equal(bits(a), bits(b))
    for d in ("a", "b"):
        assert latest_step(str(tmp_path / d)) == 6
    like = (param_tree(whole.model), whole.opt_state)
    (ga, _), (gb, _) = (restore(str(tmp_path / d), 6, like, device="cpu") for d in "ab")
    for a, b, live in zip(flatten(ga), flatten(gb), flatten(like)):
        assert np.array_equal(bits(a), bits(b)) and np.array_equal(bits(a), bits(live))
