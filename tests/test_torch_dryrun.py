"""The port's dry run (``repro_torch.launch.dryrun``) and the pieces it adds.

* The ``unroll_prefix`` form of ``chunked_attention`` (the cost pass's
  ``attn_unroll``): within 1e-5·max|o| of JAX's own ``unroll_prefix``
  form, causal, with a sliding window and non-causal; and within the same
  bound of the port's chunked walk.
* ``resolve_device``: ``meta`` is taken when named; ``input_specs`` gives
  meta tensors of JAX's shapes and dtypes for every ``SHAPES`` entry and
  for a (seq, batch, kind) triple.
* A dry run of each of ``test_dryrun_small.py``'s eight (arch, kind) cases,
  reduced, on the (2,4) mesh ends ``status: ok`` with FLOPs > 0, per-device
  bytes that add up, and the fake process group ended after it.
* ``temp_bytes`` leaves out what the step holds before it runs (a decode
  cache that grows by 30 layers grows the temp by one layer's float32
  read); ``fits_hbm`` says yes or no only where the exact arguments or
  the ceiling decide it; a fault of the step raises, where a fault of
  MemTracker itself reads ``null``.
* The CLI writes one full-size cell's JSON (smollm-135m ``decode_32k`` on
  the 16x16 mesh): ``status: ok``, the terms marked as floors.
* ``launch.mesh``: the production and host meshes' axes, ``dp_size`` and
  ``tp_size``; a fake group is started only where no default group
  exists and ended by ``release_mesh``; a default group of another size is
  refused. ``ShardingRules.layer_placements``: a layer's tensor placed by
  them holds the stacked leaf's local shard of one layer.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (dp_size, make_host_mesh, make_mesh, make_production_mesh,
                                     mesh_axis_sizes, mesh_scope, release_mesh, tp_size)
from repro_torch.launch.sharding import ShardingRules
from repro_torch.models import model as M
from repro_torch.models.attention import chunked_attention
from repro_torch.models.convert import keyed_leaves

ATTN_REL = 1e-5
CASES = [  # test_dryrun_small.py's
    ("smollm-135m", "train"),
    ("deepseek-v2-lite-16b", "train"),
    ("qwen2-moe-a2.7b", "decode"),
    ("hymba-1.5b", "decode"),
    ("xlstm-125m", "train"),
    ("whisper-tiny", "decode"),
    ("llava-next-mistral-7b", "prefill"),
    ("starcoder2-15b", "prefill"),
]
B, S, CACHE = 4, 32, 32


def _qkv(seed, S=48, Skv=48, H=4, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, S, H, D), (2, Skv, Hkv, D), (2, Skv, Hkv, D))]


@pytest.mark.parametrize("kind", ["causal", "window", "noncausal"])
def test_unroll_prefix_attention_equals_jax(kind):
    import jax.numpy as jnp

    from repro.models.attention import chunked_attention as jax_attention

    q, k, v = _qkv(80, Skv=24 if kind == "noncausal" else 48)
    kw = dict(causal=kind != "noncausal", window=20 if kind == "window" else None,
              q_chunk=16, kv_chunk=16)
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    unroll_prefix=True, **kw))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = chunked_attention(tq, tk, tv, unroll_prefix=True, **kw).numpy()
    walked = chunked_attention(tq, tk, tv, **kw).numpy()
    bound = ATTN_REL * float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= bound
    assert float(np.max(np.abs(walked - got))) <= bound


def test_meta_is_taken_only_when_named():
    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="'cuda', 'cpu' or 'meta'"):
        resolve_device("mps")


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny", "smollm-135m"])
def test_input_specs_are_meta_tensors_of_jax_shapes(arch):
    from repro.configs import get_config as jax_config

    cfg, jcfg = get_config(arch), jax_config(arch)
    for name in SHAPES:
        got, want = cfg.input_specs(name), jcfg.input_specs(name)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
    small = cfg.input_specs((16, 3, "train"), device="cpu")
    assert small["tokens"].shape == (3, 16) and small["tokens"].device.type == "cpu"
    assert cfg.input_specs((16, 3, "decode"))["tokens"].shape == (3, 1)


@pytest.mark.parametrize("arch,kind", CASES)
def test_small_dry_run_is_ok(arch, kind):
    cfg = dataclasses.replace(get_config(arch).reduced(), q_chunk=16, kv_chunk=16)
    shape = (CACHE if kind == "decode" else S, B, kind)
    out = dryrun.dry_run(cfg, shape, (2, 4), ("data", "model"), {"zero1": True})
    assert not dist.is_initialized()  # the fake group is ended with the cell
    assert out["status"] == "ok" and out["kind"] == kind and out["mesh"] == "2x4"
    assert out["flops_global"] > 0 and out["flops_per_device"] == out["flops_global"] / 8
    assert (out["terms"], out["flops_split"], out["hardware"]["name"]) == (
        "floor", "even", "h100-sxm")
    m = out["memory_stats"]
    assert m["argument_bytes"] == (m["param_bytes"] + m["optimizer_bytes"] + m["batch_bytes"]
                                   + m["cache_bytes"]) > 0
    assert (m["optimizer_bytes"] > 0) == (kind == "train")
    assert (m["cache_bytes"] > 0) == (kind == "decode")
    assert m["temp_bytes"] is not None and m["temp_bytes"] > 0, out["temp_bytes_source"]
    assert out["bottleneck"] in ("compute", "memory", "collective")
    assert (out["collective_s"] > 0) == (kind == "train")


def test_decode_temp_excludes_the_cache_it_holds():
    # smollm at its published size on meta, one device: a longer cache adds
    # 30 layers of bf16 K/V to the arguments, and to the temp only the one
    # layer that decode attention reads in float32 at a time (twice its bf16
    # bytes) and that layer's float32 scores
    cfg = get_config("smollm-135m")
    runs = [dryrun.dry_run(cfg, (L, 2, "decode"), (1, 1), ("data", "model"),
                           {"skip_cost_pass": True})["memory_stats"] for L in (1024, 2048)]
    grown_cache = runs[1]["cache_bytes"] - runs[0]["cache_bytes"]
    grown_temp = runs[1]["temp_bytes"] - runs[0]["temp_bytes"]
    assert grown_cache == cfg.n_layers * 2 * 2 * 1024 * cfg.n_kv_heads * cfg.head_dim * 2
    assert 2 * grown_cache / cfg.n_layers < grown_temp < 3 * grown_cache / cfg.n_layers


@pytest.mark.parametrize("args,want", [
    ((81e9, None, 16), (False, "arguments alone")),
    ((1e9, None, 16), (None, "temp not measured; the arguments alone fit")),
    ((1e9, 2e9, 16), (True, "arguments + temp ceiling")),
    ((1e9, 90e9, 1), (False, "arguments + temp (model axis 1: the ceiling is the step as run)")),
    ((1e9, 90e9, 16), (None, "ceiling ignores the model axis (16)")),
])
def test_fits_hbm_rests_only_on_what_is_known(args, want):
    fits, source = dryrun.fits_hbm(*args)
    assert fits is want[0] and want[1] in source


def test_a_fault_of_the_step_raises_and_one_of_the_tracker_reads_null(monkeypatch):
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), q_chunk=16, kv_chunk=16)
    shape, mesh = (S, B, "prefill"), ((1, 1), ("data", "model"))
    leaves = dryrun._leaves
    monkeypatch.setattr(dryrun, "_leaves", lambda tree: [*leaves(tree), "not a tensor"])
    out = dryrun.dry_run(cfg, shape, *mesh, {"skip_cost_pass": True})
    assert out["memory_stats"]["temp_bytes"] is None and out["fits_hbm_80g"] is None
    assert out["temp_bytes_source"].startswith("not measured: MemTracker raised TypeError")
    monkeypatch.setattr(dryrun, "_leaves", leaves)

    def broken(*a, **k):
        raise ValueError("a fault of the step")

    monkeypatch.setattr(dryrun, "_run_step", broken)
    with pytest.raises(ValueError, match="a fault of the step"):
        dryrun.dry_run(cfg, shape, *mesh, {"skip_cost_pass": True})
    assert not dist.is_initialized()


def test_cli_writes_a_full_size_cell(tmp_path):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert e.value.code == 0
    out = json.loads((tmp_path / "smollm-135m__decode_32k__pod1.json").read_text())
    assert out["status"] == "ok" and out["mesh"] == "16x16" and out["chips"] == 256
    assert out["terms"] == "floor" and out["flops_global"] > 0
    cfg = get_config("smollm-135m")
    # the parameters: the vocab-sharded embedding and head, the rest split or replicated
    assert 0 < out["memory_stats"]["param_bytes"] < 2 * cfg.param_count()["total"]
    assert not dist.is_initialized()


def test_meshes_and_their_fake_group():
    try:
        mesh = make_production_mesh(multi_pod=True)
        assert mesh_axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
        assert (dp_size(mesh), tp_size(mesh), dist.get_world_size()) == (32, 16, 512)
        with pytest.raises(RuntimeError, match="default group has 512"):
            make_host_mesh(2, 4)
    finally:
        release_mesh()
    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(2, 4)
        assert (dp_size(mesh), tp_size(mesh)) == (2, 4)
        with mesh_scope((4, 2), ("data", "model")) as again:  # the same group, left open
            assert mesh_axis_sizes(again) == {"data": 4, "model": 2}
        assert dist.is_initialized()
        assert make_mesh((8,), ("data",)).mesh_dim_names == ("data",)
    finally:
        release_mesh()
    assert not dist.is_initialized()


def test_layer_placements_hold_one_layer_of_the_stacked_shard():
    from torch.distributed.tensor import distribute_tensor

    cfg = get_config("qwen2-moe-a2.7b")
    params = M.init_params(cfg, None, torch.device("meta"))
    with mesh_scope((2, 4), ("data", "model")) as mesh:
        rules = ShardingRules(cfg, mesh)
        specs = rules.params_specs(params)
        placed = rules.place(params, specs)
        layered = [(k, leaf) for k, leaf in keyed_leaves(params) if isinstance(leaf, list)]
        assert len(layered) > 10
        for k, leaf in layered:
            assert specs[k][0] is None  # no parameter rule splits L
            one = distribute_tensor(leaf[0], mesh, rules.layer_placements(specs[k]))
            assert tuple(one.to_local().shape) == tuple(placed[k].to_local().shape[1:]), k
