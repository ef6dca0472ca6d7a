"""The port's sharding rules and grouped MoE held to the JAX package's.

One module-scoped subprocess (``torch_jax_dryrun_dump.py``, 512 XLA host
devices) dumps the JAX side; then, per config at its published size and
per mesh ((16,16), (2,16,16), (2,4), (1,1)), over the parameters, the
AdamW state (ZeRO-1 off and on), every ``SHAPES`` batch and the
``decode_32k`` / ``long_500k`` caches:

* the port's specs (``repro_torch.launch.sharding.ShardingRules`` on a
  ``DeviceMesh`` over a fake process group) equal JAX's ``PartitionSpec``
  entries leaf by leaf, in JAX's flatten order;
* the port's ``meta`` leaf shapes and dtypes equal JAX's ``eval_shape``;
* the per-device bytes of the port's DTensor local shards equal those
  reckoned from JAX's shapes, dtypes and specs.

And the grouped ``moe_ffn``: under a logical mesh of G = 2 and 4 data
shards, reduced qwen2-moe and deepseek in float32 on the dump's seeded
parameters and input route every group as JAX does (the same groups, the
same capacity, tokens per slot, kept assignments and slots) and give an
output within 1e-5·max|y| of JAX's.
"""
import functools
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import mesh_scope
from repro_torch.launch.sharding import ShardingRules, jax_shape, local_bytes
from repro_torch.models import model as M
from repro_torch.models.common import logical_mesh
from repro_torch.models.convert import keyed_leaves
from repro_torch.models.ffn import _route_group, capacity, dispatch_groups, moe_ffn
from repro_torch.optim import adamw

from subproc import run_checked

DUMP = os.path.join(os.path.dirname(__file__), "torch_jax_dryrun_dump.py")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
CACHE_SHAPES = ("decode_32k", "long_500k")
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
MOE_REL = 1e-5
META = torch.device("meta")


@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dryrun") / "dump.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rc, so, se = run_checked([sys.executable, DUMP, str(out)], env=env, timeout=300)
    assert rc == 0 and "OK" in so, f"stdout:{so}\nstderr:{se[-2000:]}"
    return json.loads(out.read_text())


@functools.lru_cache(maxsize=None)
def port_trees(arch):
    """{tree name: the port's tree on meta}, named as the dump names them."""
    cfg = get_config(arch)
    params = M.init_params(cfg, None, META)
    trees = {"params": params, "opt": adamw.init(params)}
    for name in SHAPES:
        trees[f"batch/{name}"] = cfg.input_specs(name)
    for name in CACHE_SHAPES:
        if name in cfg.supported_shapes:
            trees[f"cache/{name}"] = M.init_cache(cfg, SHAPES[name][1], cfg.cache_len(name),
                                                  device=META)
    return trees


def port_specs(rules, trees):
    """{tree name: {path: spec}} of the port's rules, named as the dump."""
    out = {"params": rules.params_specs(trees["params"]),
           "opt": rules.opt_specs(trees["opt"], zero1=False),
           "opt_zero1": rules.opt_specs(trees["opt"], zero1=True)}
    for k, t in trees.items():
        if k.startswith("batch/"):
            out[k] = rules.batch_specs(t)
        elif k.startswith("cache/"):
            out[k] = rules.cache_specs(t, SHAPES[k.split("/", 1)[1]][1])
    return out


def as_spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def reckoned_bytes(shape, dtype, spec, sizes):
    """One device's bytes of a leaf under a JAX spec (an even split)."""
    n = 1
    for s, e in zip(shape, spec):
        axes = e if isinstance(e, tuple) else (e,) if e else ()
        assert s % math.prod(sizes[a] for a in axes) == 0, (shape, spec)
        n *= s // math.prod(sizes[a] for a in axes)
    return n * np.dtype({"bfloat16": "float16"}.get(dtype, dtype)).itemsize


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(jax_dump, arch, mesh_name):
    want = jax_dump["configs"][arch]["specs"][mesh_name]
    shape, axes = MESHES[mesh_name]
    with mesh_scope(shape, axes) as mesh:
        got = port_specs(ShardingRules(get_config(arch), mesh), port_trees(arch))
    assert list(got) == list(want)
    for tree, specs in want.items():
        assert list(got[tree].items()) == [(k, as_spec(v)) for k, v in specs.items()], tree


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_leaf_shapes_equal_jax(jax_dump, arch):
    want = jax_dump["configs"][arch]["leaves"]
    trees = port_trees(arch)
    assert list(trees) == list(want)
    for tree, leaves in want.items():
        got = [(k, [list(jax_shape(leaf)), str(leaf[0].dtype if isinstance(leaf, list)
                                               else leaf.dtype).removeprefix("torch.")])
               for k, leaf in keyed_leaves(trees[tree])]
        assert got == list(leaves.items()), tree
        for _, leaf in keyed_leaves(trees[tree]):
            assert all(t.device.type == "meta" for t in (leaf if isinstance(leaf, list)
                                                         else [leaf]))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_bytes_equal_jax(jax_dump, arch, mesh_name):
    dump = jax_dump["configs"][arch]
    shape, axes = MESHES[mesh_name]
    sizes = dict(zip(axes, shape))
    trees = port_trees(arch)
    with mesh_scope(shape, axes) as mesh:
        rules = ShardingRules(get_config(arch), mesh)
        for tree, specs in port_specs(rules, trees).items():
            leaves = dump["leaves"]["opt" if tree == "opt_zero1" else tree]
            want = sum(reckoned_bytes(leaves[k][0], leaves[k][1], as_spec(v), sizes)
                       for k, v in dump["specs"][mesh_name][tree].items())
            placed = rules.place(trees["opt" if tree == "opt_zero1" else tree], specs)
            assert local_bytes(placed.values()) == want, tree


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grouped_moe_routes_and_combines_as_jax(jax_dump, arch, G):
    dump = jax_dump["moe"][arch]
    want = dump[str(G)]
    cfg = get_config(arch).reduced()

    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return torch.tensor(node, dtype=torch.float32)

    p, x = tensors(dump["p"]), tensors(dump["x"])
    B, S, d = x.shape
    T = B * S
    with logical_mesh({"data": G, "model": 1}):
        assert dispatch_groups(B, T) == G
        y = moe_ffn(p, x, cfg)
    assert dispatch_groups(B, T) == 1  # outside the mesh: one group
    Tg = T // G
    assert capacity(cfg, Tg) == want["C"]
    xg = x.reshape(G, Tg, d)
    for g in range(G):
        tok, sorted_t, _, keep, slot = _route_group(xg[g], p["gate"], cfg, want["C"])
        assert tok.tolist() == want["tok_for_slot"][g]
        assert sorted_t.tolist() == want["sorted_t"][g]
        assert keep.tolist() == want["keep"][g]
        assert slot.tolist() == want["slot"][g]
    jy = np.asarray(want["y"], dtype=np.float32)
    assert y.shape == jy.shape
    err = float(np.max(np.abs(y.numpy() - jy)))
    assert err <= MOE_REL * float(np.max(np.abs(jy))), err
