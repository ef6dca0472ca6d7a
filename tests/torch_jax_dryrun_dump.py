"""Subprocess body: the JAX package's dry-run side dumped to JSON, for the
port's tests to hold ``repro_torch.launch.sharding`` and the grouped MoE to.

    JAX_PLATFORMS=cpu python tests/torch_jax_dryrun_dump.py OUT.json

XLA's host platform gets 512 devices (set before jax is imported). For
every config at its published size it writes:

* ``leaves``: {tree: {path: [shape, dtype]}} of ``jax.eval_shape`` of the
  parameters, the AdamW state, every ``SHAPES`` batch and the decode
  caches of ``decode_32k`` / ``long_500k`` where the config supports them;
* ``specs``: {mesh: {tree: {path: PartitionSpec entries}}} of
  ``ShardingRules`` on the (16,16), (2,16,16), (2,4) and (1,1) meshes, the
  moments with ``zero1`` off and on (an entry: null, an axis name, or a
  list of axis names).

and ``moe``: for reduced qwen2-moe and deepseek in float32, seeded numpy
parameters and input (``p``, ``x``), and under a (2,1) and a (4,1) mesh
``moe_ffn``'s output and each group's routing (``_route_group``).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import json  # noqa: E402

import numpy as np  # noqa: E402

MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "2x4": (2, 4), "1x1": (1, 1)}
CACHE_SHAPES = ("decode_32k", "long_500k")
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
MOE_B, MOE_S = 4, 8


def _entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _mesh(shape):
    from repro.launch.mesh import make_host_mesh, make_production_mesh

    if len(shape) == 3:
        return make_production_mesh(multi_pod=True)
    if shape == (16, 16):
        return make_production_mesh()
    return make_host_mesh(*shape)


def dump_config(arch):
    import jax

    from repro.configs import get_config
    from repro.configs.base import SHAPES
    from repro.launch.sharding import ShardingRules, _path_str
    from repro.models import model as M
    from repro.optim import adamw

    cfg = get_config(arch)
    trees = {"params": jax.eval_shape(lambda k: M.init_params(cfg, k), jax.random.PRNGKey(0))}
    trees["opt"] = jax.eval_shape(adamw.init, trees["params"])
    for name in SHAPES:
        trees[f"batch/{name}"] = cfg.input_specs(name)
    for name in CACHE_SHAPES:
        if name in cfg.supported_shapes:
            _, gbatch, _ = SHAPES[name]
            trees[f"cache/{name}"] = jax.eval_shape(
                lambda n=name, b=gbatch: M.init_cache(cfg, b, cfg.cache_len(n)))

    def leaves(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {_path_str(p): [list(x.shape), str(x.dtype)] for p, x in flat}

    def specs(shardings):
        flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
        return {_path_str(p): _entries(s.spec) for p, s in flat}

    out = {"leaves": {k: leaves(t) for k, t in trees.items()}, "specs": {}}
    for mesh_name, shape in MESHES.items():
        rules = ShardingRules(cfg, _mesh(shape))
        sp = {"params": specs(rules.params_shardings(trees["params"])),
              "opt": specs(rules.opt_shardings(trees["opt"], zero1=False)),
              "opt_zero1": specs(rules.opt_shardings(trees["opt"], zero1=True))}
        for k, t in trees.items():
            if k.startswith("batch/"):
                sp[k] = specs(rules.batch_shardings(t))
            elif k.startswith("cache/"):
                sp[k] = specs(rules.cache_shardings(t, SHAPES[k.split("/", 1)[1]][1]))
        out["specs"][mesh_name] = sp
    return out


def moe_inputs(cfg, seed):
    """Seeded float32 parameters of one reduced MoE layer and its input."""
    from repro.models.ffn import padded_experts

    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, padded_experts(cfg), cfg.d_expert

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"gate": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f), "w_down": w(E, f, d)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.d_expert
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs), "w_down": w(fs, d)}
    x = rng.standard_normal((MOE_B, MOE_S, d)).astype(np.float32)
    return p, x


def dump_moe(arch, seed):
    import math

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.mesh import make_host_mesh
    from repro.models.common import logical_mesh
    from repro.models.ffn import _route_group, moe_ffn, padded_experts

    cfg = get_config(arch).reduced()
    p, x = moe_inputs(cfg, seed)
    jp = jax.tree.map(jnp.asarray, p)
    out = {"p": jax.tree.map(lambda a: a.tolist(), p), "x": x.tolist()}
    for G in (2, 4):
        with logical_mesh(make_host_mesh(G, 1)):
            y = np.asarray(jax.jit(lambda pp, xx: moe_ffn(pp, xx, cfg))(jp, jnp.asarray(x)))
        T = MOE_B * MOE_S
        Tg, E, K = T // G, padded_experts(cfg), cfg.moe_top_k
        C = max(int(math.ceil(Tg * K / E * cfg.moe_capacity_factor)), 1)
        routes = [_route_group(jnp.asarray(x.reshape(G, Tg, -1)[g]), jp["gate"], cfg, C)
                  for g in range(G)]
        out[str(G)] = {
            "y": y.tolist(), "C": C,
            "tok_for_slot": [np.asarray(r[0]).tolist() for r in routes],
            "sorted_t": [np.asarray(r[1]).tolist() for r in routes],
            "keep": [np.asarray(r[3]).tolist() for r in routes],
            "slot": [np.asarray(r[4]).tolist() for r in routes],
        }
    return out


def main():
    from repro.configs import ARCHS

    out = {"configs": {a: dump_config(a) for a in ARCHS},
           "moe": {a: dump_moe(a, seed=70 + i) for i, a in enumerate(MOE_ARCHS)}}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    print("OK")


if __name__ == "__main__":
    main()
