"""Sharding rules: parameters, optimizer state, batches, decode caches.

The port's copy of ``repro.launch.sharding``, with the same policy:

* TP over ``model``: attention q/o sharded on the head dim when
  ``H % tp == 0`` (k/v when ``Hkv % tp == 0``; otherwise replicated, the
  GQA kv<tp case of starcoder2), the MLP hidden dim, MoE experts (EP when
  ``E % tp == 0``, expert-TP otherwise), vocab-sharded embeddings and head.
* DP over ``(pod, data)``: batches; ZeRO-1 also shards each optimizer
  moment's first free dim over ``data``.
* Decode caches: the kv-head dim on ``model`` when divisible, else the
  cache's sequence dim; the batch on the dp axes when divisible.

Every rule is guarded by a divisibility check: a dim that does not divide
evenly stays replicated.

A rule returns a spec: one entry per tensor dim, each ``None``, an axis
name or a tuple of axis names, the entries of the JAX package's
``PartitionSpec`` for the same leaf. Rules are keyed by the leaf's JAX
path (``models.convert.keyed_leaves``: ``layers/attn/wq``,
``mu/blocks/0/up``, ``kv/k``) and read its JAX shape, layers stacked on a
leading L axis; the port's trees hold a layer leaf as a list of per-layer
tensors, and ``keyed_leaves`` gives it as that list, whose JAX shape is
(L, ...) of the layer's. :meth:`ShardingRules.placements` turns a spec
into DTensor placements (``Shard(d)`` or ``Replicate()`` per mesh dim),
:meth:`ShardingRules.place` lays a tree's leaves on the mesh as DTensors
(a layer leaf stacked first, as JAX holds it), and
:meth:`ShardingRules.layer_placements` gives the placements of one layer's
tensor, the stacked spec without its L entry.

The JAX package's ``band_shardings`` / ``band_put`` place the band-sharded
ILU pipeline's tables; the port's counterpart is ``core/dist.py``, whose
band owners each hold their own blocks on their own rank.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..models.convert import keyed_leaves
from .mesh import mesh_axis_sizes

Spec = Tuple  # one entry per dim: None, an axis name, or a tuple of axis names


def jax_shape(leaf) -> tuple:
    """The JAX shape of a ``keyed_leaves`` leaf: a list of per-layer
    tensors is (L, ...) of the layer's shape."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


class ShardingRules:
    def __init__(self, cfg, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = mesh_axis_sizes(mesh)
        self.tp = self.sizes.get("model", 1)
        self.dp_axes = tuple(a for a in ("pod", "data") if a in self.sizes)

    # -- helpers -----------------------------------------------------------
    def _ok(self, size, axis="model") -> bool:
        n = self.sizes.get(axis, 1)
        return size % n == 0 and n > 1

    def _dp_ok(self, size) -> bool:
        n = math.prod(self.sizes[a] for a in self.dp_axes)
        return n > 1 and size % n == 0

    def _dp_entry(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def batch_spec(self, batch_size: int) -> Spec:
        return (self._dp_entry(),) if self._dp_ok(batch_size) else (None,)

    # -- parameters ---------------------------------------------------------
    def param_spec(self, path: str, shape: tuple) -> Spec:
        cfg = self.cfg
        tp_heads = cfg.n_heads % self.tp == 0
        tp_kv = cfg.n_kv_heads % self.tp == 0
        r = len(shape)
        none = (None,) * r

        def on(dim, cond=True):
            spec = [None] * r
            if cond and self._ok(shape[dim]):
                spec[dim] = "model"
            return tuple(spec)

        name = path.rsplit("/", 1)[-1]
        if name == "embed":
            return ("model", None) if self._ok(shape[0]) else (None, None)
        if name == "lm_head":
            return on(-1)
        if name in ("wq", "bq"):
            return on(-1, tp_heads)
        if name in ("wk", "wv", "bk", "bv"):
            return on(-1, tp_kv)
        if name == "wo":
            return on(-2, tp_heads)
        # MLA
        if name in ("w_uk", "w_uv"):
            return on(-1, tp_heads)
        if name == "w_dkv":
            return none
        # MoE expert banks: (L, E, d, f) / (L, E, f, d); gate replicated
        if "moe" in path and name in ("w_gate", "w_up", "w_down"):
            e_dim = r - 3  # the E axis (layers stacked or not)
            if cfg.n_routed_experts and shape[e_dim] == cfg.n_routed_experts:
                if self._ok(cfg.n_routed_experts):
                    spec = [None] * r
                    spec[e_dim] = "model"
                    return tuple(spec)  # EP
                # expert-TP: shard the hidden f dim
                return on(r - 1 if name in ("w_gate", "w_up") else r - 2)
        if name == "gate":
            return none
        # dense MLP (also MoE shared experts)
        if name in ("w_gate", "w_up"):
            return on(-1)
        if name == "w_down":
            return on(-2)
        # SSM
        if name in ("in_proj", "w_dt2"):
            return on(-1)
        if name in ("out_proj", "w_dt1", "a_log", "d_skip", "dt_bias", "conv_w", "w_bc"):
            # di-indexed: shard the first dim of size di, where it divides
            di = cfg.ssm_inner or cfg.d_model
            for i, s in enumerate(shape):
                if s == di and self._ok(s):
                    return on(i)
            return none
        # xLSTM
        if name in ("up", "w_gates", "wq_x", "wk_x", "wv_x"):
            return on(-1)
        if name == "down":
            return on(-2)
        # norms, biases, r_gates, w_if, everything else: replicated
        return none

    def params_specs(self, params) -> Dict[str, Spec]:
        return {k: self.param_spec(k, jax_shape(leaf)) for k, leaf in keyed_leaves(params)}

    # -- optimizer state -----------------------------------------------------
    def opt_spec(self, path: str, shape: tuple, zero1: bool = False) -> Spec:
        """A moment follows its parameter; ZeRO-1 also shards its first
        free (unsharded, divisible) dim over ``data``."""
        spec = list(self.param_spec(path, shape))
        if zero1:
            dsize = self.sizes.get("data", 1)
            for i, s in enumerate(shape):
                if spec[i] is None and dsize > 1 and s % dsize == 0 and s >= dsize:
                    spec[i] = "data"
                    break
        return tuple(spec)

    def opt_specs(self, opt_state, zero1: bool = False) -> Dict[str, Spec]:
        return {k: self.opt_spec(k, jax_shape(leaf), zero1)
                for k, leaf in keyed_leaves(opt_state)}

    # -- batches -------------------------------------------------------------
    def batch_specs(self, batch) -> Dict[str, Spec]:
        return {k: self.batch_spec(leaf.shape[0]) + (None,) * (leaf.dim() - 1)
                for k, leaf in keyed_leaves(batch)}

    # -- decode caches ---------------------------------------------------------
    def cache_spec(self, path: str, shape: tuple, batch: int) -> Spec:
        cfg = self.cfg
        tp_kv = cfg.n_kv_heads % self.tp == 0 and self.tp > 1
        r = len(shape)
        spec = [None] * r
        name = path.rsplit("/", 1)[-1]
        # (L, B, ...) stacked caches: B at axis 1; xlstm states (B, ...)
        b_axis = 1 if r >= 2 and shape[0] == cfg.n_layers else 0
        if self._dp_ok(batch) and shape[b_axis] == batch:
            spec[b_axis] = self._dp_entry()
        if name in ("k", "v", "cross_k", "cross_v"):  # (L,B,Lc,Hkv,hd)
            if tp_kv:
                spec[3] = "model"
            elif self._ok(shape[2]):
                spec[2] = "model"  # sequence-sharded decode attention
        elif name in ("c", "r"):  # MLA latent cache (L,B,Lc,r)
            if self._ok(shape[2]):
                spec[2] = "model"
        elif name == "h" and r == 4:  # ssm state (L,B,di,N)
            if self._ok(shape[2]):
                spec[2] = "model"
        elif r >= 3:  # xlstm matrix memories etc.
            for i in range(r - 1, b_axis, -1):
                if self._ok(shape[i]):
                    spec[i] = "model"
                    break
        return tuple(spec)

    def cache_specs(self, cache, batch: int) -> Dict[str, Spec]:
        return {k: self.cache_spec(k, jax_shape(leaf), batch) for k, leaf in keyed_leaves(cache)}

    # -- placements ------------------------------------------------------------
    def placements(self, spec: Spec) -> tuple:
        """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)``
        where the mesh axis shards tensor dim d, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in self.mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def layer_placements(self, spec: Spec) -> tuple:
        """The placements of one layer's tensor of a stacked leaf of
        ``spec``: the spec without its leading L entry. A mesh axis that
        splits L (ZeRO-1 over ``data``) deals whole layers to its ranks, in
        contiguous runs of L / size, and holds each layer's tensor
        replicated within a run's ranks."""
        return self.placements(spec[1:])

    def place(self, tree, specs: Dict[str, Spec]) -> Dict[str, object]:
        """{path: DTensor}: each leaf of ``tree`` (a layer leaf stacked)
        distributed on the mesh by its spec."""
        from torch.distributed.tensor import distribute_tensor

        out = {}
        for k, leaf in keyed_leaves(tree):
            t = torch.stack(leaf) if isinstance(leaf, list) else leaf
            out[k] = distribute_tensor(t, self.mesh, self.placements(specs[k]))
        return out


def local_bytes(dtensors) -> int:
    """Bytes one device holds of the DTensors ``dtensors``: their local
    shards."""
    return sum(d.to_local().numel() * d.to_local().element_size() for d in dtensors)
