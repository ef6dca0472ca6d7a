"""Multi-pod dry run: every (arch x shape x mesh) cell, built on ``meta``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_out

The port's counterpart of ``repro.launch.dryrun``, with its flags. Where
the JAX package lowers and compiles each cell for a TPU mesh and reads
XLA's memory and cost analyses, the port allocates nothing: every tensor
lies on the ``meta`` device (shapes and dtypes only), and the mesh is a
``DeviceMesh`` over a fake process group (``launch.mesh``). For each cell:

1. **Pass A, placement.** The parameters, the AdamW moments (train), the
   batch (``ModelConfig.input_specs``) and the decode cache (decode) are
   made on ``meta`` and placed as DTensors by ``ShardingRules``; the
   per-device argument bytes are those of their local shards, split into
   parameters, optimizer, batch and cache, and the output bytes are
   reckoned the same way. ``temp_bytes`` is the peak that
   ``torch.distributed._tools.mem_tracker.MemTracker`` sees in one
   data-parallel rank's step (its share of the batch, through the port's
   unsharded layers) at 1 and 2 layers, extrapolated to the full depth,
   less the parameters, moments, batch and cache the rank holds before the
   step; it is ``null`` where the tracker itself fails (a fault of the
   step raises), and ``temp_bytes_source`` says which. The layers are
   unsharded, so it is a ceiling where the model axis would split the
   activations, and ``fits_hbm_80g`` (``fits_hbm``) is ``null`` where only
   that ceiling says no.
2. **Pass B, cost.** As the JAX package's: the config with
   ``attn_unroll=True`` (one attention block per query chunk) at 1 and 2
   layers, its step (train with AdamW, prefill or decode) run on ``meta``
   under ``torch.utils.flop_counter.FlopCounterMode`` inside
   ``logical_mesh`` (so the MoE routes in the mesh's dispatch groups),
   its FLOPs extrapolated to the full depth by ``extrapolate_costs``; the
   bytes and collectives are pass A's, exact at the full depth.
   ``--skip-cost-pass`` counts no FLOPs (``cost_pass: false``).

The three roofline terms (``roofline.analysis``, on the H100 by default)
are **floors**, and the JSON says so (``"terms": "floor"``): the counter
counts only matmul-class ops (mm, bmm, addmm, baddbmm, convolutions,
attention), split evenly over the chips (``"flops_split": "even"``, where
XLA counts the compute repeated on replicated attention heads); the bytes
are the arguments read once; the collectives are what the placements force
on a train step (the gradient all-reduce over the data axes, and with
ZeRO-1 the all-gather of the updated parameters), and the tensor-parallel
activation traffic is not counted. ``recurrent_scan_correction`` goes into
the JSON as the JAX package reports it, and is not added: the counter has
seen every time step's products.

``dry_run(cfg, shape, mesh_shape, axes, opts)`` is the function behind the
CLI; it also takes a shape given as (seq, batch, kind), where the CLI takes
only ``SHAPES`` names.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from ..configs.base import SHAPES, resolve_shape
from ..roofline.analysis import (H100_SXM, analyze_costs, extrapolate_costs, model_flops,
                                 recurrent_scan_correction, ring_bytes)

HBM_BYTES = 80e9  # one H100's memory
META = torch.device("meta")


def _state(cfg, kind, gbatch, cache_len):
    """The cell's model, optimizer state, batch and cache on ``meta``."""
    from ..models import model as M
    from ..models.convert import param_tree
    from ..optim import adamw

    model = M.Transformer(cfg, device=META, params=M.init_params(cfg, None, META))
    params = param_tree(model)
    opt = adamw.init(params) if kind == "train" else None
    cache = M.init_cache(cfg, gbatch, cache_len, device=META) if kind == "decode" else None
    return model, params, opt, cache


def _run_step(cfg, kind, model, opt, batch, cache, microbatches=1):
    from ..optim import adamw
    from ..train.step import make_prefill_step, make_serve_step, make_train_step

    if kind == "train":
        return make_train_step(cfg, adamw.AdamWConfig(), microbatches=microbatches)(
            model, opt, batch)
    if kind == "prefill":
        return make_prefill_step(cfg)(model, batch)
    return make_serve_step(cfg)(model, cache, batch["tokens"], frames=batch.get("frames"))


def count_flops(cfg, shape, axis_sizes=None, microbatches=1) -> float:
    """Global FLOPs of one step of ``shape`` on ``meta``, as
    ``FlopCounterMode`` counts them, inside ``logical_mesh(axis_sizes)``."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.common import logical_mesh

    seq, gbatch, kind = resolve_shape(shape)
    model, _, opt, cache = _state(cfg, kind, gbatch, cfg.cache_len(shape))
    batch = cfg.input_specs(shape)
    with logical_mesh(axis_sizes or {}), FlopCounterMode(display=False) as fc:
        _run_step(cfg, kind, model, opt, batch, cache, microbatches)
    return float(fc.get_total_flops())


def _depth(cfg, nl, **kw):
    """``cfg`` cut to ``nl`` layers (the JAX dry run's cost configs)."""
    kw["n_layers"] = nl
    if cfg.block_types:
        kw["block_types"] = (cfg.block_types * nl)[:nl]
    if cfg.encoder_layers:
        kw["encoder_layers"] = nl
    return dataclasses.replace(cfg, **kw)


def _batch_share(rules, gbatch) -> int:
    """The sequences of a global batch of ``gbatch`` one device holds."""
    lead = rules.batch_spec(gbatch)[0]
    axes = lead if isinstance(lead, tuple) else (lead,) if lead else ()
    return gbatch // math.prod(rules.sizes[a] for a in axes)


def _placement(cfg, shape, rules, zero1):
    """Pass A's per-device bytes of ``cfg``'s arguments, by DTensor local
    shards: {param, optimizer, batch, cache, argument, output} and the
    train step's collective bytes per device."""
    from .sharding import local_bytes

    seq, gbatch, kind = resolve_shape(shape)
    _, params, opt, cache = _state(cfg, kind, gbatch, cfg.cache_len(shape))
    batch = cfg.input_specs(shape)
    p_specs = rules.params_specs(params)
    p_placed = rules.place(params, p_specs)
    out = {"param_bytes": local_bytes(p_placed.values()), "optimizer_bytes": 0,
           "cache_bytes": 0,
           "batch_bytes": local_bytes(rules.place(batch, rules.batch_specs(batch)).values())}
    coll = {}
    if kind == "train":
        o_specs = rules.opt_specs(opt, zero1=zero1)
        out["optimizer_bytes"] = local_bytes(rules.place(opt, o_specs).values())
        # every gradient is all-reduced over the data-parallel axes; with
        # ZeRO-1 each parameter whose moments are split over ``data`` is
        # all-gathered over it after its update
        dp = math.prod(rules.sizes[a] for a in rules.dp_axes)
        coll["coll/all-reduce"] = ring_bytes("all-reduce", out["param_bytes"], dp)
        gathered = local_bytes(v for k, v in p_placed.items()
                               if "data" in o_specs["mu/" + k] and "data" not in p_specs[k])
        coll["coll/all-gather"] = ring_bytes("all-gather", gathered, rules.sizes.get("data", 1))
        outputs = out["param_bytes"] + out["optimizer_bytes"] + 3 * 4  # + loss, norm, lr
    else:
        share = _batch_share(rules, gbatch)
        outputs = share * cfg.vocab * cfg.act_dtype.itemsize  # the last position's logits
        if kind == "decode":
            c_placed = rules.place(cache, rules.cache_specs(cache, gbatch))
            out["cache_bytes"] = local_bytes(c_placed.values())
            outputs += share * 4 + out["cache_bytes"]  # + next tokens, cache
    out["argument_bytes"] = (out["param_bytes"] + out["optimizer_bytes"] + out["batch_bytes"]
                             + out["cache_bytes"])
    out["output_bytes"] = outputs
    return out, coll


def _temp_bytes(cfg, shape, rules, microbatches):
    """One data-parallel rank's step at 1 and 2 layers under MemTracker:
    the peak less what the rank holds before the step (its parameters,
    moments, batch and cache, all tracked from the start), extrapolated to
    the full depth. The layers are unsharded: a ceiling where the model
    axis would split the activations."""
    from torch.distributed._tools.mem_tracker import MemTracker

    seq, gbatch, kind = resolve_shape(shape)
    local = (seq, _batch_share(rules, gbatch), kind)
    temps = []
    for nl in (1, 2):
        c = _depth(cfg, nl)
        model, _, opt, cache = _state(c, kind, local[1], c.cache_len(shape))
        batch = c.input_specs(local)
        tracker = MemTracker()
        tracker.track_external(model, *(t for tree in (opt, batch, cache) if tree
                                        for t in _leaves(tree)))
        held = _total(tracker.get_tracker_snapshot())
        with tracker:
            _run_step(c, kind, model, opt, batch, cache, microbatches)
        temps.append(float(_total(tracker.get_tracker_snapshot("peak")) - held))
    return extrapolate_costs({"t": temps[0]}, {"t": temps[1]}, cfg.n_layers)["t"]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


def _total(snapshot) -> int:
    return sum(v.get("Total", 0) for v in snapshot.values())


def _tracker_failed(e: BaseException) -> bool:
    """True where ``e`` was raised inside MemTracker itself (its innermost
    frame lies in ``torch.distributed._tools``), not by the step it runs."""
    tb = e.__traceback__
    while tb is not None and tb.tb_next is not None:
        tb = tb.tb_next
    path = tb.tb_frame.f_code.co_filename if tb is not None else ""
    return os.path.join("distributed", "_tools", "") in path


def fits_hbm(argument_bytes, temp_bytes, tp) -> tuple:
    """(verdict, what it rests on) for one device's ``HBM_BYTES``: the
    arguments are exact per device and ``temp_bytes`` a ceiling that
    ignores the model axis's split of the activations, so the verdict is
    False from the arguments alone, True from arguments + ceiling, False
    from arguments + ceiling only where the model axis is 1, and None
    otherwise."""
    if argument_bytes >= HBM_BYTES:
        return False, "arguments alone"
    if temp_bytes is None:
        return None, "temp not measured; the arguments alone fit"
    if argument_bytes + temp_bytes < HBM_BYTES:
        return True, "arguments + temp ceiling"
    if tp == 1:
        return False, "arguments + temp (model axis 1: the ceiling is the step as run)"
    return None, (f"arguments + temp ceiling >= {HBM_BYTES:.0f} B, but the ceiling ignores the "
                  f"model axis ({tp}) that splits the activations")


def dry_run(cfg, shape, mesh_shape, axes, opts=None, hardware=H100_SXM) -> dict:
    """One cell: ``cfg`` at ``shape`` (a ``SHAPES`` name or (seq, batch,
    kind)) on a mesh of ``mesh_shape`` named ``axes``. Returns the JSON
    record (``status: ok``)."""
    from .mesh import mesh_axis_sizes, mesh_scope
    from .sharding import ShardingRules

    opts = dict(opts or {})
    seq, gbatch, kind = resolve_shape(shape)
    shape_name = shape if isinstance(shape, str) else f"{kind}_s{seq}_b{gbatch}"
    zero1 = bool(opts.get("zero1"))
    microbatches = int(opts.get("microbatches") or 1)
    chips = math.prod(mesh_shape)
    mesh_name = "x".join(str(s) for s in mesh_shape)
    with mesh_scope(mesh_shape, axes) as mesh:
        rules = ShardingRules(cfg, mesh)
        sizes = mesh_axis_sizes(mesh)

        # ---- pass A: placement and memory ---------------------------------
        t0 = time.time()
        mem, coll = _placement(cfg, shape, rules, zero1)
        try:
            mem["temp_bytes"] = _temp_bytes(cfg, shape, rules, microbatches)
            temp_source = ("MemTracker peak of one data-parallel rank's step (its batch share, "
                           "unsharded layers: a ceiling) at 1 and 2 layers, extrapolated, less "
                           "the parameters, moments, batch and cache it holds before the step")
        except Exception as e:  # the tracker is a private torch tool; the step's faults raise
            if not _tracker_failed(e):
                raise
            mem["temp_bytes"] = None
            temp_source = f"not measured: MemTracker raised {type(e).__name__}: {e}"
        t_a = time.time() - t0

        # ---- pass B: counted FLOPs of the cost form, extrapolated ----------
        t1 = time.time()
        costs = {"flops": 0.0, "bytes": float(mem["argument_bytes"]), **coll}
        if not opts.get("skip_cost_pass"):
            c1, c2 = ({"flops": count_flops(_depth(cfg, nl, scan_layers=False, attn_unroll=True),
                                            shape, sizes) / chips} for nl in (1, 2))
            costs.update(extrapolate_costs(c1, c2, cfg.n_layers))
        t_b = time.time() - t1

    corr = recurrent_scan_correction(cfg, shape, chips)
    rep = analyze_costs(costs, arch=cfg.arch, shape=shape_name, mesh_name=mesh_name,
                        chips=chips, model_flops_global=model_flops(cfg, shape),
                        memory_stats=mem, hardware=hardware)
    out = rep.to_json()
    fits, fits_from = fits_hbm(mem["argument_bytes"], mem["temp_bytes"], sizes.get("model", 1))
    out.update(
        status="ok", kind=kind, seq=seq, batch=gbatch, pass_a_s=round(t_a, 1),
        pass_b_s=round(t_b, 1), multi_pod="pod" in axes, opts=opts,
        hardware=dataclasses.asdict(hardware), terms="floor", flops_split="even",
        flops_global=costs["flops"] * chips, cost_pass=not opts.get("skip_cost_pass"),
        scan_correction=corr, temp_bytes_source=temp_source,
        fits_hbm_80g=fits, fits_hbm_80g_from=fits_from,
    )
    return out


def build_cell(arch, shape_name, multi_pod, opts):
    """The CLI's cell: ``arch`` at ``shape_name`` on the production mesh,
    with the flags' changes to the config; a skipped record where the
    config does not support the shape."""
    from ..configs import get_config
    from .mesh import production_shape

    cfg = get_config(arch)
    if opts.get("remat"):
        cfg = dataclasses.replace(cfg, remat=opts["remat"])
    if opts.get("q_chunk"):
        cfg = dataclasses.replace(cfg, q_chunk=opts["q_chunk"], kv_chunk=opts["q_chunk"])
    if opts.get("window") and cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=opts["window"])
    if shape_name not in cfg.supported_shapes:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "full-attention arch: 512k dense KV decode excluded "
                          "(DESIGN.md §4)"}
    return dry_run(cfg, shape_name, *production_shape(multi_pod), opts=opts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[None, *SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="all (arch x shape) cells")
    ap.add_argument("--out", default="dryrun_out")
    ap.add_argument("--remat", default=None, choices=[None, "none", "dots", "full"])
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--skip-cost-pass", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    from ..configs import ARCHS

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    opts = {"remat": args.remat, "zero1": args.zero1,
            "microbatches": args.microbatches, "q_chunk": args.q_chunk,
            "window": args.window, "skip_cost_pass": args.skip_cost_pass}
    failures = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{'pod2' if args.multi_pod else 'pod1'}"
        if args.tag:
            tag += f"__{args.tag}"
        print(f"=== {tag} ===", flush=True)
        try:
            res = build_cell(arch, shape, args.multi_pod, opts)
        except Exception as e:
            traceback.print_exc()
            res = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=2)
        print(json.dumps({k: res.get(k) for k in
                          ("status", "bottleneck", "compute_s", "memory_s",
                           "collective_s", "useful_ratio", "fits_hbm_80g",
                           "pass_a_s", "pass_b_s", "reason", "error")}),
              flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
