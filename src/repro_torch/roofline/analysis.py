"""Roofline terms of a dry-run cell, on a hardware record.

The port's copy of the part of ``repro.roofline.analysis`` that reads no
XLA output. Three terms per (arch x shape x mesh):

    compute    = FLOPs_per_device            / peak_FLOPs_per_chip
    memory     = bytes_per_device            / HBM_bw_per_chip
    collective = collective_bytes_per_device / link_bw_per_chip

Collective bytes follow the standard ring-algorithm wire models, with g
the size of the group and ``out_bytes`` the bytes of one device's output:

    all-gather        (g-1)/g * out_bytes
    all-reduce        2*(g-1)/g * out_bytes
    reduce-scatter    (g-1) * out_bytes        (out is the scattered shard)
    all-to-all        (g-1)/g * out_bytes
    collective-permute out_bytes

The hardware is an argument of :func:`analyze_costs`: :data:`H100_SXM` by
default, :data:`TPU_V5E` for the JAX package's constants. Not ported: the
HLO parsers ``collective_bytes_per_device`` and ``collective_op_counts``
and ``cost_analysis_dict`` / ``extract_costs``, which read the optimized
HLO text and ``compiled.cost_analysis()`` of an XLA executable. The port
has no such executable: ``launch.dryrun`` counts its FLOPs with
``torch.utils.flop_counter`` and reckons its bytes and collectives from
the sharding rules.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..configs.base import resolve_shape


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # bf16 per chip, dense
    hbm_bw: float  # bytes/s per chip
    link_bw: float  # bytes/s per chip, one direction


# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU datasheet:
# 989 TFLOP/s bf16 dense on the tensor cores (1,979 with sparsity), 3.35
# TB/s of HBM3, and 900 GB/s of fourth-generation NVLink in both
# directions together, so 450 GB/s each way.
H100_SXM = Hardware("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
# TPU v5e, the JAX package's constants: 197 TFLOP/s bf16, 819 GB/s HBM,
# 50 GB/s per ICI link.
TPU_V5E = Hardware("tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


def ring_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Wire bytes per device of one collective of ``kind`` over a group of
    ``g`` devices whose output on each device is ``out_bytes``."""
    g = max(int(g), 1)
    if kind == "all-reduce":
        return 2 * (g - 1) / g * out_bytes
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g * out_bytes
    if kind == "reduce-scatter":
        return (g - 1) * out_bytes
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collective_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    memory_stats: Dict[str, float]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def extrapolate_costs(
    c1: Dict[str, float], c2: Dict[str, float], n_layers: int
) -> Dict[str, float]:
    """Layer-homogeneous extrapolation: cost(L) = c1 + (L-1)*(c2-c1).

    c1/c2 are the costs of 1-layer/2-layer models. Exact for stacks whose
    layers are identical (all ten assigned archs as configured)."""
    out = {}
    for k in c1:
        per_layer = c2[k] - c1[k]
        out[k] = c1[k] + (n_layers - 1) * max(per_layer, 0.0)
    return out


def analyze_costs(costs: Dict[str, float], *, arch: str, shape: str, mesh_name: str,
                  chips: int, model_flops_global: float, memory_stats: Dict[str, float],
                  corrections: Optional[Dict[str, float]] = None,
                  hardware: Hardware = H100_SXM) -> RooflineReport:
    flops_dev = costs["flops"]
    bytes_dev = costs["bytes"]
    if corrections:
        flops_dev += corrections.get("flops", 0.0)
        bytes_dev += corrections.get("bytes", 0.0)
    coll = {k.split("/", 1)[1]: v for k, v in costs.items() if k.startswith("coll/")}
    coll_total = sum(coll.values())
    compute_s = flops_dev / hardware.peak_flops
    memory_s = bytes_dev / hardware.hbm_bw
    collective_s = coll_total / hardware.link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops_global / (flops_dev * chips) if flops_dev else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes=coll_total, collective_breakdown=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops_global,
        useful_ratio=useful, memory_stats=memory_stats,
    )


def recurrent_scan_correction(cfg, shape_name, chips: int) -> Dict[str, float]:
    """Analytic per-device FLOPs/bytes of the time-step recurrences (mamba
    / mLSTM / sLSTM), which XLA's cost_analysis counts exactly once inside
    a ``lax.scan``: the JAX package adds them to its counted FLOPs. (The
    port's FLOP counter sees every time step, so the port's dry run reports
    them beside its count and adds nothing.)

    Only the train/prefill shapes need this (decode is a single step, fully
    counted). Costs are per full sequence, batch-sharded over the dp axes.
    """
    seq, gbatch, kind = resolve_shape(shape_name)
    if kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    # tokens per device (batch shards over dp; model axis replicates tokens)
    dp = max(chips // 16, 1)  # model axis is 16 on the production meshes
    tokens = seq * gbatch / dp
    mult = 3.0 if kind == "train" else 1.0  # fwd + ~2x bwd
    flops = 0.0
    bytes_ = 0.0
    if cfg.hybrid_parallel_ssm and cfg.ssm_state:
        di = (cfg.ssm_inner or cfg.d_model) / 16  # di sharded over model
        N = cfg.ssm_state
        per_tok = 9.0 * di * N
        flops += cfg.n_layers * per_tok * tokens
        bytes_ += cfg.n_layers * 8.0 * di * N * tokens  # state read+write f32
    if cfg.family == "ssm" and cfg.block_types:
        H = cfg.n_heads
        hd_m = 2 * cfg.d_model / H
        hd_s = cfg.d_model / H
        n_m = sum(1 for t in cfg.block_types if t == "m")
        n_s = len(cfg.block_types) - n_m
        flops += n_m * 5.0 * H * hd_m * hd_m * tokens
        bytes_ += n_m * 8.0 * H * hd_m * hd_m * tokens
        flops += n_s * (8.0 * H * hd_s * 4 * hd_s + 20.0 * cfg.d_model) * tokens
        bytes_ += n_s * 16.0 * cfg.d_model * tokens
    return {"flops": flops * mult, "bytes": bytes_ * mult}


def model_flops(cfg, shape_name) -> float:
    """MODEL_FLOPS: 6*N*D for training (N=active params), 2*N*D for
    prefill, 2*N per sequence for a decode step."""
    seq, gbatch, kind = resolve_shape(shape_name)
    counts = cfg.param_count()
    n_active = counts["active"]
    if kind == "train":
        return 6.0 * n_active * seq * gbatch
    if kind == "prefill":
        return 2.0 * n_active * seq * gbatch
    return 2.0 * n_active * 1 * gbatch  # decode: one token per sequence
