#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100 and
the CUDA toolkit. Phases, each printed as it runs (any failure ends the run
with a non-zero exit; nothing is caught):

1. setup — the card's name and power limit (``nvidia-smi``), then the
   build of the kernels from ``src/repro_torch/kernels/csrc``. Worker
   processes start computing the sequential inverse oracles of phase 3b.
2. kernels — at the main path's shapes (``poisson_2d(400)``, ILU(1),
   n = 160,000) each CUDA kernel against its plain PyTorch version on the
   card, bitwise; the median time of CUDA-event runs of each, its bound,
   and its library call where PyTorch has one: a sparse CSR product for
   the SpMV, two for the inverse chain, and two ``torch.triangular_solve``
   calls on sparse CSR factors (cuSPARSE) for the sweep, timed in turns
   with it, single and nb = 4. The sweep and the SpMV are timed in the forms the
   solvers hold (bound once: ``PrecondApply``'s sweep, ``EllOperator``)
   beside their checked entry points and their times before this design;
   the sweep's line also gives its windows R, its layout per sweep (ring,
   staging, shared memory) and its chain floor (the same level loop with
   only a shared-memory exchange and the barrier). The (nb=4, n) forms of
   the three batched kernels likewise, with every row equal to the single
   form's output for it, and the SpMV at nb = 9. factor_wavefront is timed
   in the form the factorizer holds (schedule checked and packed once)
   beside its checked entry point, its time before this design and its
   chain floor (the round loop with one dependent L2 load, the divide and
   the barrier per round). [sweep-window]: the sweep
   bitwise where its shared-memory ring does not cover every gathered
   level (poisson_2d(400) capped, matgen(800, 0.01) ILU(2)).
   [inverse] lines: the inverse plan and value times at full size, and
   W/Z on the card bitwise equal to the CPU's. [tiles] lines: the four
   Block-ILU tile kernels at (128, 128) and at ragged shapes against their
   plain versions (bitwise; the panel product to a stated float32 bound);
   the batched tile solves bitwise on a pivot of path C with 4 tiles per
   list, in place on a pool of the path's size; the bf16 panel update to
   a stated bound; times beside the bound (bytes, and the solves' chain of
   bs steps), the left-looking solves' earlier times, and cuBLAS/cuSOLVER
   calls on one tile and on the pivot's 4 tiles as one panel. The grouped
   panel update (one launch for a pivot's 16 products) bitwise equal to
   one single call per product; each library call's device time from the
   trace, and kernel and library call timed in turns; tile_lu's chain
   floor (its count exchanges alone).
   [large-tiles]: the tile kernels at bs = 241, 256, 300, 512, 513, 640,
   1024 and 2048, whose triangle or tile does not fit in shared memory
   (above 512 a row or column is walked in chunks of 512 entries), bitwise
   against their plain versions, single (ragged) and batched on a pool, in
   place; tile_lu's device time and chain floor at each.
3. factors — the factor values equal the sequential oracle
   ``numeric_ilu_ref``, bitwise, on ``convection_diffusion_2d(32)`` and
   ``poisson_2d(64)`` at k = 0, 1, 2. 3b: the inverse values W/Z computed
   on the card equal the sequential oracle ``inverse_values_ref`` on the
   same fixtures.
4. main path — ``solve_with_ilu`` on ``poisson_2d(400)``, k=1, GMRES(30),
   tol=1e-5, with the kernels' launch counts set to 0 just before and read
   just after; it must converge with a float64 true residual <= 2·tol, and
   its kernels must have been launched. Every path below is read the same
   way.
5. main-inverse — the same solve with ``precond_method="inverse"`` at
   tol=1e-4 (at 1e-5 the float32 inverse method stalls just above the
   tolerance, in the JAX reference too); ``inverse_chain`` must launch and
   ``tri_solve_wavefront`` must not.
6. multi-rhs — ``solve_with_ilu(a, B)`` with B of shape (4, n) whose row 0
   is phase 4's b, with per-lane tolerances: every lane converges, and
   lane 0 equals phase 4's solve bitwise.
7. card against CPU — the same solves on the card and on the CPU (plain
   versions) give the same ``x`` bitwise and the same iteration counts, on
   ``poisson_2d(40)`` and ``convection_diffusion_2d(24)``: the sweep, the
   inverse chain, BiCGSTAB, and a batch of three with per-lane tolerances.
8. bilu — Block-ILU(1) of ``poisson_2d(400)`` at bs = 128, 32, 256, 512
   and 1024 (``repro_torch.core.bilu.bilu``): the host plan and numeric walls,
   and the numeric phase once more under torch.profiler (device busy
   share); the launches of the four tile kernels equal the counts reckoned
   here from the tile pattern (one left and one right solve and one
   grouped panel update per pivot, beside the tiles and products they
   handle); the pool is bitwise equal to the per-tile order run
   through the single-tile kernels on the card; the tile-wise LU residual,
   in float64 on the card over every kept tile, is <= 1e-4·max|A|; every
   scalar ILU(1) position lies in a kept tile. On ``poisson_2d(64)`` the
   card's tiles agree with the CPU's to 1e-4·max|A|.
9. cg — ``solve_with_ilu(poisson_2d(400), b, k=1, method="cg")``: at
   tol=1e-5 it must converge (the float64 true residual is printed), and
   at tol=1e-4 the float64 true residual must be <= 2·tol; on
   ``poisson_2d(64)`` the card's CG equals the CPU's bitwise.
10. topilu and distributed kernels — the TOP-ILU factorization over
    D = 4 band owners on the card (values equal phase 4's factor) as ONE
    persistent ``superstep_factor`` launch, the group's exchanges the
    plan's; ``epoch_sweep``'s one-epoch form and the one-superstep
    ``superstep_factor`` against their plain versions on every epoch and
    superstep checked (poisson_2d(64), D = 1, 2, 4); the persistent
    factorization bitwise equal to the plain per-superstep loop at
    poisson_2d(96) (its plain time taken there), and at full size to the
    per-superstep kernel loop, with its time, device time per superstep,
    bound and chain floor.
    [sharded-sweep]: the whole band-partitioned apply as one persistent
    ``epoch_sweep`` launch (every epoch and in-kernel exchange) against its
    plain version (``ref.sharded_sweep_ref``, exchanges through
    ``BandGroup.exchange``) and against phase 4's single-device apply,
    bitwise, at nb = 1 and 4, gather and ring, at D = 1, 2, 3, 4 on
    ``poisson_2d(64)`` and D = 4 on ``poisson_2d(400)``, with equal
    exchange counts; its time per apply, bound and chain floor per epoch, and the
    two ``torch.triangular_solve`` calls timed in turns with it at D = 4.
11. sharded apply — the band-partitioned apply at D = 1 and D = 4, single
    and nb = 4, bitwise equal to phase 4's apply, one ``epoch_sweep``
    launch per apply.
12. distributed — ``solve_sharded`` at D = 4 (sweep and inverse): ``x``
    bitwise equal to phases 4 and 5, one ``superstep_factor`` launch per
    factorization, and a D = 2 solve on the card equal to the CPU's.
13. wide band — a TOP-ILU factorization whose 32-row band (n = 2100, one
    dense row) is wider than shared memory, on the card in one persistent
    launch that factors the bands in place, bitwise equal to
    ``numeric_ilu_ref``.
14. ordering — the fusion ordering of ``poisson_2d(400)`` for 4 owners of
    32-row bands and the RCM ordering on the host (their seconds); the
    sweep and factor comm models of the natural, fusion and RCM orderings
    must give ``ORDERING_EXPECTED``: levels, epochs, collectives per apply,
    supersteps, halo bytes per superstep, fill.
15. distributed-fusion — path E under that fusion ordering: ``x`` bitwise
    equal to the card's ``solve_with_ilu`` given the same ``Ordering``, one
    ``superstep_factor`` launch per factorization and one ``epoch_sweep``
    launch per apply, device ms per apply and per factorization, one
    profiled restart; the persistent launches on the fused tables bitwise
    equal to their plain versions (``poisson_2d(128)``; the apply also at
    full size).
15b. dist-ranks — the band owners as 4 processes (``run_ranks``, gloo
    ranks all on this card, each exchange staged through pinned host
    memory; ``DistBandGroup``) on ``poisson_2d(128)`` (cut from 400 to make
    room for [llm-train]): the fusion-ordered ``solve_sharded`` for 1
    restart (a gloo collective costs ~6 ms there), with ``x`` on every
    rank bitwise equal to a one-card run of the same call, the same steps,
    restarts, verdict and group counts, one ``superstep_factor`` launch per
    superstep (127) and one ``epoch_sweep`` launch per run of levels;
    the natural factorization by the ring (258 supersteps) bitwise equal
    to the one-card factorization over 4 owners, one sweep apply and one
    inverse apply equal to the one-card applies; per rank the factor,
    solve and collective walls and the bytes staged. Then, in the same
    ranks, [serve-ranks]: the solve service over them (``serve_rank``;
    rank 0 leads a ``SolveService`` over ``ServeConfig(group=...)``, the
    others follow): (i) the inverse method on ``poisson_2d(128)``,
    GMRES(30), 12 requests of two tenants in bursts of 1-4 at tol 1e-4
    around one background value update; (ii) the sweep on the CPU tests'
    traffic (``matgen(256)``, GMRES(8), 16 requests); every request
    completed, nothing built or captured after warm-up, every follower's
    solve digests equal rank 0's, every response bitwise equal to one
    card's ``ShardedServeEngine`` over 4 owners on its value version, and
    ``spmv_ell``, ``epoch_sweep`` and ``superstep_factor`` launched; per
    part solves/s, p50 and p99, collectives and staged bytes per batch.
    15c. dist-nccl — the same fusion solve over NCCL ranks, one card
    each, and with four cards [serve-ranks]' services over them, where
    the machine has two cards or more; otherwise one line says why it did
    not run. 15d. pipeline-demo — ``examples/ilu_pipeline_demo_torch.py``'s
    8 band owners on the card: ``topilu_numeric`` under psum and ring,
    each bitwise equal to ``numeric_ilu_ref``, one ``superstep_factor``
    launch per factorization.
16. warm — ``warm_solve`` captures each bucket's GMRES restart as one CUDA
    graph (main path: nb = 1, 4; path E: nb = 1, 4 natural, 1 fused);
    the warmed solves replay it once per restart and equal the cold ones
    bitwise ([main], the [multi-rhs] lanes, [distributed],
    [distributed-fusion]); a ragged batch of 3 through bucket 4 equals its
    lanes' solo solves. Launch counts add each graph's kernels (counted at
    its capture) times its replays to the wrappers' own.
17. bicgstab — ILU(1) BiCGSTAB on ``poisson_2d(400)`` and on the
    non-symmetric ``convection_diffusion_2d(200)`` (cut from 400 for the
    time limit), gated on the float64
    true residual (at 1e-4 where float32 stalls above 1e-5, said in the
    output); phase 7 holds the card's BiCGSTAB equal to the CPU's.
18. breakdown — the shift ladder on the four breakdown fixtures, card and
    CPU equal, the settled factor bitwise equal to ``numeric_ilu_ref`` of
    the shifted matrix, single-device and over 4 owners.
19. serve — the multi-tenant solve service (``repro_torch.serve``): three
    resident matrices (``poisson_2d(200)``, cut from 400 for the time
    limit, the same structure with its values x1.25, sharing the first
    one's engine, and
    ``convection_diffusion_2d(128)``), buckets 1, 2, 4, 8, each engine's
    bucket restarts captured at warm-up; 48 seeded requests of four
    tenants, a background value update, a malformed request and an
    expired deadline; no build, capture or cold restart after warm-up; a
    seeded sample of 6 responses (every matrix, both value versions)
    bitwise equal to solo solves on fresh matrix objects warmed with
    ``warm_solve``; per-tenant p50/p99, solves per second, occupancy, the
    value-slot copies per batch and their device time, one profiled
    batch's device-busy share.
20. serve-sharded — the same service over ``ShardedServeEngine`` (4 band
    owners of ``poisson_2d(200)``, cut from 400 to make room for
    [llm-train]; buckets 1 and 4): 5 requests and a
    value update, every response bitwise equal to the solo
    ``solve_sharded`` on its value version, nothing built after warm-up.
21. llm-serve — the model scaffolding's serving path (``repro_torch.models``,
    ``repro_torch.train.step``; plain PyTorch, no kernel of this repo).
    smollm-135m at its published size, weights drawn from a seeded
    generator on the card: in float32 with 16-token chunks, 4 requests of
    32 seeded prompt tokens fed one per step through ``make_serve_step``,
    then 16 greedy tokens, held teacher-forced against one ``forward``
    over the 48 tokens (max log-softmax error <= 1e-3, between the
    sound float32 readings and a bf16 decode's, inside
    test_decode_consistency's 0.05; argmax equal wherever the forward's
    top-2 gap exceeds twice that error); in the config's own bf16 the
    same tokens, timed (ms per decode step, tokens/s, one profiled
    step's launches and device-busy share) and
    held to finite logits and tokens in [0, vocab_real), and the bf16
    prefill at B = 4, S = 2048. qwen1.5-0.5b, starcoder2-15b,
    stablelm-12b and llava-next-mistral-7b at full width and 2 layers
    under the same float32 parity (llava also prefilled with its vision
    embeddings merged); the reduced smollm and starcoder2 on the card
    and on the CPU with the same weights, logits within 1e-4·max|logits|.
22. llm-train — the model scaffolding's training path (``loss_fn``, the
    backward with remat, AdamW, ``make_train_step``, the checkpoints, the
    data pipeline, ``train.loop.train``, the GPipe pipeline over ranks;
    plain PyTorch, no kernel of this repo). (a) smollm-135m at full width
    cut to 2 layers, float32 (TF32 off): one train step on the card and on
    the CPU from the same weights and batch, loss within 1e-5 relative,
    grad_norm and every entry of the gradient (taken before the update)
    within 1e-4·max|·| of its leaf, every updated parameter leaf within
    1e-4·max|·| (at most 200 entries in all may exceed that, each within
    twice the learning rate: AdamW divides by |g| + eps). (b) smollm-135m at its
    published size in its own bf16, remat "dots", through
    ``train.loop.train``: B = 8 sequences of 2,048 tokens from
    ``SyntheticLM``, one warm-up step and 10 timed (warm-up 5, lr 3e-3;
    21 steps until the budget of [llm-families-train] cut them);
    ms per step, tokens/s, peak memory, and one profiled step's launches
    and device-busy share; every loss finite and the last five's mean
    below the first five's. (c) the loop's ``AsyncCheckpointer`` saves at
    steps 5, 10 and 11: the step-11 checkpoint restored into a fresh
    model and optimizer state on the card equals the live state bitwise,
    and the loop resumed from step 5 runs steps 5 and 6 within 1e-3
    relative of the uninterrupted losses. (d) the 30 layers as a 2-stage
    GPipe pipeline over 2 gloo ranks sharing the card (15 layers each,
    payloads staged through pinned host memory), B = 8, S = 256, 4
    microbatches, float32:
    the output and every layer's gradient within 1e-4·max|·| of the
    sequential stack on the card; each rank's first call (one layer on a
    small input) is timed apart, so that the sequential and pipelined
    walls are warm.
23. llm-families — the serving path of the MoE + MLA, hybrid SSM, xLSTM
    and encoder-decoder families: deepseek-v2-lite-16b at its published
    size in bf16 (its float32 decode held to its forward at 2 layers),
    qwen2-moe-a2.7b at 2 layers, hymba-1.5b, xlstm-125m and whisper-tiny
    at their published sizes; decode and prefill timed; the reduced
    configs on the card against the CPU.
24. llm-families-train — training of those four families (``loss_fn``,
    the backward with layer remat and the chunked time scans of
    ``models.scan_utils``, ``make_train_step``). (a) float32 (TF32 off),
    at full width: hymba-1.5b at 2 layers (B = 1, S = 256), xlstm-125m's
    first three blocks (m, m, s; B = 1, S = 256: two chunks of 128),
    whisper-tiny (B = 1, S = 64, 1,500 seeded frames) and
    deepseek-v2-lite-16b at 1 layer with full expert capacity (B = 1,
    S = 128): one train step on the card and on the CPU from the same
    weights and batch, under (a) of llm-train's bounds; the card's
    gradient with the scans chunked equals the plain loop's bitwise
    (hymba, xLSTM); how many leaves differ between two identical backward
    passes on the card (printed); the standalone ``moe_ffn`` at deepseek's
    width gives the same gradient bits in two identical passes (float32
    and bf16). (b) bf16, remat "dots", at full width and B = 4: hymba-1.5b
    at 8 of its 32 layers (S = 512), xlstm-125m's first three blocks
    (S = 512; its peak beside the plain loop's reckoning, ~29 GB for these
    blocks and ~116 GB for all 12), whisper-tiny (S = 448, 1,500 frames),
    deepseek-v2-lite-16b at 4 layers (S = 2,048): one warm-up step (under
    torch.profiler, the card's activity alone: launches, busy share) and
    three timed steps (one for xLSTM) of ``make_train_step`` on one seeded
    batch; ms per step, tokens/s, peak memory; every loss finite, the last
    below the first. The depths of (a) deepseek and (b) hymba and xLSTM
    are cut to keep the script inside its time limit on a slow host.
25. dryrun — the dry-run side (``repro_torch.launch.dryrun``), in a
    process of its own (``python3 chip_smoke.py --dryrun-phase``), since
    its meshes run over a fake process group. (a) smollm-135m
    ``decode_32k`` and deepseek-v2-lite-16b ``train_4k`` on the 16x16
    production mesh end ``status: ok``: per-device bytes, the three
    roofline terms on the H100 (floors) and the bottleneck. (b) On a 1x1
    mesh, smollm-135m at its published size in bf16: the reckoned bytes of
    its parameters, its AdamW moments and a B = 4 decode cache of
    [llm-serve]'s length each equal the bytes that making them on the card
    asks the allocator for, and its ``torch.cuda.memory_allocated()``
    delta up to the allocator's rounding (512 B per tensor, and an unsplit
    segment tail of ≤ 1 MiB for a tensor above 1 MiB). (c) [llm-train]'s bf16 step (B = 8, S = 2,048):
    the FLOPs ``FlopCounterMode`` counts on the card equal the ``meta``
    count exactly, and the dry run's H100 bound is at most the measured
    step's wall (its share printed), beside the step's peak memory and the
    dry run's arguments + temp.

``[time]`` lines give the seconds of each group of phases.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py
--dist-nccl`` on a machine with two cards or more runs the build and
[dist-nccl] alone. Without a GPU, or without
the repository around it, the script exits non-zero and prints no result.
"""
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores, dense
SEED = 0
TOL = 1e-5
INV_TOL = 1e-4  # the inverse method's float32 floor on poisson_2d(400) is just above 1e-5
NB = 4  # right-hand sides of the batched kernel checks and the multi-RHS solve
BS_TILE = 128  # the Block-ILU tile of the module's docstring; also bs = 32, bilu's default
CG_TOL = 1e-4  # float32 CG's recursive residual drifts from the true one at 1e-5 here
TILE_KERNELS = ("panel_update", "trsm_right_upper", "trsm_left_unit_lower", "tile_lu")
LARGE_TILES = (241, 256, 300, 512, 513, 640, 1024, 2048)  # [large-tiles]: above 512 in chunks
BILU_SIZES = (BS_TILE, 32, 256, 512, 1024)  # path C's tile sizes
# the kernels of one sweep apply: the L and U sweeps and 3 permutations
SWEEP_KERNELS = {"tri_sweep_kernel": 2, "permute_kernel": 3}
# the two redesigned kernels' times before this design, on poisson_2d(400)
# at the main path's shapes on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# per call, device, and the same for nb = 4; printed in the [kernels] text
# lines only, never in the kernels JSON line (whose numbers are this run's)
PREVIOUS_MS = {
    "tri_solve_wavefront": dict(ms=2.778, device_ms=2.507, batched_ms=3.215,
                                batched_device_ms=3.237),
    "spmv_ell": dict(ms=0.0714, device_ms=0.0028, batched_ms=0.0567, batched_device_ms=0.0066),
}
# factor_wavefront before its redesign (one thread per op walking the W
# lanes one dependent trip at a time): ms per call and device ms, and the
# band-partitioned apply at D = 4 before it became one launch (2,384
# epoch_sweep launches and 2,383 exchanges): ms per apply; both on
# poisson_2d(400) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), printed
# in the text lines only
PREVIOUS_FACTOR_MS = (6.129, 6.136)
PREVIOUS_SHARDED_APPLY_MS = 261.5
# superstep_factor before the persistent launch (one launch per superstep,
# an exchange on the host after each), on poisson_2d(400) at D = 4 on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): ms per call and
# device ms of the fullest superstep, launches per factorization
PREVIOUS_SUPERSTEP = dict(ms=0.0715, device_ms=0.0660, launches=2811)
# the left-looking tile solves' (ms per call, device ms) at (128, 128) on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md), printed beside the new ones
PREVIOUS_TRSM_MS = {"trsm_right_upper": (0.1950, 0.1441), "trsm_left_unit_lower": (0.2249, 0.1513)}
# the tile kernels this design replaced: device ms per call at (128, 128) on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, r2 of PR 16), and tile_lu's
# device ms per launch on path C at bs = 256 (r1 of PR 16); printed in the
# [tiles] and [large-tiles] text lines only
PREVIOUS_TILE_MS = {"panel_update": 0.0112, "panel_update_bf16": 0.0116, "tile_lu": 0.1330,
                    "tile_lu_bs256": 0.979}
DISTRIBUTED_KERNELS = ("epoch_sweep", "superstep_factor")
# [kernels]: the size at which superstep_factor's persistent launch is held
# against (and timed beside) the plain per-superstep loop, which took
# 135-215 s at full size (9.3-16.6 s at 128; cut to 64 to make room for
# [serve-ranks])
PLAIN_LOOP_NX = 64
# [dist-ranks] / [dist-nccl]: the bound on one run_ranks call (spawn, the
# ranks' CUDA contexts, the fusion solve and the natural parts), and the
# restarts of their fusion solve: a host-staged 4-rank gloo all-gather
# costs 5-7 ms on an H100 host, and the whole solve of poisson_2d(400) (12
# restarts) makes 3,847 of them; the reference is a one-card run with the
# same maxiter. The size, the restarts and the applies were cut (from 400,
# 4 and 2) to make room for [llm-train]: poisson_2d(128) has 127 fusion and
# 258 natural supersteps against 1,243 and 2,811; the restarts cut again
# from 2 to 1 to make room for [serve-ranks]
DIST_RANKS_TIMEOUT_S = 600
DIST_RANKS_NX = 128
DIST_RANKS_MAXITER = 1
DIST_RANKS_APPLIES = 1  # natural sweep applies over the ranks
# [serve-ranks], inside [dist-ranks]' run_ranks call: (i) the inverse
# method at full traffic on poisson_2d(DIST_RANKS_NX), GMRES(30) at
# SERVE_RANKS_TOL, SERVE_RANKS_REQUESTS requests of two tenants in bursts of
# 1-4 around one background value update; (ii) the sweep on the CPU tests'
# traffic (tests/test_torch_serve_ranks.py: matgen(256), GMRES(8), its
# SERVE_RANKS_SWEEP_REQUESTS requests at 1e-4 / 1e-5)
SERVE_RANKS_BUCKETS = (1, 2, 4)
SERVE_RANKS_TOL = 1e-4
SERVE_RANKS_REQUESTS = 12
SERVE_RANKS_SWEEP_N = 256
SERVE_RANKS_SWEEP_REQUESTS = 16
# [pipeline-demo]: examples/ilu_pipeline_demo_torch.py's owners on the card
PIPELINE_DEMO_OWNERS = 8
SHARDED_D = 4  # band owners of the distributed path, on one card
BAND_ROWS = 32  # rows per band (the JAX package's default)
SRC = Path(__file__).resolve().parent / "src"
SMALL = ("poisson_2d(64)", "convection_diffusion_2d(32)")
# [card-vs-cpu]'s fixtures: the CPU runs the plain versions in Python, so
# these are smaller than SMALL (39.6 s of the script at SMALL)
CARD_VS_CPU = ("poisson_2d(40)", "convection_diffusion_2d(24)")
# [ordering]: poisson_2d(400), ILU(1), SHARDED_D owners of BAND_ROWS-row bands:
# the comm models each ordering must reproduce (the JAX package's NumPy
# models give these numbers on the same matrix)
ORDERING_EXPECTED = {
    "natural": dict(levels=2396, epochs=2384, collectives=2383, supersteps=2811,
                    halo_bytes=1344, fill_nnz=1116802),
    "fusion": dict(levels=1680, epochs=7, collectives=6, supersteps=1243, halo_bytes=46080,
                   fill_nnz=1120654),
    "rcm": dict(levels=3192, epochs=2874, collectives=2873, supersteps=4934, halo_bytes=5376,
                fill_nnz=1116802),
}
BICGSTAB_FALLBACK_TOL = 1e-4  # [bicgstab]'s gate where float32 stalls above TOL
SERVE_BUCKETS = (1, 2, 4, 8)  # [serve]'s buckets (nb = 8, n = 40,000: a 40 MB basis)
# [serve]'s poisson_2d and [bicgstab]'s convection_diffusion_2d: cut from 400 to keep
# the script inside its time limit on a slow host
SERVE_NX = 200
BICGSTAB_CD_NX = 200
SERVE_TOLS = (1e-4, 1e-5)
SERVE_REQUESTS = 48  # [serve]: 24 before the value update of p1, 16 while it runs, 8 after
SERVE_SHARDED_NX = 200  # [serve-sharded]'s poisson_2d, cut from 400 to make room for [llm-train]
# [llm-serve]: the model scaffolding's serving path. smollm-135m at its
# published size, then the other dense / vlm configs at full width and
# LLM_WIDE_LAYERS layers; LLM_B requests of LLM_PROMPT seeded prompt tokens
# fed one per step, then LLM_GEN greedy tokens, in a cache of LLM_CACHE
# slots; the float32 runs use chunks of LLM_CHUNK so that the forward walks
# several; the bf16 prefill runs at LLM_PREFILL_S with the config's chunks
LLM_ARCH = "smollm-135m"
LLM_WIDE = ("qwen1.5-0.5b", "starcoder2-15b", "stablelm-12b", "llava-next-mistral-7b")
LLM_WIDE_LAYERS = 2
LLM_B, LLM_PROMPT, LLM_GEN, LLM_CACHE = 4, 32, 16, 128  # LLM_GEN cut from 32 for [serve-ranks]
LLM_CHUNK = 16
LLM_PREFILL_S = 2048
LLM_LSM_BOUND = 0.05  # tests/test_decode_consistency.py's bound on decode against forward
# The float32 gate: sound float32 runs of all ten configs on an H100 read
# 1.9e-06 to 8.3e-05, their bf16 decodes 1.8e-02 (whisper-tiny) to 4.1e+00
# (the MoE configs, where bf16 flips a router near-tie); so a gate that tells
# float32 from a decode gone to bf16 lies between the two.
LLM_F32_GATE = 1e-3
LLM_CPU_REL = 1e-4  # card against CPU: logits within LLM_CPU_REL * max|logits|
# [llm-train]: (a) float32 card against CPU at full width and LLM_TRAIN_F32_LAYERS
# layers, a batch of LLM_TRAIN_F32_B x LLM_TRAIN_F32_S; (b) the published size in
# bf16, LLM_TRAIN_B sequences of LLM_TRAIN_S tokens (SmolLM's pretraining
# context), LLM_TRAIN_STEPS steps (the first a warm-up), checkpoints every
# LLM_TRAIN_SAVE steps; (d) the pipeline over LLM_PIPE_RANKS ranks on the card
LLM_TRAIN_F32_LAYERS, LLM_TRAIN_F32_B, LLM_TRAIN_F32_S = 2, 1, 128
LLM_TRAIN_B, LLM_TRAIN_S, LLM_TRAIN_STEPS, LLM_TRAIN_SAVE = 8, 2048, 11, 5
LLM_TRAIN_LR, LLM_TRAIN_WARMUP = 3e-3, 5
LLM_TRAIN_LOSS_REL = 1e-5  # (a): loss within this relative
LLM_TRAIN_REL = 1e-4  # (a): grad_norm and parameters within this * max|.| per leaf
LLM_TRAIN_OUTLIERS = 200  # (a): parameter entries in all that may exceed it (AdamW)
LLM_RESUME_REL = 1e-3  # (c): resumed losses within this relative
LLM_PIPE_RANKS, LLM_PIPE_B, LLM_PIPE_S, LLM_PIPE_MB = 2, 8, 256, 4
LLM_PIPE_REL = 1e-4  # (d): output and gradients within this * max|.| per tensor
# [llm-families]: the serving path of the other four families. deepseek-v2-lite-16b
# at its published size in bf16 (its float32 parity at full width and
# LLM_FAMILY_F32_LAYERS layers: the 27 layers in float32 would need ~65 GB);
# qwen2-moe-a2.7b at full width and LLM_WIDE_LAYERS layers; hymba-1.5b,
# xlstm-125m and whisper-tiny at their published sizes (whisper's cache filled
# by precompute_cross_kv from LLM_B x encoder_seq seeded frames). The float32
# parity runs give every expert full capacity (capacity factor = the routed
# experts, as tests/test_decode_consistency.py does), since dropping depends on
# how many tokens are routed together; the bf16 runs keep the config's 1.25.
LLM_FAMILY_ARCH = "deepseek-v2-lite-16b"
LLM_FAMILY_F32_LAYERS = 2
LLM_FAMILY_OTHERS = (("qwen2-moe-a2.7b", LLM_WIDE_LAYERS), ("hymba-1.5b", None),
                     ("xlstm-125m", None), ("whisper-tiny", None))
# hymba's and xLSTM's prefill: their time scans are eager step loops, so S is held to
# 256 (not 512) to keep the script inside its time limit
LLM_RECURRENT_PREFILL_S = 256
# [llm-families-train]: training of the other four families. (a) float32 (TF32 off),
# one train step on the card and on the CPU at full width, under [llm-train] (a)'s
# bounds: (config, changes, B, S) of LLM_FT_F32, deepseek with full expert capacity,
# whisper with encoder_seq seeded frames; the standalone moe_ffn's repeatability at
# deepseek's width over LLM_FT_MOE_B x LLM_FT_MOE_S tokens. (b) bf16, the configs'
# remat "dots", one seeded batch: one warm-up step (profiled) and the entry's count of
# timed steps of make_train_step at lr LLM_FT_LR: one for xLSTM, whose eager step takes
# 18-26 s at 12 blocks; three for hymba, whose loss rises after the first step at this
# lr (10.65 -> 14.79 -> 10.80 -> 6.27 at 32 layers). deepseek-v2-lite-16b at 4 layers:
# all 27 would need ~190 GB for bf16 weights and gradients and float32 moments. Cut in
# depth to keep the script inside its time limit on a slow host (the phase took 174 s
# of a ~937 s script): (a) deepseek at 1 layer (its CPU step took ~37 s at 2), (b)
# hymba at 8 of its 32 layers and xLSTM at its first 3 blocks (m, m, s: one unit of
# the published 12-block layout), at full width, B and S.
LLM_FT_F32 = (("hymba-1.5b", dict(n_layers=2), 1, 256),
              ("xlstm-125m", dict(n_layers=3, block_types=["m", "m", "s"]), 1, 256),
              ("whisper-tiny", {}, 1, 64),
              ("deepseek-v2-lite-16b", dict(n_layers=1), 1, 128))
LLM_FT_BF16 = (("hymba-1.5b", dict(n_layers=8), 4, 512, 3),
               ("xlstm-125m", dict(n_layers=3, block_types=["m", "m", "s"]), 4, 512, 1),
               ("whisper-tiny", {}, 4, 448, 3),
               ("deepseek-v2-lite-16b", dict(n_layers=4), 4, 2048, 3))
LLM_FT_LR = 1e-3
LLM_FT_MOE_B, LLM_FT_MOE_S = 1, 512
# [dryrun]: (a) the production-mesh cells, (b) the bytes reckoned on a 1x1 mesh
# against the allocator (it rounds each block up to 512 B), (c) [llm-train]'s step
DRYRUN_CELLS = (("smollm-135m", "decode_32k"), ("deepseek-v2-lite-16b", "train_4k"))
DRYRUN_ROUNDING = 512
# ... and where a tensor of more than 1 MiB leaves its segment a tail of at most 1 MiB,
# the allocator hands the block over whole (its kSmallSize: a tail that small is not split)
DRYRUN_UNSPLIT_TAIL = 1 << 20
DRYRUN_TIMEOUT_S = 300


def require(cond, what):
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def say(*args):
    print(*args, flush=True)


def setup():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is false; needs one GPU\n")
        sys.exit(2)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.stderr.write(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
                         "run it from the repository\n")
        sys.exit(2)
    sys.path.insert(0, str(SRC))


def time_ms(fn, reps, warmup=1):
    """Median milliseconds of ``reps`` runs, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_pair_ms(fa, fb, reps):
    """Median milliseconds of ``fa`` and of ``fb``, timed as :func:`time_ms`
    but in turns (a, b, a, b, ...), so that both see the same spells of a
    shared host's load: for calls whose time is mostly the host's."""
    import torch

    fa(), fb()
    torch.cuda.synchronize()
    times = ([], [])
    for _ in range(reps):
        for fn, out in zip((fa, fb), times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return tuple(statistics.median(t) for t in times)


def kernel_events(prof):
    """(name, microseconds) of each device-side event of a torch.profiler
    run, read from the Kineto results directly: the event tree that
    ``prof.events()`` builds costs about a minute at 360k kernels."""
    from torch.autograd import DeviceType

    return [(e.name().removeprefix("void "), e.duration_ns() / 1e3)  # templates: "void f<T>(...)"
            for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]


def profile_launches(fn):
    """(wall ms, kernel launches, device-busy ms) of one call of ``fn`` under
    torch.profiler, tracing the card's activity alone (Memcpy / Memset
    events are not launches; host-side events would only lengthen the wall
    that the busy share divides by)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = kernel_events(prof)
    kernels = [e for e in events if not e[0].startswith(("Memcpy", "Memset"))]
    return wall * 1e3, len(kernels), sum(us for _, us in events) / 1e3


def device_ms(fn, kernel, reps=5, attempts=3, per_call=1):
    """Mean device time (ms) of the CUDA kernel ``kernel`` per call of
    ``fn``, which launches it ``per_call`` times, from torch.profiler's
    device trace of ``reps`` calls (the mean per launch times
    ``per_call``); None if no trace of ``attempts`` holds it. A short trace
    now and then comes back without the kernel's events, so each attempt
    traces four times as many calls as the one before."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps * 4 ** attempt):
                fn()
            torch.cuda.synchronize()
        us = [t for name, t in kernel_events(prof) if name.startswith(kernel)]
        if us:
            return sum(us) / len(us) * per_call / 1e3
    return None


def device_ms_per_call(fn, launches, reps=10, attempts=3):
    """Device time (ms) per call of ``fn``, which launches ``launches[k]``
    kernels whose names start with k, for each k: the sum over k of the
    mean duration of k's launches in a torch.profiler trace of ``reps``
    calls, times ``launches[k]``; None unless a trace of ``attempts`` holds
    launches of every k (each attempt traces four times as many calls as
    the one before; see device_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps * 4 ** attempt):
                fn()
            torch.cuda.synchronize()
        events = kernel_events(prof)
        means = {}
        for k in launches:
            us = [t for name, t in events if name.startswith(k)]
            if us:
                means[k] = sum(us) / len(us)
        if len(means) == len(launches):
            return sum(means[k] * launches[k] for k in launches) / 1e3
    return None


def device_ms_all(fn, reps=20, attempts=3):
    """Device time (ms) per call of ``fn``, summed over every device event
    of its calls (kernels, copies, fills) in a torch.profiler trace of
    ``reps`` calls: for a library call, whose kernels' names are not known
    here. None if no trace of ``attempts`` holds an event (each attempt
    traces four times as many calls as the one before; see device_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        calls = reps * 4 ** attempt
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [t for _, t in kernel_events(prof)]
        if us:
            return sum(us) / calls / 1e3
    return None


def bound(nbytes, nops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits_equal(got, want):
    """Equal int32 views of two float32 tensors or arrays (any device)."""
    import torch

    got, want = (torch.as_tensor(t).cpu().contiguous() for t in (got, want))
    return got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))


def max_abs_err(got, want):
    return float((got.double() - want.double()).abs().max())


def triangular_library(pattern, vals, dev):
    """x = U^-1 (L^-1 b) by two torch.triangular_solve calls on sparse CSR
    factors (cuSPARSE's triangular solve on the card): L the strictly lower
    entries of the factor with the unit diagonal implied, U the upper
    entries with the diagonal, in the factor's row order (natural: no
    ordering is ported). Takes and returns (nb, n). The library call
    that computes what the sweeps compute; the order of its adds differs,
    so it is a yardstick and never on the port's path."""
    import numpy as np
    import torch

    n = pattern.n
    rows = np.repeat(np.arange(n), np.diff(pattern.indptr))
    cols = np.asarray(pattern.indices, np.int64)

    def csr(mask):
        crow = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows[mask], minlength=n), out=crow[1:])
        return torch.sparse_csr_tensor(torch.as_tensor(crow, device=dev),
                                       torch.as_tensor(cols[mask], device=dev),
                                       torch.as_tensor(vals[mask], device=dev), size=(n, n),
                                       check_invariants=False)

    low, up = csr(cols < rows), csr(cols >= rows)

    def solve(b):
        y = torch.triangular_solve(b.t().contiguous(), low, upper=False, unitriangular=True)[0]
        return torch.triangular_solve(y, up, upper=True)[0].t()

    return solve


def library_pair(row, kern, lib, b, reps, key=""):
    """Time the kernel and the library call in turns on the same b, into
    row[f"{key}paired_ms"] and row[f"{key}library_ms"], with the largest
    difference of their outputs. A library call that raises on the card
    leaves its error in the row (``library_error``), and no time."""
    import torch

    try:
        got = lib(b if b.ndim == 2 else b[None])
        torch.cuda.synchronize()
    except RuntimeError as err:
        row[f"{key}library_ms"], row["library_error"] = None, str(err).splitlines()[0][:300]
        say(f"[kernels] {row['name']}: the library call raised on the card: "
            f"{row['library_error']}")
        return
    want = kern(b)
    row[f"{key}library_max_abs_diff"] = float((got.reshape(want.shape) - want).abs().max())
    row[f"{key}paired_ms"], row[f"{key}library_ms"] = time_pair_ms(
        lambda: kern(b), lambda: lib(b if b.ndim == 2 else b[None]), reps)
    form = f"nb={b.shape[0]}" if key else "single"
    say(f"[kernels] {row['name']} ({form}) and {row['library']} timed in turns "
        f"({reps} each): {row[f'{key}paired_ms']:.4f} ms against "
        f"{row[f'{key}library_ms']:.4f} ms per call; max |diff| "
        f"{row[f'{key}library_max_abs_diff']:.3e} (a yardstick; its order of adds differs)")


def phase_kernels(dev):
    import numpy as np
    import torch

    from repro_torch.core.factor_plan import SCHEDULE_FIELDS, build_factor_plan
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import csr_to_ell_arrays
    from repro_torch.core.symbolic import pilu1_symbolic
    from repro_torch.core.triangular import SWEEP_FIELDS, PrecondApply, build_triangular_plan
    from repro_torch.kernels import build, ops, ref

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    a = poisson_2d(400)
    pattern = pilu1_symbolic(a)
    fplan = build_factor_plan(a, pattern)
    say(f"[kernels] poisson_2d(400) ILU(1): n={a.n} rounds={fplan.n_rounds} "
        f"ops/round={fplan.max_ops} W={fplan.width} n_ops={fplan.n_ops} "
        f"(host planning {time.perf_counter() - t0:.2f} s)")
    rows = {}

    # factor_wavefront: the form the factorizer holds (schedule checked and
    # packed once), and the checked entry point
    sched = fplan.schedule_tensors(dev)
    fargs = [sched[f] for f in SCHEDULE_FIELDS]
    fw = ops.FactorWavefront(*fargs, fplan.n)
    a_vals = torch.as_tensor(fplan.a_vals, device=dev)
    got = fw(a_vals)
    want = ref.factor_wavefront_ref(*fargs, a_vals)
    require(bits_equal(got, want), "factor_wavefront kernel != plain version on the card")
    require(bits_equal(ops.factor_wavefront(*fargs, a_vals), want),
            "factor_wavefront (checked entry point) != plain version on the card")
    require(bool(torch.isfinite(got).all()), "factor_wavefront produced non-finite values")
    valid = fplan.op_row < a.n
    kept = int((fplan.dst_flat[fplan.op_dst[valid]] < fplan.width).sum())
    nbytes = (int(valid.sum()) * 16 + fplan.dst_flat.size * 4 + a_vals.numel() * 4
              + got.numel() * 4)  # the packed ops of real rows, the dst rows, A in, LU out
    b_ms, b_by = bound(nbytes, int(valid.sum()) + 2 * kept)
    ms = time_ms(lambda: fw(a_vals), reps=10)
    zeros = torch.zeros(1025, dtype=torch.float32, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    lib = build.load()
    threads = lib.factor_wavefront_threads(fplan.max_ops, fplan.width)

    def factor_floor():
        err = lib.factor_wavefront_chain_floor_launch(fplan.n_rounds, threads, zeros.data_ptr(),
                                                      sink.data_ptr(),
                                                      torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the factor chain floor kernel did not launch (CUDA error {err})")

    rows["factor_wavefront"] = dict(
        name="factor_wavefront", route="cuda",
        source="src/repro_torch/kernels/csrc/factor_wavefront.cu",
        replaces="src/repro/kernels/panel_update.py:97", launches=0,
        max_abs_err=max_abs_err(got, want), ms=ms,
        plain_ms=time_ms(lambda: ref.factor_wavefront_ref(*fargs, a_vals), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, chain_steps=fplan.n_rounds,
        us_per_step=ms * 1e3 / fplan.n_rounds,
        device_ms=device_ms(lambda: fw(a_vals), "factor_wavefront_kernel"),
        checked_ms=time_ms(lambda: ops.factor_wavefront(*fargs, a_vals), reps=5),
        chain_floor_ms=device_ms(factor_floor, "factor_wavefront_chain_floor_kernel", reps=10))
    r = rows["factor_wavefront"]
    say(f"[kernels] factor_wavefront: {fplan.n_rounds} rounds of <= {fplan.max_ops} ops, W="
        f"{fplan.width}; device "
        + ("not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms")
        + f" ({r['ms']:.4f} ms per call through the form checked once, {r['checked_ms']:.4f} "
        f"ms through the checked entry point); chain floor (the kernel's cluster of blocks of "
        f"{threads} threads and its round loop with one dependent L2 load, the divide and the "
        f"cluster barrier per round) "
        + ("not measured" if r["chain_floor_ms"] is None
           else f"{r['chain_floor_ms']:.4f} ms = "
           f"{r['chain_floor_ms'] * 1e3 / fplan.n_rounds:.4f} us per round")
        + f"; the design before took {PREVIOUS_FACTOR_MS[0]:.3f} ms per call, "
        f"{PREVIOUS_FACTOR_MS[1]:.3f} ms of device (an NVIDIA H100 80GB HBM3 at 700 W)")
    vals = fplan.values_to_csr(got.cpu().numpy())

    # tri_solve_wavefront: the apply the main path makes (PrecondApply's
    # sweep, bound once), and the checked entry point
    tplan = build_triangular_plan(pattern, vals)
    targs = [torch.as_tensor(getattr(tplan, f), device=dev) for f in SWEEP_FIELDS]
    b = torch.as_tensor(rng.standard_normal(a.n).astype(np.float32), device=dev)
    sweep = PrecondApply(pattern, vals, dev, plan=tplan).sweep
    got = sweep(b)
    want = ref.tri_solve_wavefront_ref(*targs, b)
    require(bits_equal(got, want), "tri_solve_wavefront kernel != plain version on the card")
    require(bits_equal(ops.tri_solve_wavefront(*targs, b), want),
            "tri_solve_wavefront (checked entry point) != plain version on the card")
    require(bool(torch.isfinite(got).all()), "tri_solve_wavefront produced non-finite values")
    levels = tplan.l_cols_lm.shape[0] + tplan.u_cols_lm.shape[0]
    lanes = int((tplan.l_cols_lm < tplan.nl_slots).sum()
                + (tplan.u_cols_lm < tplan.nu_slots).sum())
    nbytes = sum(t.numel() * 4 for t in targs) + 2 * a.n * 4
    b_ms, b_by = bound(nbytes, 2 * lanes + 3 * a.n)
    ms = time_ms(lambda: sweep(b), reps=20)
    dms = device_ms_per_call(lambda: sweep(b), SWEEP_KERNELS)
    maxr = max(tplan.l_cols_lm.shape[1], tplan.u_cols_lm.shape[1])
    floor_out = torch.zeros(1, dtype=torch.float32, device=dev)

    def chain_floor():
        err = lib.tri_solve_chain_floor_launch(levels, maxr, sweep.layout["threads"][0],
                                               floor_out.data_ptr(),
                                               torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the chain floor kernel did not launch (CUDA error {err})")

    rows["tri_solve_wavefront"] = dict(
        name="tri_solve_wavefront", route="cuda",
        source="src/repro_torch/kernels/csrc/tri_solve_wavefront.cu",
        replaces="src/repro/kernels/tri_solve_wavefront.py:46", launches=0,
        max_abs_err=max_abs_err(got, want), ms=ms,
        plain_ms=time_ms(lambda: ref.tri_solve_wavefront_ref(*targs, b), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, chain_steps=levels,
        us_per_step=ms * 1e3 / levels, device_ms=dms,
        checked_ms=time_ms(lambda: ops.tri_solve_wavefront(*targs, b), reps=5),
        chain_floor_ms=device_ms(chain_floor, "chain_floor_kernel", reps=10),
        window_levels=list(sweep.windows), layout=sweep.layout,
        kernels_per_launch=sum(SWEEP_KERNELS.values()),
        library="torch.triangular_solve on sparse CSR L (unit) then U, two calls")
    r = rows["tri_solve_wavefront"]
    tri_lib = triangular_library(pattern, vals, dev)
    library_pair(r, sweep, tri_lib, b, 20)
    say(f"[kernels] sweep: {tplan.l_cols_lm.shape} L levels x rows x lanes, "
        f"{tplan.u_cols_lm.shape} U; windows R = {sweep.windows} levels; per sweep (L, U): "
        f"{json.dumps(sweep.layout)}; chain floor (the level loop with only a shared-memory "
        f"exchange and the barrier, {levels} levels of {maxr} rows) "
        + ("not measured" if r["chain_floor_ms"] is None
           else f"{r['chain_floor_ms']:.4f} ms = {r['chain_floor_ms'] * 1e3 / levels:.4f} us "
           "per level"))

    # spmv_ell: the operator the solvers hold (checked once), and the
    # checked entry point (which makes one per call)
    cols, evals = csr_to_ell_arrays(a, dev)
    op = ops.EllOperator(cols, evals)
    x = torch.as_tensor(rng.standard_normal(a.n).astype(np.float32), device=dev)
    got = op(x)
    want = ref.spmv_ell_ref(cols, evals, x)
    require(bits_equal(got, want), "spmv_ell kernel != plain version on the card")
    require(bits_equal(ops.spmv_ell(cols, evals, x), want),
            "spmv_ell (checked entry point) != plain version on the card")
    csr = torch.sparse_csr_tensor(torch.as_tensor(a.indptr, device=dev),
                                  torch.as_tensor(a.indices.astype(np.int64), device=dev),
                                  torch.as_tensor(a.data, device=dev), size=(a.n, a.n),
                                  check_invariants=False)
    lib_y = csr @ x
    say(f"[kernels] spmv_ell vs torch sparse CSR product: max |diff| "
        f"{float((lib_y - got).abs().max()):.3e} (a yardstick; its order of adds differs)")
    nbytes = cols.numel() * 4 + evals.numel() * 4 + 2 * a.n * 4
    b_ms, b_by = bound(nbytes, 2 * a.nnz)
    rows["spmv_ell"] = dict(
        name="spmv_ell", route="cuda", source="src/repro_torch/kernels/csrc/spmv_ell.cu",
        replaces="src/repro/kernels/spmv_ell.py:34", launches=0,
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: op(x), reps=50),
        plain_ms=time_ms(lambda: ref.spmv_ell_ref(cols, evals, x), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lambda: csr @ x, reps=50),
        device_ms=device_ms(lambda: op(x), "spmv_ell_kernel", reps=20),
        checked_ms=time_ms(lambda: ops.spmv_ell(cols, evals, x), reps=50))
    r = rows["spmv_ell"]
    r["paired_ms"], r["paired_library_ms"] = time_pair_ms(lambda: op(x), lambda: csr @ x, 200)
    say(f"[kernels] spmv_ell and the CSR call timed in turns (200 each): {r['paired_ms']:.4f} "
        f"ms against {r['paired_library_ms']:.4f} ms per call")

    # inverse_chain, over W/Z computed on the card from this factor
    plan, wz = inverse_full_size(dev, pattern, vals)
    iargs = [torch.as_tensor(plan.w_cols, device=dev), wz[0],
             torch.as_tensor(plan.z_cols, device=dev), wz[1]]
    got = ops.inverse_chain(*iargs, x)
    want = ref.inverse_chain_ref(*iargs, x)
    require(bits_equal(got, want), "inverse_chain kernel != plain version on the card")
    require(bool(torch.isfinite(got).all()), "inverse_chain produced non-finite values")
    w_csr, z_csr = ell_to_csr(*iargs[:2], a.n), ell_to_csr(*iargs[2:], a.n)
    two = z_csr @ (w_csr @ x)
    say(f"[kernels] inverse_chain vs two torch sparse CSR products: max |diff| "
        f"{float((two - got).abs().max()):.3e} (a yardstick; its order of adds differs)")
    b_ms, b_by = bound(sum(t.numel() * 4 for t in iargs) + 2 * a.n * 4,
                       2 * plan.nnz_inverse())
    rows["inverse_chain"] = dict(
        name="inverse_chain", route="cuda",
        source="src/repro_torch/kernels/csrc/inverse_chain.cu",
        replaces="src/repro/kernels/inverse_chain.py:36", launches=0,
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: ops.inverse_chain(*iargs, x), reps=50),
        plain_ms=time_ms(lambda: ref.inverse_chain_ref(*iargs, x), reps=10),
        bound_ms=b_ms, bound_by=b_by,
        library="Z_csr @ (W_csr @ b): two torch.sparse_csr_tensor products",
        library_ms=time_ms(lambda: z_csr @ (w_csr @ x), reps=50),
        device_ms=device_ms(lambda: ops.inverse_chain(*iargs, x), "inverse_chain_kernel",
                            reps=20, per_call=2))
    for r in rows.values():
        dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        if r["name"] in PREVIOUS_MS:
            was = PREVIOUS_MS[r["name"]]
            say(f"[kernels] {r['name']}: per call {r['ms']:.4f} ms through the form checked "
                f"once, {r['checked_ms']:.4f} ms through the checked entry point; the design "
                f"before took {was['ms']:.4f} ms per call and {was['device_ms']:.4f} ms of "
                f"device time (an NVIDIA H100 80GB HBM3 at 700 W)")
        say(f"[kernels] {r['name']}: bitwise equal to plain; {r['ms']:.4f} ms per call "
            f"(device time in the profiler trace {dms}; "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
            + (f", library {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
            + (f", {r['us_per_step']:.3f} us per dependent step of {r['chain_steps']}"
               if "chain_steps" in r else "") + ")")

    # the (NB, n) forms: bitwise against the plain versions, and every row
    # against the single form's kernel output for that row
    bs = torch.as_tensor(rng.standard_normal((NB, a.n)).astype(np.float32), device=dev)
    nbytes_vec = 2 * NB * a.n * 4
    forms = {
        "spmv_ell": (op, lambda B: ref.spmv_ell_ref(cols, evals, B),
                     bound(cols.numel() * 8 + nbytes_vec, 2 * NB * a.nnz)[0]),
        "tri_solve_wavefront": (sweep, lambda B: ref.tri_solve_wavefront_ref(*targs, B),
                                bound(sum(t.numel() * 4 for t in targs) + nbytes_vec,
                                      NB * (2 * lanes + 3 * a.n))[0]),
        "inverse_chain": (lambda B: ops.inverse_chain(*iargs, B),
                          lambda B: ref.inverse_chain_ref(*iargs, B),
                          bound(sum(t.numel() * 4 for t in iargs) + nbytes_vec,
                                2 * NB * plan.nnz_inverse())[0]),
    }
    for name, (kern, plain, b_ms) in forms.items():
        got = kern(bs)
        want = plain(bs)
        require(bits_equal(got, want), f"{name} (nb={NB}) kernel != plain version on the card")
        for i in range(NB):
            require(bits_equal(got[i], kern(bs[i].contiguous())),
                    f"{name} (nb={NB}) row {i} != the single form's output for that row")
        r = rows[name]
        r.update(batched_nb=NB, batched_max_abs_err=max_abs_err(got, want),
                 batched_ms=time_ms(lambda: kern(bs), reps=10 if "tri" in name else 50),
                 batched_device_ms=(
                     device_ms_per_call(lambda: kern(bs), SWEEP_KERNELS)
                     if name == "tri_solve_wavefront" else
                     device_ms(lambda: kern(bs), f"{name}_kernel", reps=10,
                               per_call=2 if name == "inverse_chain" else 1)),
                 batched_bound_ms=b_ms)
        dms = ("not measured" if r["batched_device_ms"] is None
               else f"{r['batched_device_ms']:.4f} ms")
        say(f"[kernels] {name} nb={NB}: bitwise equal to plain, each row equal to the single "
            f"form; {r['batched_ms']:.4f} ms per call (device {dms}; single form "
            f"{r['ms']:.4f} ms; bound {b_ms:.4f} ms)"
            + (f"; the design before: {PREVIOUS_MS[name]['batched_ms']:.4f} ms per call, device "
               f"{PREVIOUS_MS[name]['batched_device_ms']:.4f} ms (an NVIDIA H100 80GB HBM3 at "
               "700 W)" if name in PREVIOUS_MS else ""))
    library_pair(rows["tri_solve_wavefront"], sweep, tri_lib, bs, 10, key="batched_")
    # the batched SpMV reads A once per chunk of 8 right-hand sides: nb = 9
    # is two chunks, each row still equal to the single form
    b9 = torch.as_tensor(rng.standard_normal((9, a.n)).astype(np.float32), device=dev)
    got = op(b9)
    require(bits_equal(got, ref.spmv_ell_ref(cols, evals, b9))
            and all(bits_equal(got[i], op(b9[i].contiguous())) for i in range(9)),
            "spmv_ell nb=9 != plain version or != the single form")
    say("[kernels] spmv_ell nb=9 (two chunks of right-hand sides): bitwise equal to plain, "
        "each row equal to the single form")
    return rows


def phase_sweep_window(dev, nx=400):
    """[sweep-window]: the sweep bitwise against its plain version where the
    shared-memory ring does not cover every gathered level, so far gathers
    read the device copy: poisson_2d(nx) ILU(1) with the ring capped to one
    level, and matgen(800, 0.01) ILU(2) (gathers up to 179 levels back)
    with the ring covering its window and capped to two levels; single and
    nb = 3."""
    import numpy as np
    import torch

    from repro_torch.core.matgen import matgen, poisson_2d
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.symbolic import pilu1_symbolic, symbolic_ilu_k
    from repro_torch.core.triangular import SWEEP_FIELDS, build_triangular_plan
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED + 8)
    for name, a, k, caps in ((f"poisson_2d({nx})", poisson_2d(nx), 1, (1,)),
                             ("matgen(800, 0.01)", matgen(800, 0.01), 2, (None, 2))):
        pattern = pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)
        plan = build_triangular_plan(pattern, numeric_ilu_ref(a, pattern))
        args = [torch.as_tensor(getattr(plan, f), device=dev) for f in SWEEP_FIELDS]
        bs = torch.as_tensor(rng.standard_normal((3, a.n)).astype(np.float32), device=dev)
        want = ref.tri_solve_wavefront_ref(*args, bs)
        for cap in caps:
            sweep = ops.TriSolveWavefront(*args, max_window=cap)
            rings = sweep.layout["ring_levels"]
            far = any(ring < r for ring, r in zip(rings, sweep.windows))
            require(far == (cap is not None), f"{name} cap {cap}: ring levels {rings} against "
                    f"windows {sweep.windows}")
            got = sweep(bs)
            require(bits_equal(got, want), f"the sweep on {name} ILU({k}) with the ring capped "
                    f"at {cap} != plain version")
            for i in range(3):
                require(bits_equal(got[i], sweep(bs[i].contiguous())),
                        f"the sweep on {name} cap {cap}: row {i} != the single form")
            say(f"[sweep-window] {name} ILU({k}): windows R = {sweep.windows} levels, ring "
                f"{'capped at ' + str(cap) if cap else 'uncapped'}: {json.dumps(sweep.layout)}; "
                + ("gathers past the ring read the device copy; " if far else "")
                + "nb=3 and single bitwise equal to plain")


def phase_large_tiles(dev, sizes=LARGE_TILES):
    """[large-tiles]: the tile kernels at sizes whose triangle or tile does
    not fit in the shared memory of one block (the variants that read it in
    place; above bs = 512 the variants that walk a row or column in chunks
    of 512), bitwise against their plain versions: tile_lu (out of place and
    in place), both solves (37 rows or columns: ragged), and both batched
    solves on 3 tiles of a pool, in place; tile_lu's device time and chain
    floor at each size."""
    import numpy as np
    import torch

    from repro_torch.kernels import build, ops, ref

    rng = np.random.default_rng(SEED + 9)
    on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    lib = build.load()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for bs in sizes:
        t = on(dominant_tile(rng, bs))
        packed = ops.tile_lu(t)
        want = ref.tile_lu_nopiv_ref(t)
        inplace = t.clone()
        ops.tile_lu(inplace, out=inplace)
        require(bits_equal(packed, want) and bits_equal(inplace, want),
                f"tile_lu at bs={bs} != plain version")
        a = on(rng.standard_normal((37, bs)).astype(np.float32))
        require(bits_equal(ops.trsm_right_upper(a, packed), ref.trsm_right_upper_ref(a, packed)),
                f"trsm_right_upper at bs={bs} != plain version")
        at = a.t().contiguous()
        require(bits_equal(ops.trsm_left_unit_lower(packed, at),
                           ref.trsm_left_unit_lower_ref(packed, at)),
                f"trsm_left_unit_lower at bs={bs} != plain version")
        pool = on(rng.standard_normal((4, bs, bs)).astype(np.float32))
        pool[1] = packed
        slots = torch.tensor([0, 2, 3], dtype=torch.int32, device=dev)
        for name in ("trsm_right_upper", "trsm_left_unit_lower"):
            got = getattr(ops, f"{name}_slots")(pool.clone(), 1, slots)
            require(bits_equal(got, getattr(ref, f"{name}_slots_ref")(pool.clone(), 1, slots)),
                    f"{name}_slots at bs={bs} != plain version")
        lu_ms = device_ms(lambda: ops.tile_lu(t),
                          "tile_lu_chunked_kernel" if bs > 512 else "tile_lu_kernel", reps=5)

        def lu_floor():
            err = lib.tile_lu_chain_floor_launch(bs, sink.data_ptr(),
                                                 torch.cuda.current_stream().cuda_stream)
            require(err == 0, f"the tile_lu chain floor kernel did not launch (CUDA error {err})")

        floor_ms = device_ms(lu_floor, "tile_lu_chain_floor_kernel", reps=5)
        was = PREVIOUS_TILE_MS.get(f"tile_lu_bs{bs}")
        say(f"[large-tiles] bs={bs}: tile_lu ({bs * bs * 4} B tile), the two solves "
            f"({bs * bs * 4} B triangle) and their batched forms bitwise equal to plain; "
            "tile_lu device "
            + ("not measured" if lu_ms is None else f"{lu_ms:.4f} ms")
            + (f" (the earlier design's {was:.3f} ms on path C)" if was else "")
            + ", chain floor " + ("not measured" if floor_ms is None else f"{floor_ms:.4f} ms"))


def wide_band_matrix(n=2100, seed=0):
    """A matrix whose TOP-ILU band does not fit in shared memory: row 0
    dense, every other row i holding (i, i-1) and (i, i); the diagonal 4n,
    the rest uniform in [-1, 1). ILU(0) at 32-row bands is 32 x n floats a
    band (268,800 B at n = 2100)."""
    import numpy as np

    from repro_torch.core.sparse import CSRMatrix

    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0, n], n + 2 * np.arange(1, n)]).astype(np.int64)
    rest = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1).reshape(-1)
    indices = np.concatenate([np.arange(n), rest]).astype(np.int32)
    data = rng.uniform(-1, 1, indices.size).astype(np.float32)
    data[0] = 4 * n
    data[n + 1::2] = 4 * n
    return CSRMatrix.from_arrays(n, indptr, indices, data)


def phase_wide_band(dev):
    """[wide-band]: a TOP-ILU band wider than shared memory factored on the
    card (superstep_factor in place in the value state), bitwise equal to
    the sequential oracle numeric_ilu_ref."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.numeric import make_superstep_factorizer
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.top_ilu import BandGroup
    from repro_torch.kernels import ops

    a = wide_band_matrix()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = ilu_sharded(a, 0, band_rows=BAND_ROWS, n_devices=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    band_bytes = BAND_ROWS * f.plan.width * 4
    require(band_bytes > 232448, f"the wide band is {band_bytes} B: it fits in shared memory")
    require(counts["superstep_factor"] == 1,
            f"wide band: {counts['superstep_factor']} superstep_factor launches for one "
            f"factorization of {f.plan.n_supersteps} supersteps")
    kernel = make_superstep_factorizer(f.plan, BandGroup(1, dev)).kernel
    require(not kernel.staged, "wide band: the persistent launch would stage a band wider "
            "than shared memory")
    require(np.array_equal(f.values_csr().view(np.int32),
                           numeric_ilu_ref(a, f.pattern).view(np.int32)),
            "wide band: the TOP-ILU factor on the card != numeric_ilu_ref")
    say(f"[wide-band] n={a.n} row 0 dense, ILU(0), {BAND_ROWS}-row bands of W={f.plan.width} "
        f"({band_bytes} B a band, above the 232,448 B of shared memory): "
        f"{counts['superstep_factor']} superstep_factor launch for {f.plan.n_supersteps} "
        f"supersteps, the bands in place in device memory, factor bitwise equal to "
        f"numeric_ilu_ref ({wall:.3f} s)")


def ell_to_csr(cols, vals, n):
    """A torch sparse CSR tensor of a sentinel-padded ELL pair (the
    yardstick's input; rows of an ELL pair hold their valid lanes first)."""
    import torch

    valid = cols < n
    crow = torch.zeros(n + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = torch.cumsum(valid.sum(dim=1), dim=0)
    return torch.sparse_csr_tensor(crow, cols[valid].long(), vals[valid], size=(n, n),
                                   check_invariants=False)


def inverse_full_size(dev, pattern, vals):
    """[inverse] at full size: the plan's time on the host, the value
    loop's on the card (two runs: the first pays PyTorch's first launches)
    and on the CPU, and W/Z from the card bitwise equal to the CPU's."""
    import torch

    from repro_torch.core.inverse import build_inverse_plan, compute_inverse_values

    t0 = time.perf_counter()
    plan = build_inverse_plan(pattern, vals)
    plan_s = time.perf_counter() - t0
    card_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wz = compute_inverse_values(plan, dev)
        torch.cuda.synchronize()
        card_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    wz_cpu = compute_inverse_values(plan, "cpu")
    cpu_s = time.perf_counter() - t0
    for name, got, want in zip("WZ", wz, wz_cpu):
        require(bits_equal(got.cpu(), want), f"inverse values {name}: card != CPU at full size")
    say(f"[inverse] poisson_2d(400) ILU(1): W {plan.w_cols.shape} Z {plan.z_cols.shape}, "
        f"{plan.nnz_inverse()} stored entries; value chain {plan.depth} levels (L then U); "
        f"l_addr {plan.l_addr.shape}")
    say(f"[inverse] plan {plan_s:.3f} s (host); values on the card {card_s[0]:.3f} s "
        f"(first run), {card_s[1]:.3f} s (second); on the CPU {cpu_s:.3f} s; "
        f"W/Z on the card bitwise equal to the CPU's")
    return plan, wz


def phase_factors(dev):
    import numpy as np

    from repro_torch.core.api import ilu
    from repro_torch.core.matgen import convection_diffusion_2d, poisson_2d
    from repro_torch.core.numeric_ref import numeric_ilu_ref

    for name, a in (("convection_diffusion_2d(32)", convection_diffusion_2d(32)),
                    ("poisson_2d(64)", poisson_2d(64))):
        for k in (0, 1, 2):
            f = ilu(a, k, device=dev)
            want = numeric_ilu_ref(a, f.pattern)
            require(np.array_equal(f.vals.view(np.int32), want.view(np.int32)),
                    f"factor values of {name} k={k} != numeric_ilu_ref")
            t = ilu(a, k, backend="topilu", n_devices=SHARDED_D, band_rows=BAND_ROWS, device=dev)
            require(np.array_equal(t.vals.view(np.int32), want.view(np.int32)),
                    f"TOP-ILU values of {name} k={k} (D={SHARDED_D}) != numeric_ilu_ref")
            say(f"[factors] {name} k={k}: nnz={f.nnz} bitwise equal to numeric_ilu_ref "
                f"(factor_wavefront, and TOP-ILU over {SHARDED_D} band owners)")


def small_matrix(name):
    from repro_torch.core import matgen

    return {"poisson_2d(64)": lambda: matgen.poisson_2d(64),
            "convection_diffusion_2d(32)": lambda: matgen.convection_diffusion_2d(32),
            "poisson_2d(40)": lambda: matgen.poisson_2d(40),
            "convection_diffusion_2d(24)": lambda: matgen.convection_diffusion_2d(24)}[name]()


def inverse_oracle(name, k):
    """The sequential inverse oracle of one small fixture, in a worker
    process: (w_cols, w_vals, z_cols, z_vals) from ``inverse_values_ref`` on
    the oracle factor ``numeric_ilu_ref``."""
    sys.path.insert(0, str(SRC))
    from repro_torch.core.inverse_ref import inverse_pattern_ref, inverse_values_ref
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.symbolic import pilu1_symbolic, symbolic_ilu_k

    a = small_matrix(name)
    pattern = pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)
    vals = numeric_ilu_ref(a, pattern)
    w_cols, z_cols = inverse_pattern_ref(pattern)
    w_vals, z_vals = inverse_values_ref(pattern, vals, w_cols, z_cols)
    return w_cols, w_vals, z_cols, z_vals


def phase_inverse_oracles(dev, oracles):
    """W/Z computed on the card (from the card's factor) against the
    sequential oracle, bitwise."""
    import numpy as np

    from repro_torch.core.api import ilu

    for (name, k), fut in oracles.items():
        f = ilu(small_matrix(name), k, device=dev)
        ap = f.precond("inverse")
        w_cols, w_vals, z_cols, z_vals = fut.result()
        require(np.array_equal(ap.plan.w_cols, w_cols) and np.array_equal(ap.plan.z_cols, z_cols),
                f"inverse pattern of {name} k={k} != inverse_pattern_ref")
        require(bits_equal(ap.w_vals.cpu(), w_vals) and bits_equal(ap.z_vals.cpu(), z_vals),
                f"inverse values of {name} k={k} on the card != inverse_values_ref")
        say(f"[inverse] {name} k={k}: W {w_cols.shape} Z {z_cols.shape} on the card bitwise "
            f"equal to inverse_values_ref")


def true_residual(a, b, x):
    import numpy as np

    r = b.astype(np.float64) - a.to_scipy().astype(np.float64) @ x.astype(np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b.astype(np.float64)))


def check_launches(path, counts, launched, idle=()):
    """The path launched each kernel of ``launched`` and none of ``idle``,
    nor the bf16 panel update, which no path runs (every pool is float32)."""
    say(f"[{path}] kernel launches: {json.dumps(counts)}")
    for name in launched:
        require(counts[name] > 0, f"the {path} path never launched {name}")
    for name in (*idle, "panel_update_bf16"):
        require(counts[name] == 0, f"the {path} path launched {name}")


def phase_main_path(dev):
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_with_ilu
    from repro_torch.kernels import ops

    a = poisson_2d(400)
    b = np.random.default_rng(SEED + 1).standard_normal(a.n).astype(np.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_with_ilu(a, b, k=1, method="gmres", tol=TOL, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    true_rel = true_residual(a, b, res.x)
    say(f"[main] poisson_2d(400) n={a.n} ILU(1) GMRES(30) tol={TOL}: verdict={res.verdict} "
        f"inner steps={res.iterations} restarts={len(res.history)} "
        f"residual={res.residual:.3e} float64 true residual={true_rel:.3e}")
    say(f"[main] wall {wall:.3f} s = factor {factor_s:.3f} s (symbolic "
        f"{fact.symbolic_seconds:.3f} s, numeric incl. planning {fact.numeric_seconds:.3f} s)"
        f" + solve {wall - factor_s:.3f} s (ELL, sweep plan, GMRES)")
    check_launches("main", counts, ("spmv_ell", "factor_wavefront", "tri_solve_wavefront"),
                   idle=("inverse_chain",))
    require(res.verdict == "converged", f"main solve verdict {res.verdict}")
    require(np.isfinite(res.x).all() and res.x.shape == (a.n,), "main solve x malformed")
    require(true_rel <= 2 * TOL, f"float64 true residual {true_rel:.3e} > 2*tol")
    profile_resolve("main", a, b, dev, tol=TOL)
    return counts, b, res, wall, fact


def phase_main_inverse(dev, b):
    """Path A: the same solve through the incomplete-inverse preconditioner."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_with_ilu
    from repro_torch.kernels import ops

    a = poisson_2d(400)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_with_ilu(a, b, k=1, tol=INV_TOL, precond_method="inverse", device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    true_rel = true_residual(a, b, res.x)
    say(f"[main-inverse] poisson_2d(400) ILU(1) inverse GMRES(30) tol={INV_TOL}: "
        f"verdict={res.verdict} inner steps={res.iterations} restarts={len(res.history)} "
        f"residual={res.residual:.3e} float64 true residual={true_rel:.3e}")
    say(f"[main-inverse] wall {wall:.3f} s = factor {factor_s:.3f} s + solve "
        f"{wall - factor_s:.3f} s (ELL, inverse plan and values, GMRES)")
    check_launches("main-inverse", counts, ("spmv_ell", "factor_wavefront", "inverse_chain"),
                   idle=("tri_solve_wavefront",))
    require(res.verdict == "converged", f"inverse solve verdict {res.verdict}")
    require(np.isfinite(res.x).all() and res.x.shape == (a.n,), "inverse solve x malformed")
    require(true_rel <= 2 * INV_TOL, f"float64 true residual {true_rel:.3e} > 2*tol")
    profile_resolve("main-inverse", a, b, dev, tol=INV_TOL, precond_method="inverse")
    return counts, res


def phase_multi_rhs(dev, b, single, single_wall):
    """Path B: four right-hand sides in one batched solve; lane 0 is the
    main path's b and must reproduce its solve bitwise."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_with_ilu
    from repro_torch.kernels import ops

    a = poisson_2d(400)
    bs = np.random.default_rng(SEED + 4).standard_normal((NB, a.n)).astype(np.float32)
    bs[0] = b
    # a mixed-tolerance batch, as a serving coalescer forms one. At 1e-5
    # lane 2 stalls at a float32 true residual of 1.3e-5 (40 restarts end
    # `maxiter`), so lanes 2-3 ask for 1e-4; lane 0 keeps phase 4's tol.
    tols = np.array([TOL, TOL, INV_TOL, INV_TOL], np.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rs, fact = solve_with_ilu(a, bs, k=1, tol=tols, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for i, r in enumerate(rs):
        true_rel = true_residual(a, bs[i], r.x)
        say(f"[multi-rhs] lane {i} tol={tols[i]:.0e}: verdict={r.verdict} inner steps="
            f"{r.iterations} restarts={len(r.history)} float64 true residual={true_rel:.3e}")
        require(r.verdict == "converged", f"multi-RHS lane {i} verdict {r.verdict}")
        require(true_rel <= 2 * tols[i], f"multi-RHS lane {i} true residual {true_rel:.3e} "
                "> 2*tol")
    require(bits_equal(rs[0].x, single.x) and rs[0].iterations == single.iterations,
            "multi-RHS lane 0 != the main path's single solve")
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    say(f"[multi-rhs] lane 0 bitwise equal to the main solve ({single.iterations} steps); "
        f"wall {wall:.3f} s for {NB} right-hand sides = {wall / NB:.3f} s per RHS, against "
        f"{single_wall:.3f} s for the single solve (both include a factorization; here "
        f"factor {factor_s:.3f} s)")
    check_launches("multi-rhs", counts, ("spmv_ell", "factor_wavefront", "tri_solve_wavefront"),
                   idle=("inverse_chain",))
    profile_resolve("multi-rhs", a, bs, dev, tol=tols)
    return counts, (bs, tols, rs)


def profile_resolve(path, a, b, dev, solve=None, activities=("cpu", "cuda"), **kw):
    """Where the solve's time goes: one restart (30 Arnoldi steps) of the
    same solve again, with the factorization, its preconditioner and the
    matvec cached on the matrix, so this is the GMRES part alone, under
    torch.profiler (one restart keeps the trace small); device busy time =
    the sum of kernel durations. ``solve`` defaults to ``solve_with_ilu``;
    ``activities=("cuda",)`` traces the device alone (a smaller trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.solvers import solve_with_ilu

    solve = solve or solve_with_ilu
    acts = [{"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}[x] for x in activities]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve(a, b, k=1, method="gmres", device=dev, maxiter=1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = kernel_events(prof)
    busy = sum(us for _, us in events) / 1e6
    by_name = {}
    for name, us in events:
        key = name.split("(")[0][:60]
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, t + us / 1e6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    say(f"[profile {path}] one restart (cached factor) under torch.profiler: wall {wall:.3f} s,"
        f" {len(events)} kernels, device busy {busy:.3f} s ({100 * busy / wall:.1f}% of wall)")
    for name, (n, t) in top:
        say(f"[profile {path}]   {t:.4f} s in {n} launches of {name}")


def phase_card_vs_cpu(dev):
    import numpy as np

    from repro_torch.core.solvers import solve_with_ilu

    tols = np.array([1e-5, 1e-4, 1e-3], np.float32)
    for name in CARD_VS_CPU:
        a = small_matrix(name)
        b = np.random.default_rng(SEED + 2).standard_normal(a.n).astype(np.float32)
        bs = np.random.default_rng(SEED + 3).standard_normal((3, a.n)).astype(np.float32)
        for label, rhs, kw in (("sweep", b, dict(tol=TOL)),
                               ("inverse", b, dict(tol=TOL, precond_method="inverse")),
                               ("bicgstab", b, dict(tol=TOL, method="bicgstab")),
                               ("inverse nb=3, per-lane tol", bs,
                                dict(tol=tols, precond_method="inverse"))):
            gpu, _ = solve_with_ilu(a, rhs, k=1, device=dev, **kw)
            cpu, _ = solve_with_ilu(a, rhs, k=1, device="cpu", **kw)
            gpu, cpu = (r if isinstance(r, list) else [r] for r in (gpu, cpu))
            same = all(np.array_equal(g.x.view(np.int32), c.x.view(np.int32))
                       for g, c in zip(gpu, cpu))
            say(f"[card-vs-cpu] {name} {label}: steps {[g.iterations for g in gpu]} (card) vs "
                f"{[c.iterations for c in cpu]} (cpu), verdict {[g.verdict for g in gpu]}/"
                f"{[c.verdict for c in cpu]}, x bitwise equal: {same}")
            require(same and [(g.iterations, g.verdict) for g in gpu]
                    == [(c.iterations, c.verdict) for c in cpu],
                    f"card solve != CPU solve on {name} {label}")


def dominant_tile(rng, bs):
    import numpy as np

    t = rng.standard_normal((bs, bs)).astype(np.float32)
    return t + np.diag(np.abs(t).sum(1) + 1).astype(np.float32)


def pivot_lists(nx, bs):
    """The tile pattern of Block-ILU(1) of poisson_2d(nx) at tile size bs,
    and its per-pivot slot lists (``bilu._pivot_lists``)."""
    from repro_torch.core import bilu as bilu_mod
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.symbolic import symbolic_ilu_k

    tpat = symbolic_ilu_k(bilu_mod.tile_adjacency(poisson_2d(nx), bs), 1)
    return tpat, bilu_mod._pivot_lists(tpat)


def phase_tile_kernels(dev, bs=BS_TILE, nx=400):
    """[tiles]: the four dense-tile kernels of Block-ILU(k) at the path's
    (bs, bs) shapes against their plain versions on the card (bitwise, but
    the panel product, which is held to 2·K·2^-24·(|C| + |A||B|) of a float64
    product), each at ragged shapes too; the batched tile solves on a real
    pivot's slot list of path C, in place on a pool; the grouped panel
    update on path C's pivot with the most products (16) against one single
    call per product, bitwise; the bf16 panel update; then their times
    beside the bound and a PyTorch yardstick (cuBLAS, cuSOLVER), timed and
    never used: per call, device time from the trace, and the two in turns
    (200 each); tile_lu's chain floor."""
    import numpy as np
    import torch

    from repro_torch.core import bilu as bilu_mod
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain product and addmm in float32
    rng = np.random.default_rng(SEED + 5)
    on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    t = on(dominant_tile(rng, bs))
    a, b, c = (on(rng.standard_normal((bs, bs)).astype(np.float32)) for _ in range(3))

    packed = ops.tile_lu(t)
    require(bits_equal(packed, ref.tile_lu_nopiv_ref(t)), "tile_lu kernel != plain version")
    for m in (bs, 3 * bs + 5):
        p = on(rng.standard_normal((m, bs)).astype(np.float32))
        require(bits_equal(ops.trsm_right_upper(p, packed), ref.trsm_right_upper_ref(p, packed)),
                f"trsm_right_upper kernel != plain version at M={m}")
        q = p.t().contiguous()
        require(bits_equal(ops.trsm_left_unit_lower(packed, q),
                           ref.trsm_left_unit_lower_ref(packed, q)),
                f"trsm_left_unit_lower kernel != plain version at N={m}")
        # mostly zero rows, as path C's L tiles: zero numerators (signed,
        # against negative pivots too) take the divide's shortcut
        sp, signed = p.clone(), packed.clone()
        sp[:, bs // 8:] = 0.0
        sp[1::2, bs // 4:] = -0.0
        sp[::3, bs // 3] = 1e-39
        signed[torch.arange(0, bs, 3), torch.arange(0, bs, 3)] *= -1
        require(bits_equal(ops.trsm_right_upper(sp, signed), ref.trsm_right_upper_ref(sp, signed)),
                f"trsm_right_upper kernel != plain version on a sparse panel at M={m}")
    for m, n, k in ((bs, bs, bs), (96, 40, 72), (3 * bs + 5, bs - 3, 2 * bs + 1)):
        pa, pb, pc = (on(rng.standard_normal(s).astype(np.float32))
                      for s in ((m, k), (k, n), (m, n)))
        got = ops.panel_update(pc, pa, pb).double()
        exact = pc.double() - pa.double() @ pb.double()
        limit = 2 * k * 2.0 ** -24 * (pc.double().abs() + pa.double().abs() @ pb.double().abs())
        require(bool(((got - exact).abs() <= limit).all()),
                f"panel_update ({m}, {k}) x ({k}, {n}) off by more than 2K*2^-24*(|C|+|A||B|)")
        # the bf16 form: float32 sums of the same products, then one rounding
        # to bf16, so within 2^-8 of |exact| on top of the float32 bound
        ha, hb, hc = (x.to(torch.bfloat16) for x in (pa, pb, pc))
        got = ops.panel_update(hc, ha, hb)
        require(got.dtype == torch.bfloat16, "panel_update bf16: the result is not bf16")
        exact = hc.double() - ha.double() @ hb.double()
        limit = 2.0 ** -8 * exact.abs() + (1 + 2.0 ** -8) * 2 * k * 2.0 ** -24 * (
            hc.double().abs() + ha.double().abs() @ hb.double().abs())
        require(bool(((got.double() - exact).abs() <= limit).all()),
                f"panel_update bf16 ({m}, {k}) x ({k}, {n}) off by more than "
                "2^-8*|exact| + (1+2^-8)*2K*2^-24*(|C|+|A||B|)")
    inplace = c.clone()
    ops.panel_update(inplace, a, b, out=inplace)
    require(bits_equal(inplace, ops.panel_update(c, a, b)), "panel_update in place != out of place")

    # the batched solves on a pivot of path C with 4 tiles in each list, in
    # place on a pool of the path's size (random tiles in the listed slots
    # and the packed LU tile in the diagonal one); every other slot must
    # keep its bits
    tpat, (u_ptr, u_slots, l_ptr, l_slots, diag) = pivot_lists(nx, bs)
    full = np.flatnonzero((np.diff(u_ptr) == 4) & (np.diff(l_ptr) == 4))
    require(full.size > 0, "no pivot of path C has 4 tiles in both lists")
    piv = int(full[0])
    d = int(diag[piv])
    lists = {"trsm_left_unit_lower": u_slots[u_ptr[piv]:u_ptr[piv + 1]],
             "trsm_right_upper": l_slots[l_ptr[piv]:l_ptr[piv + 1]]}
    pool = torch.zeros((tpat.nnz, bs, bs), dtype=torch.float32, device=dev)
    pool[d] = packed
    for slots in lists.values():
        pool[torch.as_tensor(slots, device=dev)] = on(
            rng.standard_normal((slots.size, bs, bs)).astype(np.float32))
    batched = {}
    for name, slots in lists.items():
        dslots = torch.as_tensor(slots.astype(np.int32), device=dev)
        got = getattr(ops, f"{name}_slots")(pool.clone(), d, dslots)
        want = getattr(ref, f"{name}_slots_ref")(pool.clone(), d, dslots)
        require(bits_equal(got, want), f"{name}_slots kernel != plain version on pivot {piv}'s "
                f"tiles {slots.tolist()} (or a slot it does not list changed)")
        # timed on fresh tiles: one copy of the 4 tiles for every call that
        # time_ms and device_ms make (warm-up, timed runs, every trace
        # attempt), so no call re-solves a solved tile; a run past the last
        # copy stops with StopIteration
        R = 1 + 50 + 1 + 20 * sum(4 ** i for i in range(3))
        tpool = torch.empty((4 * R + 1, bs, bs), dtype=torch.float32, device=dev)
        tpool[0] = packed
        tpool[1:] = pool[torch.as_tensor(slots, device=dev)].repeat(R, 1, 1)
        sets = iter(torch.arange(1, 4 * R + 1, dtype=torch.int32, device=dev).view(R, 4))
        fn = getattr(ops, f"{name}_slots")
        run = lambda: fn(tpool, 0, next(sets))  # noqa: E731
        tiles = pool[torch.as_tensor(slots, device=dev)]
        if name == "trsm_right_upper":
            panel = tiles.reshape(4 * bs, bs)  # the 4 tiles stacked: one (4bs, bs) panel
            lib = lambda: torch.linalg.solve_triangular(packed, panel, upper=True,  # noqa: E731
                                                        left=False)
        else:
            panel = tiles.permute(1, 0, 2).reshape(bs, 4 * bs).contiguous()  # side by side
            lib = lambda: torch.linalg.solve_triangular(packed, panel, upper=False,  # noqa: E731
                                                        unitriangular=True)
        batched[name] = dict(batched_pivot=piv, batched_tiles=int(slots.size),
                             batched_ms=time_ms(run, reps=50),
                             batched_device_ms=device_ms(run, f"{name}_kernel", reps=20,
                                                         attempts=3),
                             batched_library_ms=time_ms(lib, reps=50),
                             batched_library="one solve_triangular on the 4 tiles as one panel")

    # the grouped panel update on the pivot of path C with the most products
    # (16 at bs = 128), in place on a pool of the path's size, against one
    # single call per product on the same tiles (bitwise); its yardstick is
    # one torch.baddbmm over the pivot's tiles gathered beforehand
    p_ptr, p_l, p_u, p_dst = bilu_mod._pivot_products(tpat, (u_ptr, u_slots, l_ptr, l_slots,
                                                             diag))
    gpiv = int(np.argmax(np.diff(p_ptr)))
    gs, ge = int(p_ptr[gpiv]), int(p_ptr[gpiv + 1])
    glists = (p_l[gs:ge], p_u[gs:ge], p_dst[gs:ge])
    gpool = torch.zeros((tpat.nnz, bs, bs), dtype=torch.float32, device=dev)
    touched = np.unique(np.concatenate(glists))
    gpool[on(touched)] = on(rng.standard_normal((touched.size, bs, bs)).astype(np.float32))
    gl, gu, gd = (on(x.astype(np.int32)) for x in glists)
    single = gpool.clone()
    for l, u, d in zip(*(x.tolist() for x in glists)):
        ops.panel_update(single[d], single[l], single[u], out=single[d])
    got = ops.panel_update_slots(gpool.clone(), gl, gu, gd)
    require(bits_equal(got, single), f"panel_update_slots on pivot {gpiv}'s {ge - gs} products "
            "!= one single call per product (or a tile it does not list changed)")
    del got, single
    gathered = [gpool[x.long()] for x in (gd, gl, gu)]
    grun = lambda: ops.panel_update_slots(gpool, gl, gu, gd)  # noqa: E731
    glib = lambda: torch.baddbmm(*gathered, alpha=-1)  # noqa: E731
    g_bytes = (np.unique(glists[0]).size + np.unique(glists[1]).size + 2 * (ge - gs)) * bs * bs * 4
    g_bound, g_by = bound(g_bytes, (ge - gs) * (2 * bs ** 3 + bs * bs))
    g_turns = time_pair_ms(grun, glib, reps=200)
    grouped = dict(grouped_pivot=gpiv, grouped_products=ge - gs, grouped_ms=time_ms(grun, 50),
                   grouped_device_ms=device_ms(grun, "panel_update_kernel", reps=20),
                   grouped_bound_ms=g_bound, grouped_bound_by=g_by,
                   grouped_library="torch.baddbmm(c, l, u, alpha=-1) over the gathered tiles",
                   grouped_library_ms=time_ms(glib, 50),
                   grouped_library_device_ms=device_ms_all(glib),
                   grouped_turns_ms=g_turns[0], grouped_turns_library_ms=g_turns[1])
    del gpool, gathered

    # tile_lu's chain floor: the same rows, warps and count exchanges with
    # no arithmetic
    lib = build.load()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)

    def lu_floor():
        err = lib.tile_lu_chain_floor_launch(bs, sink.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the tile_lu chain floor kernel did not launch (CUDA error {err})")

    def row(name, source, replaces, fn, plain, lib, nbytes, nops, got, want, kernel,
            flop_per_s=F32_FLOP_PER_S, **extra):
        b_ms, b_by = bound(nbytes, nops, flop_per_s)
        turns = time_pair_ms(fn, lib, reps=200)
        return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=0, max_abs_err=max_abs_err(got, want),
                    ms=time_ms(fn, reps=50), plain_ms=time_ms(plain, reps=3), bound_ms=b_ms,
                    bound_by=b_by, library_ms=time_ms(lib, reps=50),
                    device_ms=device_ms(fn, kernel, reps=20),
                    library_device_ms=device_ms_all(lib), turns_ms=turns[0],
                    turns_library_ms=turns[1], **extra)

    tri = bs * (bs + 1) // 2
    ha, hb, hc = (x.to(torch.bfloat16) for x in (a, b, c))
    rows = {
        "panel_update": row(
            "panel_update", "panel_update.cu", "src/repro/kernels/panel_update.py:61",
            lambda: ops.panel_update(c, a, b), lambda: ref.panel_update_ref(c, a, b),
            lambda: torch.addmm(c, a, b, alpha=-1), 4 * 4 * bs * bs, 2 * bs ** 3 + bs * bs,
            ops.panel_update(c, a, b), ref.panel_update_ref(c, a, b), "panel_update_kernel",
            library="torch.addmm(c, a, b, alpha=-1), TF32 off", **grouped),
        "panel_update_bf16": row(
            "panel_update_bf16", "panel_update.cu", "src/repro/kernels/panel_update.py:61",
            lambda: ops.panel_update(hc, ha, hb), lambda: ref.panel_update_ref(hc, ha, hb),
            lambda: torch.addmm(hc, ha, hb, alpha=-1), 4 * 2 * bs * bs, 2 * bs ** 3 + bs * bs,
            ops.panel_update(hc, ha, hb), ref.panel_update_ref(hc, ha, hb),
            "panel_update_mma_kernel", flop_per_s=BF16_FLOP_PER_S,
            library="torch.addmm(c, a, b, alpha=-1) in bf16",
            note="the bf16 form (bf16 inputs and output, float32 sums on the tensor cores); "
                 "no path runs it"),
        "trsm_right_upper": row(
            "trsm_right_upper", "trsm.cu", "src/repro/kernels/tri_solve.py:59",
            lambda: ops.trsm_right_upper(a, packed), lambda: ref.trsm_right_upper_ref(a, packed),
            lambda: torch.linalg.solve_triangular(packed, a, upper=True, left=False),
            4 * (2 * bs * bs + tri), bs * (bs * bs + bs),
            ops.trsm_right_upper(a, packed), ref.trsm_right_upper_ref(a, packed),
            "trsm_right_upper_kernel",
            library="torch.linalg.solve_triangular(u, a, upper=True, left=False)",
            **batched["trsm_right_upper"]),
        "trsm_left_unit_lower": row(
            "trsm_left_unit_lower", "trsm.cu", "src/repro/kernels/tri_solve.py:79",
            lambda: ops.trsm_left_unit_lower(packed, a),
            lambda: ref.trsm_left_unit_lower_ref(packed, a),
            lambda: torch.linalg.solve_triangular(packed, a, upper=False, unitriangular=True),
            4 * (2 * bs * bs + tri - bs), bs * bs * bs,
            ops.trsm_left_unit_lower(packed, a), ref.trsm_left_unit_lower_ref(packed, a),
            "trsm_left_unit_lower_kernel",
            library="torch.linalg.solve_triangular(l, a, upper=False, unitriangular=True)",
            **batched["trsm_left_unit_lower"]),
        "tile_lu": row(
            "tile_lu", "tile_lu.cu", "src/repro/core/bilu.py:83", lambda: ops.tile_lu(t),
            lambda: ref.tile_lu_nopiv_ref(t), lambda: torch.linalg.lu_factor(t, pivot=False),
            4 * 2 * bs * bs, sum(w + 2 * w * w for w in range(bs)), packed,
            ref.tile_lu_nopiv_ref(t), "tile_lu_kernel", port_only=True,
            note="no TPU kernel: the JAX package runs _lu_nopiv as plain JAX",
            library="torch.linalg.lu_factor(t, pivot=False)", chain_steps=bs,
            chain_floor_device_ms=device_ms(lu_floor, "tile_lu_chain_floor_kernel", reps=20)),
    }
    for r in rows.values():
        dms, ldms = ("not measured" if v is None else f"{v:.4f} ms"
                     for v in (r["device_ms"], r["library_device_ms"]))
        was = PREVIOUS_TILE_MS.get(r["name"])
        say(f"[tiles] {r['name']} ({bs}, {bs}): "
            + (f"within the tolerance above of float64, max |diff| to plain "
               f"{r['max_abs_err']:.3e}" if r["name"].startswith("panel_update")
               else "bitwise equal to plain")
            + f"; {r['ms']:.4f} ms per call (device {dms}"
            + (f", the earlier design's {was:.4f} ms" if was else "")
            + f"; plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']}); library {r['library_ms']:.4f} ms per call, device {ldms} "
            f"({r['library']}); in turns, 200 each: {r['turns_ms']:.4f} ms against "
            f"{r['turns_library_ms']:.4f} ms")
    r = rows["panel_update"]
    gdms, gldms = ("not measured" if v is None else f"{v:.4f} ms"
                   for v in (r["grouped_device_ms"], r["grouped_library_device_ms"]))
    say(f"[tiles] panel_update_slots: pivot {r['grouped_pivot']}'s {r['grouped_products']} "
        f"({bs}, {bs})^2 products in one launch, bitwise equal to one single call each, in "
        f"place; {r['grouped_ms']:.4f} ms per call (device {gdms}; bound "
        f"{r['grouped_bound_ms']:.5f} ms by {r['grouped_bound_by']}); library "
        f"{r['grouped_library_ms']:.4f} ms per call, device {gldms} ({r['grouped_library']}); "
        f"in turns, 200 each: {r['grouped_turns_ms']:.4f} ms against "
        f"{r['grouped_turns_library_ms']:.4f} ms")
    r = rows["tile_lu"]
    if r["device_ms"] is not None:
        r["us_per_row_step"] = r["device_ms"] * 1e3 / bs
    fl = r["chain_floor_device_ms"]
    say(f"[tiles] tile_lu: a chain of {bs} rows, "
        + ("device time not measured" if r["device_ms"] is None
           else f"{r['us_per_row_step']:.4f} us per row")
        + "; chain floor (the count exchanges alone) "
        + ("not measured" if fl is None else f"{fl:.4f} ms"))
    for name, was in PREVIOUS_TRSM_MS.items():
        r = rows[name]
        if r["device_ms"] is not None:
            r.update(chain_steps=bs, us_per_step=r["device_ms"] * 1e3 / bs)
        bdms = ("not measured" if r["batched_device_ms"] is None
                else f"{r['batched_device_ms']:.4f} ms")
        say(f"[tiles] {name}: chain of {bs} dependent steps, "
            + ("device time not measured" if r["device_ms"] is None
               else f"{r['us_per_step']:.4f} us per step")
            + f"; the left-looking design took {was[0]:.4f} ms per call, device {was[1]:.4f} ms"
            f"; batched, pivot {r['batched_pivot']}'s {r['batched_tiles']} tiles in one launch "
            f"(bitwise equal to plain, in place): {r['batched_ms']:.4f} ms per call (device "
            f"{bdms}), library {r['batched_library_ms']:.4f} ms ({r['batched_library']})")
    return rows


def bilu_schedule(fact):
    """What the factorization must have done, reckoned from its tile
    pattern alone: the launches of each tile kernel (a tile LU per pivot;
    one left and one right solve per pivot that has U or L tiles, each
    solving all of them; one panel update per pivot that has products, each
    running all of them), the tiles each kind of solve handles and the
    products (``panel_update``), and every product L_IK U_KJ
    (K <= min(I, J)) that adds up to a kept tile (I, J), as slot triples
    (slot of L_IK, slot of U_KJ, slot of (I, J))."""
    import numpy as np

    tpat, index = fact.tile_pattern, fact.tile_index
    nt = tpat.n
    rows = np.repeat(np.arange(nt), np.diff(tpat.indptr))
    upper, lower = tpat.indices > rows, tpat.indices < rows
    below = [[] for _ in range(nt)]
    for i, k in zip(rows[lower].tolist(), tpat.indices[lower].tolist()):
        below[k].append(i)
    counts = {"tile_lu": nt,
              "trsm_left_unit_lower": int(np.unique(rows[upper]).size),
              "trsm_right_upper": int(np.unique(tpat.indices[lower]).size),
              "panel_update": 0}
    solved = {"trsm_left_unit_lower": int(upper.sum()), "trsm_right_upper": int(lower.sum()),
              "panel_update": 0}
    triples = []
    for k in range(nt):
        cols = [int(j) for j in tpat.indices[tpat.indptr[k]:tpat.indptr[k + 1]] if j >= k]
        products = 0
        for i in [k] + below[k]:
            for j in cols:
                dst = index.get((i, j))
                if dst is not None:
                    triples.append((index[(i, k)], index[(k, j)], dst))
                    products += i > k and j > k
        counts["panel_update"] += products > 0
        solved["panel_update"] += products
    return counts, solved, np.array(triples, np.int64)


def per_tile_pool(a, fact, dev):
    """The numeric phase once more in the per-tile order of the JAX loop,
    through the single-tile kernels: per pivot the tile LU, each left
    solve, then for each tile row J below, ascending, its right solve and
    that row's panel updates in ascending column. Returns the pool."""
    import torch

    from repro_torch.core.bilu import _scatter_a
    from repro_torch.kernels import ops

    tpat, index = fact.tile_pattern, fact.tile_index
    pool = _scatter_a(a, tpat, fact.bs, dev)
    below = [[] for _ in range(tpat.n)]
    for r, c in sorted(index):
        if r > c:
            below[c].append(r)
    for i in range(tpat.n):
        d = pool[index[(i, i)]]
        ops.tile_lu(d, out=d)
        urow = [int(c) for c in tpat.row(i)[0] if c > i]
        for t in urow:
            u = pool[index[(i, t)]]
            ops.trsm_left_unit_lower(d, u, out=u)
        for j in below[i]:
            lj = pool[index[(j, i)]]
            ops.trsm_right_upper(lj, d, out=lj)
            for t in urow:
                slot = index.get((j, t))
                if slot is not None:
                    c = pool[slot]
                    ops.panel_update(c, lj, pool[index[(i, t)]], out=c)
    torch.cuda.synchronize()
    return pool


def tile_lu_residual(fact, a, triples, dev):
    """max |(L U)_IJ - A_IJ| over every kept tile, in float64 on the card,
    summing the pattern's tile products (no dense n x n); the padded rows
    of A carry 1.0 on the diagonal, as in the factorization."""
    import numpy as np
    import torch

    bs, nt = fact.bs, fact.n_tiles
    keys = np.array(list(fact.tile_index.keys()), np.int64)
    slots = np.array(list(fact.tile_index.values()), np.int64)
    order = np.argsort(keys[:, 0] * nt + keys[:, 1])
    sorted_keys = (keys[:, 0] * nt + keys[:, 1])[order]
    row = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    col = a.indices.astype(np.int64)
    pad = np.arange(a.n, nt * bs, dtype=np.int64)
    row, col = np.concatenate([row, pad]), np.concatenate([col, pad])
    vals = np.concatenate([a.data.astype(np.float64), np.ones(pad.size)])
    where = np.searchsorted(sorted_keys, (row // bs) * nt + col // bs)
    slot = slots[order][where]
    tiles = fact.tiles.double()
    diag = torch.as_tensor(slots[keys[:, 0] == keys[:, 1]], device=dev)
    eye = torch.eye(bs, dtype=torch.float64, device=dev)
    lo, up = tiles.clone(), tiles
    lo[diag] = torch.tril(tiles[diag], -1) + eye
    up[diag] = torch.triu(tiles[diag])
    lu = torch.zeros_like(tiles)
    tr = torch.as_tensor(triples, device=dev)
    step = max(1, (1 << 27) // (bs * bs))  # 1 GB of float64 products at a time
    for s in range(0, tr.shape[0], step):
        part = tr[s:s + step]
        lu.index_add_(0, part[:, 2], torch.bmm(lo[part[:, 0]], up[part[:, 1]]))
    flat = torch.as_tensor((slot * bs + row % bs) * bs + col % bs, device=dev)
    lu.view(-1)[flat] -= torch.as_tensor(vals, device=dev)
    return float(lu.abs().max())


def phase_bilu(dev, bs, nx=400):
    """Path C: Block-ILU(1) of poisson_2d(nx) at tile size bs."""
    import numpy as np
    import torch

    from repro_torch.core.bilu import bilu
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.symbolic import pilu1_symbolic
    from repro_torch.kernels import ops

    a = poisson_2d(nx)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fact = bilu(a, 1, bs=bs, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    want, solved, triples = bilu_schedule(fact)
    reckon_s = time.perf_counter() - t0
    tag = f"bilu bs={bs}"
    say(f"[{tag}] poisson_2d({nx}) n={a.n} BILU(1): {fact.n_tiles} tile rows, "
        f"{len(fact.tile_index)} tiles ({fact.tiles.numel() * 4 / 1e6:.1f} MB pool); wall "
        f"{wall:.3f} s = host plan {fact.plan_seconds:.3f} s + numeric "
        f"{fact.numeric_seconds:.3f} s ({sum(counts[k] for k in TILE_KERNELS)} tile launches,"
        f" {fact.numeric_seconds * 1e6 / max(1, sum(counts[k] for k in TILE_KERNELS)):.1f} us"
        f" each); reckoned from the pattern in {reckon_s:.3f} s: launches {json.dumps(want)}, "
        f"tiles solved and products {json.dumps(solved)}")
    check_launches(tag, counts, TILE_KERNELS,
                   idle=("spmv_ell", "factor_wavefront", "tri_solve_wavefront", "inverse_chain"))
    for name in TILE_KERNELS:
        require(counts[name] == want[name], f"{tag}: {name} launched {counts[name]} times, "
                f"the tile pattern asks for {want[name]}")
    require(bool(torch.isfinite(fact.tiles).all()), f"{tag}: non-finite tiles")
    t0 = time.perf_counter()
    resid = tile_lu_residual(fact, a, triples, dev)
    limit = 1e-4 * float(np.abs(a.data).max())
    say(f"[{tag}] tile-wise LU residual over {len(fact.tile_index)} kept tiles "
        f"({triples.shape[0]} tile products, float64 on the card, "
        f"{time.perf_counter() - t0:.3f} s): max |(LU)_IJ - A_IJ| = {resid:.3e} "
        f"(limit 1e-4*max|A| = {limit:.1e})")
    require(resid <= limit, f"{tag}: tile-wise LU residual {resid:.3e} > {limit:.1e}")
    pat = pilu1_symbolic(a)
    prow = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(pat.indptr))
    keys = set(fact.tile_index)
    tiles_hit = set(zip((prow // bs).tolist(), (pat.indices // bs).tolist()))
    require(tiles_hit <= keys, f"{tag}: a scalar ILU(1) position lies outside the kept tiles")
    say(f"[{tag}] all {pat.nnz} scalar ILU(1) positions lie in kept tiles "
        f"({len(tiles_hit)} of the {len(keys)})")
    t0 = time.perf_counter()
    per_tile = per_tile_pool(a, fact, dev)
    per_tile_s = time.perf_counter() - t0
    require(torch.equal(fact.tiles.view(torch.int32), per_tile.view(torch.int32)),
            f"{tag}: the pool differs from the per-tile order's")
    say(f"[{tag}] pool bitwise equal to the per-tile order through the single-tile kernels "
        f"({solved['trsm_left_unit_lower'] + solved['trsm_right_upper']} single solves, "
        f"{per_tile_s:.3f} s with its scatter)")
    del per_tile
    busy = profile_bilu(tag, a, bs, dev)
    say(f"[{tag}] panel_update: {counts['panel_update']} grouped launches for "
        f"{solved['panel_update']} tile products ({fact.numeric_seconds:.3f} s numeric, "
        f"{sum(counts[k] for k in TILE_KERNELS)} tile launches, device busy {busy:.1f}% in "
        "the profiled run)")
    return counts


def profile_bilu(tag, a, bs, dev):
    """Where the numeric phase's time goes: the same factorization again
    under torch.profiler; device busy = the sum of kernel durations.
    Returns the busy share of the numeric wall, in percent."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.bilu import bilu

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fact = bilu(a, 1, bs=bs, device=dev)
    events = kernel_events(prof)
    busy = sum(us for _, us in events) / 1e6
    by_name = {}
    for name, us in events:
        key = name.split("(")[0][:60]
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, t + us / 1e6)
    say(f"[profile {tag}] numeric phase under torch.profiler: wall {fact.numeric_seconds:.3f} s,"
        f" {len(events)} kernels, device busy {busy:.3f} s "
        f"({100 * busy / fact.numeric_seconds:.1f}% of the numeric wall)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        say(f"[profile {tag}]   {t:.4f} s in {n} launches of {name}")
    return 100 * busy / fact.numeric_seconds


def phase_bilu_card_vs_cpu(dev, nx=64, bs=32):
    import numpy as np

    from repro_torch.core.bilu import bilu
    from repro_torch.core.matgen import poisson_2d

    a = poisson_2d(nx)
    gpu = bilu(a, 1, bs=bs, device=dev)
    t0 = time.perf_counter()
    cpu = bilu(a, 1, bs=bs, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(gpu.tile_index == cpu.tile_index, "bilu tile index: card != CPU")
    diff = float((gpu.tiles.cpu() - cpu.tiles).abs().max())
    limit = 1e-4 * float(np.abs(a.data).max())
    say(f"[card-vs-cpu] poisson_2d({nx}) BILU(1) bs={bs}: {len(cpu.tile_index)} tiles, max "
        f"|card - CPU| {diff:.3e} (limit {limit:.1e}; the panel products sum in another order)"
        f"; numeric {gpu.numeric_seconds:.3f} s on the card, {cpu.numeric_seconds:.3f} s "
        f"on the CPU ({cpu_s:.3f} s with the plan)")
    require(diff <= limit, f"bilu tiles: card - CPU {diff:.3e} > {limit:.1e}")


def phase_cg(dev, b):
    """Path D: CG through the ILU(1) sweep preconditioner."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_with_ilu
    from repro_torch.kernels import ops

    a = poisson_2d(400)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_with_ilu(a, b, k=1, method="cg", tol=TOL, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    true_rel = true_residual(a, b, res.x)
    say(f"[cg] poisson_2d(400) ILU(1) CG tol={TOL}: verdict={res.verdict} "
        f"iterations={res.iterations} residual={res.residual:.3e} "
        f"float64 true residual={true_rel:.3e}")
    say(f"[cg] wall {wall:.3f} s = factor {factor_s:.3f} s + solve {wall - factor_s:.3f} s "
        f"(ELL, sweep plan, CG; {(wall - factor_s) * 1e3 / max(1, res.iterations):.2f} ms "
        "per iteration)")
    check_launches("cg", counts, ("spmv_ell", "factor_wavefront", "tri_solve_wavefront"),
                   idle=("inverse_chain",) + TILE_KERNELS)
    require(res.verdict == "converged", f"cg verdict {res.verdict}")
    require(np.isfinite(res.x).all() and res.x.shape == (a.n,), "cg x malformed")
    again, _ = solve_with_ilu(a, b, k=1, method="cg", tol=CG_TOL, device=dev)  # cached factor
    true_again = true_residual(a, b, again.x)
    say(f"[cg] tol={CG_TOL}: verdict={again.verdict} iterations={again.iterations} "
        f"residual={again.residual:.3e} float64 true residual={true_again:.3e}")
    require(again.verdict == "converged", f"cg verdict {again.verdict} at tol {CG_TOL}")
    require(true_again <= 2 * CG_TOL, f"cg float64 true residual {true_again:.3e} > 2*tol")
    small = small_matrix("poisson_2d(64)")
    rhs = np.random.default_rng(SEED + 2).standard_normal(small.n).astype(np.float32)
    gpu, _ = solve_with_ilu(small, rhs, k=1, method="cg", tol=TOL, device=dev)
    cpu, _ = solve_with_ilu(small, rhs, k=1, method="cg", tol=TOL, device="cpu")
    same = np.array_equal(gpu.x.view(np.int32), cpu.x.view(np.int32))
    say(f"[card-vs-cpu] poisson_2d(64) cg: {gpu.iterations} (card) vs {cpu.iterations} (cpu) "
        f"iterations, verdict {gpu.verdict}/{cpu.verdict}, x bitwise equal: {same}")
    require(same and (gpu.iterations, gpu.verdict) == (cpu.iterations, cpu.verdict),
            "card cg != CPU cg on poisson_2d(64)")
    return counts


def phase_topilu(dev, main_fact, nx=400):
    """[topilu]: the band-superstep factorization of poisson_2d(nx), ILU(1),
    over SHARDED_D band owners on the card: host plan, numeric wall,
    supersteps, launches and exchanges; its values bitwise equal to the
    card's factor_wavefront factors of the main path."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.top_ilu import ENGINE_CACHE_KEY, BandGroup
    from repro_torch.kernels import ops

    a = poisson_2d(nx)
    group = BandGroup(SHARDED_D, dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fact = ilu_sharded(a, 1, band_rows=BAND_ROWS, group=group)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    plan = fact.plan
    plan_s = next(iter(a.__dict__[ENGINE_CACHE_KEY].values()))["plan_seconds"]
    say(f"[topilu] poisson_2d({nx}) n={a.n} ILU(1) over {SHARDED_D} band owners of "
        f"{BAND_ROWS}-row bands: {plan.n_bands} bands, {plan.n_supersteps} supersteps "
        f"(<= {plan.bands_per_superstep} bands per owner each), halo {plan.halo_size} rows, "
        f"E={plan.egress_max} W={plan.width} MP={plan.max_piv}")
    say(f"[topilu] wall {wall:.3f} s = symbolic {fact.symbolic_seconds:.3f} s + host plan "
        f"{plan_s:.3f} s + numeric and audit {fact.numeric_seconds - plan_s:.3f} s; "
        f"{counts['superstep_factor']} superstep_factor launches, {group.exchanges} exchanges "
        f"({group.payload_bytes / 1e6:.2f} MB sent per owner)")
    require(counts["superstep_factor"] == 1,
            f"topilu launched superstep_factor {counts['superstep_factor']} times for one "
            "factorization")
    require(group.exchanges == plan.n_supersteps,
            "topilu: the group did not record one exchange per superstep")
    require(np.array_equal(fact.values_csr().view(np.int32), main_fact.vals.view(np.int32)),
            "TOP-ILU values != the main path's factor_wavefront values")
    group.reset_counts()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = ilu_sharded(a, 1, band_rows=BAND_ROWS, group=group)  # the engine is cached
    torch.cuda.synchronize()
    require(ops.launch_counts()["superstep_factor"] == 1
            and group.exchanges == plan.n_supersteps,
            "topilu refactorization: not one launch, or not the plan's exchanges")
    say(f"[topilu] values bitwise equal to the main path's factor_wavefront factors; a "
        f"refactorization with the cached plan takes {time.perf_counter() - t0:.3f} s "
        f"(numeric and audit {again.numeric_seconds:.3f} s)")
    return fact, group


def checked_superstep(state, sched, s, *rest):
    """One superstep through the kernel, held bitwise against the plain
    version on the same input state."""
    from repro_torch.kernels import ops, ref

    want = ref.superstep_factor_ref(state, sched, s, *rest)
    ops.superstep_factor(state, sched, s, *rest)
    require(bits_equal(state, want), f"superstep_factor kernel != plain version at superstep {s}")
    return state


def epoch_bound(sched, lo, hi, nb, with_diag):
    """Bytes and operations of one epoch_sweep launch over levels [lo, hi)
    of ``sched`` for nb right-hand sides, counting what this epoch's data
    needs: every lane's column index, the values of the unmasked lanes only
    (the kernel loads no other), each gathered x slot once per owner and
    right-hand side, the rhs (and diag) of every row and every slot's
    write, pad rows included; a rounded product and add per unmasked lane
    and a subtract (and divide) per row."""
    import numpy as np

    c = np.asarray(sched.cols_local[:, lo:hi])  # (D, levels, maxr, W)
    mask = c < sched.scratch
    lanes = int(mask.sum())
    gathered = sum(np.unique(c[d][mask[d]]).size for d in range(c.shape[0]))
    rows = c.shape[0] * c.shape[1] * c.shape[2]
    nbytes = 4 * c.size + 4 * lanes + 4 * nb * gathered + 8 * nb * rows
    nops = nb * (2 * lanes + rows)
    if with_diag:
        nbytes += 4 * rows
        nops += nb * rows
    return nbytes, nops


def phase_distributed_kernels(dev, fact, nx_small=64):
    """[kernels] rows of the distributed path: ``epoch_sweep``'s one-epoch
    form held bitwise against its plain version over every epoch of both
    sweeps at the full-size tables of ``fact`` (single and nb=NB right-hand
    sides), and ``superstep_factor`` over every superstep at
    poisson_2d(nx_small) for D = 1, 2, 4 and both broadcasts; the persistent
    factorization against the plain per-superstep loop at
    poisson_2d(PLAIN_LOOP_NX) and against the per-superstep kernel loop at
    full size, and its time there (epoch_sweep's row is [sharded-sweep]'s,
    the form the path runs)."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.numeric import make_superstep_factorizer, plan_state_array
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.planner import make_plan
    from repro_torch.core.symbolic import pilu1_symbolic
    from repro_torch.core.top_ilu import BandGroup, _values_to_csr_order
    from repro_torch.kernels import build, ops, ref

    rng = np.random.default_rng(SEED + 6)
    apply = fact.precond()
    tp, tables = apply.plan, apply.sweep.tables
    sides = (("L", tp.l_sched, tables.l.cols, apply._lv, None),
             ("U", tp.u_sched, tables.u.cols, apply._uv, apply._dg))
    t0 = time.perf_counter()
    for nb in (1, NB):
        for side, sched, cols, vals, diag in sides:
            D, nlev, maxr, _ = cols.shape
            x0 = torch.as_tensor(rng.standard_normal((D, nb, sched.scratch + 1))
                                 .astype(np.float32), device=dev)
            rhs = torch.as_tensor(rng.standard_normal((D, nb, nlev, maxr)).astype(np.float32),
                                  device=dev)
            xk, xp = x0.clone(), x0
            bounds = [int(v) for v in sched.epoch_bounds]
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                ops.epoch_sweep(xk, cols, vals, rhs, diag, lo, hi, sched.scratch)
                xp = ref.epoch_sweep_ref(xp, cols, vals, rhs, diag, lo, hi, sched.scratch)
            require(bits_equal(xk, xp), f"epoch_sweep ({side}, nb={nb}) kernel != plain version "
                    "over the full-size epochs")
    say(f"[kernels] epoch_sweep, the one-epoch form: every epoch of the L "
        f"({tp.l_sched.n_epochs}) and U ({tp.u_sched.n_epochs}) sweeps of the n={tp.n} plan "
        f"over {tp.n_devices} owners, single and nb={NB}, bitwise equal to epoch_sweep_ref on "
        f"the card ({time.perf_counter() - t0:.1f} s)")

    a = poisson_2d(nx_small)
    pattern = pilu1_symbolic(a)
    want = numeric_ilu_ref(a, pattern)
    for d in (1, 2, 4):
        for bc in ("gather", "ring"):
            plan = make_plan(a, pattern, BAND_ROWS, d)
            fac = make_superstep_factorizer(plan, BandGroup(d, dev), broadcast=bc)
            loc = fac(plan_state_array(plan, a), step=checked_superstep)
            dm = loc.cpu().numpy().reshape(plan.n_pad, plan.width)
            got = _values_to_csr_order(plan, pattern, plan.rows_from_device_major(dm))
            require(np.array_equal(got.view(np.int32), want.view(np.int32)),
                    f"superstep factorization of poisson_2d({nx_small}) D={d} {bc} != oracle")
            say(f"[kernels] superstep_factor: poisson_2d({nx_small}) D={d} {bc}: each of "
                f"{plan.n_supersteps} supersteps bitwise equal to plain, the factor to "
                "numeric_ilu_ref")

    # the whole factorization against the plain per-superstep loop
    # (ref.superstep_factor_ref per superstep, each exchange through
    # BandGroup.exchange) on the same state, at poisson_2d(PLAIN_LOOP_NX):
    # the plain loop takes minutes at full size; there the persistent
    # launch is held against the per-superstep kernel loop (the rank route)
    def plain_step(st, *args):
        st.copy_(ref.superstep_factor_ref(st, *args))

    D = fact.n_devices
    a_pl = poisson_2d(PLAIN_LOOP_NX)
    f_pl = ilu_sharded(a_pl, 1, band_rows=BAND_ROWS, group=BandGroup(D, dev))
    fac_pl = make_superstep_factorizer(f_pl.plan, f_pl.group)
    st_pl = torch.as_tensor(plan_state_array(f_pl.plan, a_pl), device=dev)
    got_pl = fac_pl(st_pl.clone())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want_pl = fac_pl(st_pl.clone(), group=BandGroup(D, dev), step=plain_step)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    require(bits_equal(got_pl, want_pl), "superstep_factor persistent kernel != the plain "
            f"per-superstep loop at poisson_2d({PLAIN_LOOP_NX})")
    pl_ms = time_ms(lambda: fac_pl(st_pl.clone()), reps=20)
    plan = fact.plan
    fac = make_superstep_factorizer(plan, fact.group)
    st0 = torch.as_tensor(plan_state_array(plan, fact.a), device=dev)
    ops.reset_launch_counts()
    got = fac(st0.clone())
    require(ops.launch_counts()["superstep_factor"] == 1,
            "the persistent superstep factorization is not one launch")
    require(bool(torch.isfinite(got).all()), "superstep_factor at full size: non-finite values")
    want = fac(st0.clone(), group=BandGroup(D, dev), step=ops.superstep_factor)
    require(bits_equal(got, want), "superstep_factor persistent kernel != the per-superstep "
            "kernel loop at full size")
    host = factor_tables(plan)
    nbytes, nops = factor_bound(plan, host)
    b_ms, b_by = bound(nbytes, nops)
    lib = build.load()
    flags = torch.zeros(D, dtype=torch.int32, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    chain = in_band_chain(plan, host)

    def floor():
        err = lib.superstep_factor_chain_floor_launch(D, plan.n_supersteps, chain,
                                                      flags.data_ptr(), sink.data_ptr(),
                                                      torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the factor's chain floor kernel did not launch (CUDA error {err})")

    n_sup = plan.n_supersteps
    row = dict(
        name="superstep_factor", route="cuda",
        source="src/repro_torch/kernels/csrc/superstep_factor.cu",
        replaces="src/repro/core/numeric_jax.py:122", launches=0,
        max_abs_err=max_abs_err(got_pl, want_pl),
        ms=time_ms(lambda: fac(st0.clone()), reps=20),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, port_only=True,
        note="no TPU kernel: the JAX package runs the superstep body as plain JAX; a whole "
             "factorization per call (state copy included); plain_ms, max_abs_err and "
             f"plain_size_ms at poisson_2d({PLAIN_LOOP_NX}), the plain version the per-superstep "
             "loop; at full size held against the per-superstep kernel loop",
        plain_size=f"poisson_2d({PLAIN_LOOP_NX})", plain_size_ms=pl_ms,
        plain_size_supersteps=f_pl.plan.n_supersteps,
        supersteps=n_sup, n_owners=D, chain_steps=n_sup,
        device_ms=device_ms(lambda: fac(st0.clone()), "superstep_factor_persistent_kernel",
                            reps=10),
        per_superstep_route_ms=time_ms(
            lambda: fac(st0.clone(), group=BandGroup(D, dev), step=ops.superstep_factor),
            reps=3),
        chain_floor_ms=device_ms(floor, "superstep_factor_chain_floor_kernel", reps=5),
        in_band_chain=chain, staged=bool(fac.kernel.staged), ring_bytes=fac.kernel.smem_bytes)
    row["us_per_step"] = row["ms"] * 1e3 / n_sup
    dms = "not measured" if row["device_ms"] is None else f"{row['device_ms']:.4f} ms"
    floor_ms = row["chain_floor_ms"]
    say(f"[kernels] superstep_factor at poisson_2d({PLAIN_LOOP_NX}) (n={a_pl.n}, "
        f"{f_pl.plan.n_supersteps} supersteps): the persistent launch bitwise equal to the "
        f"plain per-superstep loop, {pl_ms:.4f} ms per call against the plain loop's "
        f"{plain_ms:.1f} ms")
    say(f"[kernels] superstep_factor, one persistent launch per factorization: n={plan.n} "
        f"D={D}, {n_sup} supersteps, bitwise equal to the per-superstep kernel loop; "
        f"{row['ms']:.4f} ms per call (device {dms}"
        + ("" if row["device_ms"] is None
           else f", {row['device_ms'] * 1e3 / n_sup:.3f} us per superstep")
        + f"; per-superstep route "
        f"{row['per_superstep_route_ms']:.1f} ms; bound {b_ms:.5f} ms by {b_by}; no library "
        f"call); chain floor ({chain} in-band pivots a superstep, a wait and a release) "
        + ("not measured" if floor_ms is None
           else f"{floor_ms:.4f} ms = {floor_ms * 1e3 / n_sup:.3f} us per superstep")
        + f"; staged {row['staged']} ({row['ring_bytes']} B of ring); the design before: "
        f"{PREVIOUS_SUPERSTEP['ms']} ms per call and {PREVIOUS_SUPERSTEP['device_ms']} ms of "
        f"device per superstep, {PREVIOUS_SUPERSTEP['launches']:,} launches per factorization "
        "(an NVIDIA H100 80GB HBM3 at 700 W)")
    return {"superstep_factor": row}


def factor_tables(plan):
    """The derived tables of ``plan``'s band-superstep factorization, as the
    persistent launch's host check derives them (``ops._superstep_tables``)."""
    from repro_torch.core.numeric import plan_device_arrays
    from repro_torch.kernels import ops

    arr = plan_device_arrays(plan, keys=ops.SuperstepFactor.FIELDS + ("egress", "ingress"))
    return ops._superstep_tables(*arr.values(), plan.n_bands, plan.band_rows, plan.halo_size)


def in_band_chain(plan, host):
    """The longest chain of in-band pivots of one band: valid pivots whose
    row lies in the band (phase 2 of the persistent kernel)."""
    import numpy as np

    piv = host["pivots"]
    band = piv["owner"] * (plan.s_loc // plan.band_rows) + piv["row"] // plan.band_rows
    return int(np.bincount(band[piv["in_band"]], minlength=1).max())


def factor_bound(plan, host):
    """Bytes and operations of one whole band-superstep factorization,
    counting what this plan's data needs: the schedule; each scheduled
    band's rows read and written and its n_piv; piv_addr, piv_dlane and the
    W-lane piv_dst of each valid pivot only (p < n_piv: the kernel reads no
    other); each out-of-band pivot row read once per superstep that reads
    it; each halo row written once. An exchange names each row it ships by
    the sender's row and the receiver's address, so a pushed row costs its
    W values and two int32 indices; the padding entries of the egress and
    ingress tables ship nothing and are not counted, nor are the wait
    counts the persistent launch derives to order its waits (the plain
    exchange needs none). A divide per valid pivot and a rounded update per
    kept lane."""
    import numpy as np

    R, W, D = plan.band_rows, plan.width, plan.n_devices
    piv = host["pivots"]
    n_valid = piv["addr"].size
    nops = n_valid + 2 * piv["kept"]
    out = ~piv["in_band"] & (piv["step"] < plan.n_supersteps)
    key = ((piv["step"][out] * D + piv["owner"][out]) * plan.state_rows
           + piv["addr"][out])
    pulled = np.unique(key).size
    pushes = int(host["push_off"][-1])
    nbytes = (plan.superstep_bands.size * 4
              + host["n_scheduled"] * (2 * R * W * 4 + R * 4) + n_valid * (2 + W) * 4
              + pulled * W * 4 + pushes * (W * 4 + 8))
    return nbytes, nops


def apply_bound(tp, nb):
    """Bytes and operations of one band-partitioned apply for nb right-hand
    sides: every level of both sweeps as :func:`epoch_bound` counts them,
    each entry an owner pulls from another read and written once, b read
    and x written once."""
    nbytes_l, ops_l = epoch_bound(tp.l_sched, 0, tp.nl_levels, nb, False)
    nbytes_u, ops_u = epoch_bound(tp.u_sched, 0, tp.nu_levels, nb, True)
    pulled = sum(int((ing < sched.scratch).sum()) for sched in (tp.l_sched, tp.u_sched)
                 for ing in sched.ingress if ing is not None)
    return nbytes_l + nbytes_u + 8 * nb * pulled + 8 * nb * tp.n, ops_l + ops_u


def phase_sharded_sweep(dev, main_fact, sizes=(64, 400)):
    """[sharded-sweep]: the band-partitioned apply as one persistent launch
    of epoch_sweep's kernel (every epoch and exchange of the L and U
    sweeps), bitwise against its plain version (ref.sharded_sweep_ref on
    the card, whose exchanges go through BandGroup.exchange) and against
    the single-device PrecondApply, at nb = 1 and NB, for "gather" and
    "ring", at D = 1, 2, 3, 4 on poisson_2d(64) and D = SHARDED_D on
    poisson_2d(400); the group
    counts what the plain version's exchanges count. At full size and D =
    SHARDED_D: the time per apply, its bound and the chain floor per epoch
    (one dependent L2 load, a barrier, a release and an acquire of every
    other owner's count per epoch). Returns epoch_sweep's kernels row."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu, ilu_sharded
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.top_ilu import BandGroup
    from repro_torch.kernels import build, ops, ref

    rng = np.random.default_rng(SEED + 10)
    for nx in sizes:
        a = main_fact.a if nx == 400 else poisson_2d(nx)
        single = (main_fact if nx == 400 else ilu(a, 1, device=dev)).precond()
        bs = torch.as_tensor(rng.standard_normal((NB, a.n)).astype(np.float32), device=dev)
        t0 = time.perf_counter()
        owners = (1, 2, 3, 4) if nx < 400 else (SHARDED_D,)  # full size: the path's owners
        for d in owners:
            for bc in ("gather", "ring"):
                group = BandGroup(d, dev)
                apply = ilu_sharded(a, 1, band_rows=BAND_ROWS, group=group, broadcast=bc).precond()
                for nb in (1, NB):
                    b = bs[:nb]
                    group.reset_counts()
                    ops.reset_launch_counts()
                    got = apply.batched(b)
                    launches = ops.launch_counts()["epoch_sweep"]
                    plain_group = BandGroup(d, dev)
                    want = ref.sharded_sweep_ref(apply.sweep.tables, apply._lv, apply._uv,
                                                 apply._dg, b, plain_group, bc)
                    tag = f"poisson_2d({nx}) D={d} {bc} nb={nb}"
                    require(launches == 1, f"[sharded-sweep] {tag}: {launches} launches")
                    require(bits_equal(got, want), f"[sharded-sweep] {tag}: kernel != plain")
                    require(bits_equal(got, single.batched(b)),
                            f"[sharded-sweep] {tag}: != the single-device PrecondApply")
                    require(group.counts() == plain_group.counts(),
                            f"[sharded-sweep] {tag}: counts {group.counts()} != the plain "
                            f"version's {plain_group.counts()}")
        say(f"[sharded-sweep] poisson_2d({nx}): D = {', '.join(map(str, owners))} x gather, "
            f"ring x nb = 1, {NB}: "
            "one launch per apply, bitwise equal to the plain whole sweep and to PrecondApply, "
            f"the same exchange counts ({time.perf_counter() - t0:.1f} s)")

    group = BandGroup(SHARDED_D, dev)
    f = ilu_sharded(main_fact.a, 1, band_rows=BAND_ROWS, group=group)
    apply = f.precond()
    tp = apply.plan
    b = torch.as_tensor(rng.standard_normal((1, tp.n)).astype(np.float32), device=dev)
    n_ep = tp.l_sched.n_epochs + tp.u_sched.n_epochs
    got = apply.batched(b)
    plain_group = BandGroup(SHARDED_D, dev)
    want = ref.sharded_sweep_ref(apply.sweep.tables, apply._lv, apply._uv, apply._dg, b,
                                 plain_group, "gather")
    b_ms, b_by = bound(*apply_bound(tp, 1))
    lib = build.load()
    zeros = torch.zeros(2, dtype=torch.float32, device=dev)
    flags = torch.zeros(SHARDED_D, dtype=torch.int32, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    threads = min(1024, max(32, -(-max(tp.maxr_l, tp.maxr_u) // 32) * 32))

    def sweep_floor():
        err = lib.epoch_sweep_chain_floor_launch(SHARDED_D, n_ep, threads, zeros.data_ptr(),
                                                 flags.data_ptr(), sink.data_ptr(),
                                                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the sweep's chain floor kernel did not launch (CUDA error {err})")

    floor_ms = device_ms(sweep_floor, "epoch_sweep_chain_floor_kernel", reps=5)
    row = dict(
        name="epoch_sweep", route="cuda", source="src/repro_torch/kernels/csrc/epoch_sweep.cu",
        replaces="src/repro/kernels/tri_sweep_epoch.py:49", launches=0,
        max_abs_err=max_abs_err(got, want), ms=time_ms(lambda: apply.batched(b), reps=20),
        plain_ms=time_ms(lambda: ref.sharded_sweep_ref(apply.sweep.tables, apply._lv, apply._uv,
                                                       apply._dg, b, BandGroup(SHARDED_D, dev),
                                                       "gather"), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, launches_per_apply=1, epochs=n_ep,
        exchanges=tp.sweep_collectives_per_apply(), chain_steps=n_ep,
        device_ms=device_ms(lambda: apply.batched(b), "epoch_sweep_kernel", reps=10),
        chain_floor_ms=floor_ms,
        us_per_epoch_floor=None if floor_ms is None else floor_ms * 1e3 / n_ep)
    row["us_per_step"] = row["ms"] * 1e3 / n_ep
    row["library"] = "torch.triangular_solve on sparse CSR L (unit) then U, two calls"
    library_pair(row, apply.batched, triangular_library(main_fact.pattern, main_fact.vals, dev),
                 b, 10)
    dms = "not measured" if row["device_ms"] is None else f"{row['device_ms']:.4f} ms"
    say(f"[sharded-sweep] poisson_2d(400) D={SHARDED_D}: one launch per apply for {n_ep} epochs "
        f"and {row['exchanges']} exchanges: {row['ms']:.4f} ms per apply (device {dms}, "
        f"{row['us_per_step']:.3f} us per epoch; plain whole sweep {row['plain_ms']:.1f} ms, "
        f"bound {b_ms:.5f} ms by {b_by}); chain floor "
        + ("not measured" if floor_ms is None else
           f"{floor_ms:.4f} ms = {row['us_per_epoch_floor']:.3f} us per epoch")
        + f"; the design before took {PREVIOUS_SHARDED_APPLY_MS} ms per apply (an NVIDIA H100 "
        "80GB HBM3 at 700 W)")
    return {"epoch_sweep": row}


def phase_sharded_apply(dev, main_fact, fact4, nx=400):
    """[sharded-apply]: the band-partitioned apply at D = 1 and D =
    SHARDED_D, single and nb=NB, bitwise equal to the main path's
    PrecondApply; exactly one epoch_sweep launch per apply (every epoch and
    exchange in it) and the plan's exchanges counted in the group; the time
    per apply."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu_sharded
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED + 7)
    want = main_fact.precond()
    fact1 = ilu_sharded(main_fact.a, 1, band_rows=BAND_ROWS, n_devices=1, device=dev)
    b = torch.as_tensor(rng.standard_normal(main_fact.a.n).astype(np.float32), device=dev)
    bs = torch.as_tensor(rng.standard_normal((NB, main_fact.a.n)).astype(np.float32), device=dev)
    ref_ms = time_ms(lambda: want(b), reps=10)
    for f in (fact1, fact4):
        apply = f.precond()
        tp = apply.plan
        n_ep = tp.l_sched.n_epochs + tp.u_sched.n_epochs
        f.group.reset_counts()
        ops.reset_launch_counts()
        got = apply(b)
        counts = ops.launch_counts()
        tag = f"sharded-apply D={f.n_devices}"
        check_launches(tag, counts, ("epoch_sweep",),
                       idle=("tri_solve_wavefront", "spmv_ell", "inverse_chain"))
        require(counts["epoch_sweep"] == 1, f"{tag}: {counts['epoch_sweep']} epoch_sweep "
                f"launches for one apply of {n_ep} epochs")
        require(f.group.collectives == tp.sweep_collectives_per_apply("gather"),
                f"{tag}: {f.group.collectives} exchanges, the plan models "
                f"{tp.sweep_collectives_per_apply('gather')}")
        require(bits_equal(got, want(b)), f"{tag} != the single-device PrecondApply")
        got_b = apply.batched(bs)
        require(bits_equal(got_b, want.batched(bs)), f"{tag} nb={NB} != PrecondApply nb={NB}")
        reps = 10
        ms = time_ms(lambda: apply(b), reps=reps)
        ms_b = time_ms(lambda: apply.batched(bs), reps=reps)
        say(f"[{tag}] {tp.nl_levels}+{tp.nu_levels} levels in {tp.l_sched.n_epochs}+"
            f"{tp.u_sched.n_epochs} epochs, {tp.sweep_collectives_per_apply()} exchanges and "
            f"{tp.sweep_payload_slots()} payload slots per apply (comm_summary "
            f"{json.dumps(tp.comm_summary())}); single and nb={NB} bitwise equal to "
            f"PrecondApply; one launch per apply; {ms:.3f} ms per apply, nb={NB} {ms_b:.3f} ms "
            f"(tri_solve_wavefront {ref_ms:.3f} ms)"
            + (f"; the design before took {PREVIOUS_SHARDED_APPLY_MS} ms per apply at D=4 "
               "(an NVIDIA H100 80GB HBM3 at 700 W)" if f.n_devices == 4 else ""))
    return fact1


def phase_distributed(dev, b, single, nx=400):
    """Path E: solve_sharded on poisson_2d(nx), ILU(1) over SHARDED_D band
    owners, GMRES(30), tol TOL: steps, restarts and x bitwise equal to the
    main path's single-device solve; wall split into factor and solve; one
    profiled restart."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded
    from repro_torch.kernels import ops

    a = poisson_2d(nx)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_sharded(a, b, k=1, n_devices=SHARDED_D, band_rows=BAND_ROWS,
                              broadcast="gather", tol=TOL, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    true_rel = true_residual(a, b, res.x)
    tp = fact.precond().plan
    say(f"[distributed] poisson_2d({nx}) n={a.n} ILU(1) over {SHARDED_D} band owners, "
        f"GMRES(30) tol={TOL}: verdict={res.verdict} inner steps={res.iterations} restarts="
        f"{len(res.history)} residual={res.residual:.3e} float64 true residual={true_rel:.3e}")
    say(f"[distributed] wall {wall:.3f} s = factor {factor_s:.3f} s (symbolic "
        f"{fact.symbolic_seconds:.3f} s, plan + supersteps + audit {fact.numeric_seconds:.3f} s)"
        f" + solve {wall - factor_s:.3f} s (row-block ELL, sweep plan + extract, GMRES; one "
        f"epoch_sweep launch per apply for {tp.l_sched.n_epochs + tp.u_sched.n_epochs} epochs "
        f"and {tp.sweep_collectives_per_apply()} exchanges)")
    check_launches("distributed", counts, ("epoch_sweep", "superstep_factor", "spmv_ell"),
                   idle=("factor_wavefront", "tri_solve_wavefront", "inverse_chain"))
    require(counts["superstep_factor"] == 1,
            f"distributed: {counts['superstep_factor']} superstep_factor launches for one "
            "factorization")
    require(res.verdict == single.verdict and res.iterations == single.iterations
            and len(res.history) == len(single.history),
            f"distributed solve ({res.verdict}, {res.iterations} steps) != main "
            f"({single.verdict}, {single.iterations} steps)")
    require(np.array_equal(res.x.view(np.int32), single.x.view(np.int32)),
            "distributed x != the main path's x")
    say("[distributed] steps, restarts, verdict and x bitwise equal to [main]")
    profile_resolve("distributed", a, b, dev, solve=solve_sharded, activities=("cuda",),
                    tol=TOL, n_devices=SHARDED_D, band_rows=BAND_ROWS)
    return counts, res


def phase_distributed_inverse(dev, b, single, nx=400):
    """solve_sharded with precond_method="inverse" at tol INV_TOL: x
    bitwise equal to [main-inverse]."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded
    from repro_torch.kernels import ops

    a = poisson_2d(nx)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_sharded(a, b, k=1, n_devices=SHARDED_D, band_rows=BAND_ROWS,
                              tol=INV_TOL, precond_method="inverse", device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    say(f"[distributed-inverse] poisson_2d({nx}) over {SHARDED_D} owners, inverse GMRES(30) "
        f"tol={INV_TOL}: verdict={res.verdict} inner steps={res.iterations} restarts="
        f"{len(res.history)}; wall {wall:.3f} s = factor {factor_s:.3f} s + solve "
        f"{wall - factor_s:.3f} s (inverse plan and values, two exchanges per apply); "
        f"'auto' resolves to {fact.resolve_method('auto')!r}")
    check_launches("distributed-inverse", counts, ("superstep_factor", "spmv_ell"),
                   idle=("epoch_sweep", "factor_wavefront", "tri_solve_wavefront",
                         "inverse_chain"))
    require(counts["superstep_factor"] == 1,
            f"distributed-inverse: {counts['superstep_factor']} superstep_factor launches for "
            "one factorization")
    require((res.verdict, res.iterations) == (single.verdict, single.iterations)
            and np.array_equal(res.x.view(np.int32), single.x.view(np.int32)),
            "distributed inverse solve != [main-inverse]")
    say("[distributed-inverse] steps, verdict and x bitwise equal to [main-inverse]")
    return counts


def phase_sharded_card_vs_cpu(dev, nx=32):
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded

    a = poisson_2d(nx)
    b = np.random.default_rng(SEED + 2).standard_normal(a.n).astype(np.float32)
    cpu, _ = solve_sharded(a, b, k=1, n_devices=2, band_rows=BAND_ROWS, tol=TOL, device="cpu")
    for bc in ("gather", "ring"):
        gpu, _ = solve_sharded(a, b, k=1, n_devices=2, band_rows=BAND_ROWS, broadcast=bc,
                               tol=TOL, device=dev)
        same = np.array_equal(gpu.x.view(np.int32), cpu.x.view(np.int32))
        say(f"[card-vs-cpu] poisson_2d({nx}) solve_sharded D=2 {bc}: {gpu.iterations} (card) vs "
            f"{cpu.iterations} (cpu) steps, verdict {gpu.verdict}/{cpu.verdict}, x bitwise "
            f"equal: {same}")
        require(same and (gpu.iterations, gpu.verdict) == (cpu.iterations, cpu.verdict),
                f"card sharded solve ({bc}) != CPU sharded solve on poisson_2d({nx})")


def ordering_models(a):
    """[ordering]'s comm models, on the host: for the natural, fusion (D =
    SHARDED_D, BAND_ROWS) and RCM orderings of ``a``, the symbolic ILU(1)
    of the permuted matrix, ``sweep_comm_model`` and ``factor_comm_model``,
    and their seconds."""
    from repro_torch.core.api import _symbolic
    from repro_torch.core.ordering import (
        factor_comm_model,
        make_ordering,
        permuted_system,
        sweep_comm_model,
    )

    out = {}
    for spec in ORDERING_EXPECTED:
        t0 = time.perf_counter()
        o = make_ordering(a, spec, n_devices=SHARDED_D, band_rows=BAND_ROWS)
        ap = a if o is None else permuted_system(a, o)
        pattern = _symbolic(ap, 1, "sum")
        out[spec] = dict(sweep=sweep_comm_model(pattern, BAND_ROWS, SHARDED_D),
                         factor=factor_comm_model(ap, pattern, BAND_ROWS, SHARDED_D),
                         seconds=time.perf_counter() - t0)
    return out


def phase_ordering(nx=400):
    """[ordering]: the fusion ordering of poisson_2d(nx) for SHARDED_D owners
    of BAND_ROWS-row bands and the RCM ordering, built on the host (their
    seconds); the comm models of the natural, fusion and RCM orderings,
    which must reproduce ORDERING_EXPECTED. Returns the fusion Ordering."""
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.ordering import fusion_aware_ordering, rcm_ordering

    a = poisson_2d(nx)
    t0 = time.perf_counter()
    o4 = fusion_aware_ordering(a, SHARDED_D, band_rows=BAND_ROWS)
    t1 = time.perf_counter()
    rcm = rcm_ordering(a)
    t2 = time.perf_counter()
    say(f"[ordering] poisson_2d({nx}) n={a.n}: fusion_aware_ordering(D={SHARDED_D}, "
        f"band_rows={BAND_ROWS}) {t1 - t0:.3f} s, rcm_ordering {t2 - t1:.3f} s on the host")
    require(sorted(o4.perm.tolist()) == list(range(a.n)) and rcm.perm.size == a.n,
            "an ordering is not a permutation")
    got = ordering_models(a)
    for spec, want in ORDERING_EXPECTED.items():
        rec = got[spec]
        sw, fa = rec["sweep"], rec["factor"]
        have = dict(levels=sw["levels"], epochs=sw["epochs"],
                    collectives=sw["collectives_per_apply"], supersteps=fa["n_supersteps"],
                    halo_bytes=fa["halo_bytes_per_superstep"], fill_nnz=fa["fill_nnz"])
        say(f"[ordering] {spec}: {have['levels']} sweep levels, {have['epochs']} epochs, "
            f"{have['collectives']} collectives per apply, {have['supersteps']} supersteps, "
            f"{have['halo_bytes']} halo bytes per superstep, fill nnz {have['fill_nnz']:,}; "
            f"payload {sw['payload_slots_per_apply']} slots per apply; symbolic and models "
            f"{rec['seconds']:.2f} s on the host")
        require(have == want, f"[ordering] {spec}: {have} != the expected {want}")
    return o4


def fused_kernels_check(dev, nx=128):
    """The persistent superstep_factor and epoch_sweep launches on the
    tables of a fusion ordering (poisson_2d(nx), SHARDED_D owners), bitwise
    against their plain versions: the per-superstep loop of
    ref.superstep_factor_ref and ref.sharded_sweep_ref (nb = 1 and NB), and
    against numeric_ilu_ref of the permuted matrix."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu, ilu_sharded
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.numeric import make_superstep_factorizer, plan_state_array
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.ordering import fusion_aware_ordering
    from repro_torch.core.top_ilu import BandGroup
    from repro_torch.kernels import ops, ref

    a = poisson_2d(nx)
    o = fusion_aware_ordering(a, SHARDED_D, band_rows=BAND_ROWS)
    group = BandGroup(SHARDED_D, dev)
    ops.reset_launch_counts()
    f = ilu_sharded(a, 1, band_rows=BAND_ROWS, group=group, ordering=o)
    require(ops.launch_counts()["superstep_factor"] == 1, "fused factorization: not one launch")
    plan = f.plan
    want = numeric_ilu_ref(f.a, f.pattern)
    require(bits_equal(f.values_csr(), want), f"fused poisson_2d({nx}) factor != numeric_ilu_ref")
    fac = make_superstep_factorizer(plan, group)
    st0 = torch.as_tensor(plan_state_array(plan, f.a), device=dev)

    def plain_step(st, *args):
        st.copy_(ref.superstep_factor_ref(st, *args))

    got = fac(st0.clone())
    plain = fac(st0.clone(), group=BandGroup(SHARDED_D, dev), step=plain_step)
    require(bits_equal(got, plain), "fused: persistent superstep_factor != the plain loop")
    apply = f.precond()
    single = ilu(f.a, 1, device=dev).precond()
    bs = torch.as_tensor(np.random.default_rng(SEED + 11).standard_normal((NB, a.n))
                         .astype(np.float32), device=dev)
    for nb in (1, NB):
        ops.reset_launch_counts()
        got = apply.batched(bs[:nb])
        require(ops.launch_counts()["epoch_sweep"] == 1, "fused apply: not one launch")
        want = ref.sharded_sweep_ref(apply.sweep.tables, apply._lv, apply._uv, apply._dg,
                                     bs[:nb], BandGroup(SHARDED_D, dev), "gather")
        require(bits_equal(got, want), f"fused apply nb={nb}: epoch_sweep != plain version")
        require(bits_equal(got, single.batched(bs[:nb])), f"fused apply nb={nb} != PrecondApply")
    tp = apply.plan
    say(f"[distributed-fusion] poisson_2d({nx}) fused over {SHARDED_D} owners: "
        f"{plan.n_supersteps} supersteps (<= {plan.bands_per_superstep} bands per owner, halo "
        f"{plan.halo_size} rows, E={plan.egress_max}), {tp.l_sched.n_epochs}+"
        f"{tp.u_sched.n_epochs} epochs (maxr {tp.maxr_l}/{tp.maxr_u}): the persistent "
        "superstep_factor equal to the plain per-superstep loop and to numeric_ilu_ref, the "
        f"persistent epoch_sweep (nb = 1, {NB}) to sharded_sweep_ref and PrecondApply, bitwise")


def phase_distributed_fusion(dev, b, o4, nx=400):
    """Path E under the fusion ordering ``o4``: solve_sharded over
    SHARDED_D owners, GMRES(30) at TOL; x bitwise equal to the card's
    single-device solve_with_ilu given the same Ordering; one
    superstep_factor launch per factorization and one epoch_sweep launch
    per apply; device ms per apply and per factorization; the fused full-
    size apply against ref.sharded_sweep_ref; one profiled restart."""
    import numpy as np
    import torch

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.numeric import make_superstep_factorizer, plan_state_array
    from repro_torch.core.solvers import solve_sharded, solve_with_ilu
    from repro_torch.core.top_ilu import BandGroup
    from repro_torch.kernels import build, ops, ref

    fused_kernels_check(dev)
    a = poisson_2d(nx)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_sharded(a, b, k=1, n_devices=SHARDED_D, band_rows=BAND_ROWS,
                              ordering=o4, tol=TOL, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    true_rel = true_residual(a, b, res.x)
    apply = fact.precond()
    tp, plan = apply.plan, fact.plan
    n_ep = tp.l_sched.n_epochs + tp.u_sched.n_epochs
    applies = len(res.history) * 31  # m = 30 Arnoldi applies and the update's, per restart
    say(f"[distributed-fusion] poisson_2d({nx}) n={a.n} ILU(1), fusion ordering for "
        f"{SHARDED_D} owners of {BAND_ROWS}-row bands, GMRES(30) tol={TOL}: verdict="
        f"{res.verdict} inner steps={res.iterations} restarts={len(res.history)} "
        f"residual={res.residual:.3e} float64 true residual={true_rel:.3e}")
    say(f"[distributed-fusion] wall {wall:.3f} s = factor {factor_s:.3f} s (symbolic "
        f"{fact.symbolic_seconds:.3f} s, plan + supersteps + audit {fact.numeric_seconds:.3f} s;"
        f" {plan.n_supersteps} supersteps) + solve {wall - factor_s:.3f} s; {n_ep} epochs and "
        f"{tp.sweep_collectives_per_apply()} exchanges per apply; launches: "
        f"{counts['superstep_factor']} superstep_factor, {counts['epoch_sweep']} epoch_sweep "
        f"for {applies} applies, {counts['spmv_ell']} spmv_ell")
    check_launches("distributed-fusion", counts, ("epoch_sweep", "superstep_factor", "spmv_ell"),
                   idle=("factor_wavefront", "tri_solve_wavefront", "inverse_chain"))
    require(counts["superstep_factor"] == 1, "distributed-fusion: not one factorization launch")
    require(counts["epoch_sweep"] == applies, f"distributed-fusion: {counts['epoch_sweep']} "
            f"epoch_sweep launches for {applies} applies")
    require(res.verdict == "converged" and true_rel <= 2 * TOL,
            f"distributed-fusion: {res.verdict}, true residual {true_rel:.3e}")
    single, sf = solve_with_ilu(a, b, k=1, ordering=o4, tol=TOL, device=dev)
    require((single.iterations, single.verdict) == (res.iterations, res.verdict)
            and np.array_equal(single.x.view(np.int32), res.x.view(np.int32)),
            "distributed-fusion x != solve_with_ilu(ordering=o4) on the card")
    require(bits_equal(fact.values_csr(), sf.vals),
            "distributed-fusion factor != the single-device factor of the permuted matrix")
    bp = torch.as_tensor(o4.permute_vector(b)[None], device=dev)
    want = ref.sharded_sweep_ref(apply.sweep.tables, apply._lv, apply._uv, apply._dg, bp,
                                 BandGroup(SHARDED_D, dev), "gather")
    require(bits_equal(apply.batched(bp), want), "fused full-size apply != sharded_sweep_ref")
    say(f"[distributed-fusion] x bitwise equal to solve_with_ilu(ordering=o4) on the card "
        f"({single.iterations} steps), the factor to its factor_wavefront factor, the "
        "full-size apply to sharded_sweep_ref")
    apply_ms = time_ms(lambda: apply.batched(bp), reps=20)
    apply_dev = device_ms(lambda: apply.batched(bp), "epoch_sweep_kernel", reps=10)
    fac = make_superstep_factorizer(plan, fact.group)
    st0 = torch.as_tensor(plan_state_array(plan, fact.a), device=dev)
    fac_ms = time_ms(lambda: fac(st0.clone()), reps=10)
    fac_dev = device_ms(lambda: fac(st0.clone()), "superstep_factor_persistent_kernel", reps=5)
    host = factor_tables(plan)
    chain = in_band_chain(plan, host)
    lib = build.load()
    flags = torch.zeros(SHARDED_D, dtype=torch.int32, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)

    def floor():
        err = lib.superstep_factor_chain_floor_launch(SHARDED_D, plan.n_supersteps, chain,
                                                      flags.data_ptr(), sink.data_ptr(),
                                                      torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the factor's chain floor kernel did not launch (CUDA error {err})")

    floor_ms = device_ms(floor, "superstep_factor_chain_floor_kernel", reps=5)
    na = "not measured"
    say(f"[distributed-fusion] {apply_ms:.4f} ms per apply (device "
        + (na if apply_dev is None else f"{apply_dev:.4f} ms, {apply_dev * 1e3 / n_ep:.3f} us "
           f"per epoch, {apply_dev * 1e3 / (tp.nl_levels + tp.nu_levels):.3f} us per level")
        + f"; levels of up to {tp.maxr_l}/{tp.maxr_u} rows per owner); {fac_ms:.3f} ms per "
        "factorization (device "
        + (na if fac_dev is None else f"{fac_dev:.3f} ms, {fac_dev * 1e3 / plan.n_supersteps:.3f}"
           " us per superstep") + "; chain floor "
        + (na if floor_ms is None else f"{floor_ms:.3f} ms") + f" for {chain} in-band pivots a "
        f"superstep; <= {plan.bands_per_superstep} bands per owner a superstep, halo "
        f"{plan.halo_size} rows, E={plan.egress_max} W={plan.width} MP={plan.max_piv}, "
        f"{host['push_src'].size} rows pushed, <= {host['p_max']} per superstep and sender)")
    profile_resolve("distributed-fusion", a, b, dev, solve=solve_sharded, activities=("cuda",),
                    tol=TOL, n_devices=SHARDED_D, band_rows=BAND_ROWS, ordering=o4)
    return counts, res


def dist_ranks_body(group, nx, b, fusion_perm, b_nat, serve=()):
    """[dist-ranks] / [dist-nccl], on each rank of a DistBandGroup: the
    fusion-ordered solve_sharded of poisson_2d(nx) (GMRES(30) for
    DIST_RANKS_MAXITER restarts, TOL; the matrix built here, b from the
    parent); with ``b_nat`` also the natural factorization with the ring
    broadcast and, on its factors, one sweep apply per vector of ``b_nat``
    and one inverse apply of the first; then [serve-ranks]: one ranked
    solve service per case of ``serve`` (``serve_rank``'s arguments; rank 0
    leads, the others follow). Each part reads the launch counts and the
    group's counts and walls it made."""
    import numpy as np
    import torch

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import serve_rank

    dev = group.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def start():
        group.reset_counts()
        ops.reset_launch_counts()
        sync()
        return time.perf_counter()

    def done(t0, **kw):
        sync()
        return dict(wall=time.perf_counter() - t0, counts=group.counts(),
                    launches=ops.launch_counts(), collective_s=group.exchange_seconds,
                    staged=group.staged_bytes, **kw)

    a = poisson_2d(nx)
    t0 = start()
    res, fact = solve_sharded(a, b, k=1, group=group, band_rows=BAND_ROWS, ordering="fusion",
                              tol=TOL, maxiter=DIST_RANKS_MAXITER)
    out = dict(rank=group.rank, fusion=done(
        t0, x=res.x, steps=res.iterations, restarts=len(res.history), verdict=res.verdict,
        residual=res.residual, factor_s=fact.symbolic_seconds + fact.numeric_seconds,
        supersteps=fact.plan.n_supersteps, block=tuple(fact.loc_vals.shape),
        same_perm=bool(np.array_equal(fact.ordering.perm, fusion_perm)),
        runs=fact.precond().sweep.tables.runs()))
    if b_nat is not None:
        dist_ranks_natural(group, nx, b_nat, out, start, done)
    out["serve"] = []
    for case in serve:
        t0 = start()
        got = serve_rank(group, *case)
        got.update(wall=time.perf_counter() - t0, launches=ops.launch_counts())
        out["serve"].append(got)
    return out


def dist_ranks_natural(group, nx, b_nat, out, start, done):
    """[dist-ranks]' natural parts on one rank, into ``out``: the ring
    factorization of poisson_2d(nx), a sweep apply per vector of ``b_nat``
    and one inverse apply of the first."""
    import torch

    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.matgen import poisson_2d

    dev = group.device
    a = poisson_2d(nx)
    t0 = start()
    f = ilu_sharded(a, 1, band_rows=BAND_ROWS, group=group, broadcast="ring")
    out["factor"] = done(t0, supersteps=f.plan.n_supersteps, block=tuple(f.loc_vals.shape),
                         state_bytes=f.loc_vals.untyped_storage().nbytes(),
                         per_device=f.per_device_value_bytes(),
                         replicated=f.plan.replicated_value_bytes())
    out["factor"]["vals"] = f.values_csr()
    apply = f.precond()
    out["applies"] = []
    for bb in b_nat:
        t0 = start()
        y = apply(torch.as_tensor(bb, device=dev))
        out["applies"].append(done(t0, y=y.cpu().numpy(), runs=apply.sweep.tables.runs()))
    inv = f.precond(method="inverse")  # the inverse values, computed on each rank
    t0 = start()
    y = inv(torch.as_tensor(b_nat[0], device=dev))
    out["inverse"] = done(t0, y=y.cpu().numpy())


def fusion_reference(dev, b, ordering, n_owners, nx=400):
    """The one-card run the ranks' fusion solve is held to: solve_sharded
    over ``n_owners`` owners of one BandGroup with the same restarts
    (a new matrix, so a new group whose counts are this call's)."""
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded

    res, fact = solve_sharded(poisson_2d(nx), b, k=1, n_devices=n_owners, band_rows=BAND_ROWS,
                              ordering=ordering, tol=TOL, maxiter=DIST_RANKS_MAXITER, device=dev)
    return res, fact.group.counts(), fact.plan.n_supersteps


def dist_ranks_check(tag, out, ref, ref_nat=None):
    """Hold each rank's results of :func:`dist_ranks_body` to the one-card
    runs: the fusion solve to ``ref`` (:func:`fusion_reference`), the
    natural parts to ``ref_nat``; print the walls."""
    import numpy as np

    fused, fused_gc, n_sup = ref
    for o in out:
        r, fu = o["rank"], o["fusion"]
        applies = fu["restarts"] * 31  # m = 30 Arnoldi applies and the update's, per restart
        say(f"[{tag}] rank {r}: fusion solve {fu['verdict']} after {fu['steps']} steps, "
            f"{fu['restarts']} restarts (maxiter {DIST_RANKS_MAXITER}); wall {fu['wall']:.3f} s "
            f"= factor {fu['factor_s']:.3f} s + solve {fu['wall'] - fu['factor_s']:.3f} s, of "
            f"which collectives {fu['collective_s']:.3f} s ({fu['counts']['collectives']} "
            f"collectives, {fu['counts']['payload_bytes']:,} payload bytes sent, "
            f"{fu['staged']:,} bytes staged through the host); block {fu['block']}; launches: "
            f"{fu['launches']['superstep_factor']} superstep_factor, "
            f"{fu['launches']['epoch_sweep']} epoch_sweep ({fu['runs']} runs per apply), "
            f"{fu['launches']['spmv_ell']} spmv_ell")
        require(fu["same_perm"], f"{tag} rank {r}: the fusion ordering for {len(out)} ranks "
                "differs from the reference's")
        require(np.array_equal(fu["x"].view(np.int32), fused.x.view(np.int32))
                and (fu["steps"], fu["restarts"], fu["verdict"])
                == (fused.iterations, len(fused.history), fused.verdict),
                f"{tag} rank {r}: x, steps, restarts or verdict != the one-card run's")
        require(fu["launches"]["superstep_factor"] == fu["supersteps"] == n_sup,
                f"{tag} rank {r}: {fu['launches']['superstep_factor']} superstep_factor "
                f"launches, the plan has {n_sup} supersteps")
        require(fu["launches"]["epoch_sweep"] == applies * fu["runs"],
                f"{tag} rank {r}: {fu['launches']['epoch_sweep']} epoch_sweep launches for "
                f"{applies} applies of {fu['runs']} runs")
        require(fu["counts"] == fused_gc, f"{tag} rank {r}: counts {fu['counts']} != the "
                f"one-card group's {fused_gc}")
        if ref_nat is None:
            continue
        fa = o["factor"]
        say(f"[{tag}] rank {r}: natural factorization (ring) {fa['wall']:.3f} s, of which "
            f"collectives {fa['collective_s']:.3f} s ({fa['counts']['collectives']}); "
            f"{fa['launches']['superstep_factor']} superstep_factor launches; value state "
            f"{fa['block']} of {fa['state_bytes']:,} B (replicated: {fa['replicated']:,} B); "
            "applies "
            + ", ".join(f"{ap['wall'] * 1e3:.1f} ms ({ap['launches']['epoch_sweep']} "
                        f"epoch_sweep launches, {ap['counts']['collectives']} collectives in "
                        f"{ap['collective_s'] * 1e3:.1f} ms)" for ap in o["applies"])
            + f"; inverse apply {o['inverse']['wall'] * 1e3:.1f} ms")
        require(np.array_equal(fa["vals"].view(np.int32), ref_nat["vals"].view(np.int32)),
                f"{tag} rank {r}: natural factors != the one-card factors")
        require(fa["launches"]["superstep_factor"] == fa["supersteps"]
                and fa["counts"] == ref_nat["factor_counts"]
                and fa["state_bytes"] == fa["per_device"] < fa["replicated"],
                f"{tag} rank {r}: natural factorization launches, counts or value state wrong")
        for i, (ap, (y, c)) in enumerate(zip(o["applies"], ref_nat["applies"])):
            require(np.array_equal(ap["y"].view(np.int32), y.view(np.int32)) and ap["counts"] == c
                    and ap["launches"]["epoch_sweep"] == ap["runs"],
                    f"{tag} rank {r}: natural apply {i} != the one-card apply (or its counts)")
        y, c = ref_nat["inverse"]
        require(np.array_equal(o["inverse"]["y"].view(np.int32), y.view(np.int32))
                and o["inverse"]["counts"] == c,
                f"{tag} rank {r}: inverse apply != the one-card inverse apply")


def serve_ranks_cases(nx):
    """[serve-ranks]' two services, as ``serve_rank``'s arguments, each
    with the matrix and the update's values the references need: (i) the
    inverse method on poisson_2d(nx), GMRES(30); (ii) the sweep on the CPU
    tests' matgen(SERVE_RANKS_SWEEP_N), GMRES(8). Each: half its traffic,
    a background value update, a quarter while it runs, its join, the
    rest."""
    import numpy as np

    from repro_torch.core.matgen import matgen, poisson_2d

    parts = []
    a = poisson_2d(nx)
    m = matgen(SERVE_RANKS_SWEEP_N, density=min(0.02, 12.0 / SERVE_RANKS_SWEEP_N), seed=21)
    for method, a, new, restart, n_req, tols, seed in (
            # poisson_2d scaled whole, as [serve-sharded] does: entry-wise noise
            # leaves the inverse preconditioner short of 1e-4 in 20 restarts
            ("inverse", a, (a.data * np.float32(0.8)).astype(np.float32), 30,
             SERVE_RANKS_REQUESTS, (SERVE_RANKS_TOL,), SEED + 40),
            # the CPU tests' update of matgen(256)
            ("sweep", m, (m.data * np.random.default_rng(5).uniform(0.8, 1.2, m.nnz)
                          ).astype(np.float32), 8, SERVE_RANKS_SWEEP_REQUESTS, (1e-4, 1e-5), 33)):
        config = dict(band_rows=BAND_ROWS, buckets=SERVE_RANKS_BUCKETS, k=1, restart=restart,
                      maxiter=20, precond_method=method)
        traffic = dict(tenants=("t0", "t1"), burst_max=4, tol_choices=tols)
        half, quarter = n_req // 2, n_req // 4
        steps = [("traffic", dict(n_requests=half, seed=seed, **traffic)), ("update", "m0", new),
                 ("traffic", dict(n_requests=quarter, seed=seed + 1, **traffic)), ("wait",),
                 ("traffic", dict(n_requests=n_req - half - quarter, seed=seed + 2, **traffic))]
        parts.append(dict(method=method, a=a, new=new, n=n_req, restart=restart,
                          args=(config, {"m0": (a.n, a.indptr, a.indices, a.data)}, steps,
                                DIST_RANKS_TIMEOUT_S)))
    return parts


def serve_ranks_refs(dev, parts, leads):
    """Per part, every response's reference: the one-card ShardedServeEngine
    over a BandGroup of SHARDED_D owners with the part's knobs, bound to
    the values of the version the request was admitted under, warmed, and
    solving the request alone. Returns [{request_id: LaneResult}]."""
    import numpy as np

    from repro_torch.core.api import _symbolic
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.serve.engine import ShardedServeEngine

    out = []
    for part, lead in zip(parts, leads):
        a, cfg = part["a"], part["args"][0]
        eng = ShardedServeEngine(a, _symbolic(a, 1, "sum"), n_devices=SHARDED_D,
                                 band_rows=BAND_ROWS, restart=cfg["restart"],
                                 maxiter=cfg["maxiter"], precond_method=part["method"],
                                 device=dev, buckets=SERVE_RANKS_BUCKETS)
        v0, v1 = lead["versions"]["m0"]
        a1 = CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices, data=part["new"])
        bindings = {v: eng.bind(m, eng.factor(m)) for v, m in ((v0, a), (v1, a1))}
        eng.warm(bindings[v0], (1,))
        refs = {}
        for rec in lead["records"]:
            refs[rec["request_id"]] = eng.solve(bindings[rec["version"]], rec["b"][None],
                                                np.asarray([rec["tol"]], np.float32))[0]
        out.append(refs)
    return out


def serve_ranks_check(tag, outs, parts, refs, backend="gloo"):
    """[serve-ranks] on every rank's results: per part every request
    completed, none failed, nothing built or captured after warm-up (and no
    graph captured at all on rank 0), every follower's solve digests equal
    rank 0's, every response bitwise equal to the one-card engine's
    (``refs``), both value versions served; prints solves/s, p50 and p99,
    collectives and staged bytes per batch, cold restarts and the launches.
    Returns rank 0's launch counts over both parts."""
    import numpy as np

    total = {}
    for i, part in enumerate(parts):
        lead = outs[0]["serve"][i]
        snap, tr = lead["metrics"], lead["traffic"]
        name = f"{tag} ({'i' if i == 0 else 'ii'}) {part['method']}"
        req = snap["requests"]
        require(req["admitted"] == req["completed"] == part["n"] and req["failed"] == 0,
                f"[{name}] requests {req}")
        require(snap["compiles"]["after_warmup"] == 0 and lead["events"]["captures"] == 0,
                f"[{name}] after warm-up: compiles {snap['compiles']}, events {lead['events']}")
        for o in outs[1:]:
            require(o["serve"][i]["digests"] == lead["digests"],
                    f"[{name}] rank {o['rank']}'s solve digests differ from rank 0's")
        v0, v1 = lead["versions"]["m0"]
        require({r["version"] for r in lead["responses"]} == {v0, v1},
                f"[{name}] the responses did not see both value versions {v0}, {v1}")
        for r in lead["responses"]:
            ref = refs[i][r["request_id"]]
            require(r["ok"] and bits_equal(np.asarray(r["x"], np.float32), ref.x)
                    and (r["iterations"], r["verdict"]) == (ref.iterations, ref.verdict),
                    f"[{name}] response {r['request_id']} (v{r['version']}) != the one-card "
                    "engine's solve of it")
        lat = sorted(r["latency"] for r in lead["responses"])
        batches = snap["coalescing"]["batches"]
        say(f"[{name}] {len(outs)} {backend} ranks, n={part['a'].n}, GMRES({part['restart']}): "
            f"{part['n']} requests of 2 tenants in {batches} batches around one background "
            f"value update in {lead['seconds']['traffic']:.3f} s: "
            f"{part['n'] / lead['seconds']['traffic']:.3f} solves/s, latency p50 "
            f"{lat[len(lat) // 2] * 1e3:.1f} ms, p99 {lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3:.1f} ms; "
            f"{tr['counts']['collectives'] / batches:.1f} collectives per batch "
            f"({tr['counts']['collectives']} in {tr['exchange_seconds']:.3f} s), "
            f"{tr['staged_bytes'] / batches:,.0f} bytes staged per batch; register "
            f"{lead['seconds']['register']:.3f} s, warm-up {lead['seconds']['warmup']:.3f} s; "
            f"compiles {json.dumps(snap['compiles'])}, cold restarts "
            f"{json.dumps(snap['cold_restarts'])}, captures {lead['events']['captures']}; "
            f"announced {json.dumps(lead['announced'])}")
        for k, v in lead["launches"].items():
            total[k] = total.get(k, 0) + v
    say(f"[{tag}] every response bitwise equal to the one-card ShardedServeEngine over "
        f"{SHARDED_D} owners on its value version; followers' digests equal rank 0's")
    return total


def phase_pipeline_demo(dev, owners=PIPELINE_DEMO_OWNERS):
    """[pipeline-demo]: examples/ilu_pipeline_demo_torch.py's run on the card
    (one BandGroup of ``owners`` owners): psum and ring each bitwise equal
    to numeric_ilu_ref, one superstep_factor launch per factorization."""
    import importlib.util

    from repro_torch.kernels import ops

    path = Path(__file__).resolve().parent / "examples" / "ilu_pipeline_demo_torch.py"
    spec = importlib.util.spec_from_file_location("ilu_pipeline_demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = demo.run(owners, dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    require(all(ok for ok, _, _ in out.values()),
            "[pipeline-demo] a broadcast's factors differ from numeric_ilu_ref")
    check_launches("pipeline-demo", counts, ("superstep_factor",),
                   idle=("factor_wavefront", "epoch_sweep", "tri_solve_wavefront"))
    require(counts["superstep_factor"] == len(out),
            f"[pipeline-demo] {counts['superstep_factor']} superstep_factor launches for "
            f"{len(out)} factorizations")
    say(f"[pipeline-demo] matgen(512) PILU(1) over {owners} owners on the card: psum and ring "
        f"bitwise equal to numeric_ilu_ref, one superstep_factor launch each; {wall:.2f} s "
        "with the plan")
    return counts


def phase_dist_ranks(dev, nx=None):
    """[dist-ranks]: the band owners as SHARDED_D processes (gloo ranks, all
    on this card, each exchange staged through pinned host memory), spawned
    by run_ranks, on poisson_2d(DIST_RANKS_NX): the fusion-ordered
    solve_sharded for DIST_RANKS_MAXITER restarts equal to the one-card run
    of the same call (x on every rank, steps, restarts, verdict, the group's
    counts; one superstep_factor launch per superstep); the natural
    factorization (ring) equal to the one-card factorization over
    SHARDED_D owners of one BandGroup, DIST_RANKS_APPLIES sweep applies and
    one inverse apply equal to the one-card applies, with equal counts.
    Returns rank 0's launch counts of its fusion solve, and (b, the fusion
    ordering, the reference, nx) for [dist-nccl]."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.ordering import fusion_aware_ordering
    from repro_torch.core.top_ilu import BandGroup
    from repro_torch.launch.dist import run_ranks

    nx = nx or DIST_RANKS_NX
    a = poisson_2d(nx)
    rng = np.random.default_rng(SEED + 12)
    b = rng.standard_normal(a.n).astype(np.float32)
    o = fusion_aware_ordering(a, SHARDED_D, band_rows=BAND_ROWS)
    ref = fusion_reference(dev, b, o, SHARDED_D, nx)
    b_nat = [rng.standard_normal(a.n).astype(np.float32) for _ in range(DIST_RANKS_APPLIES)]
    g = BandGroup(SHARDED_D, dev)
    f = ilu_sharded(a, 1, band_rows=BAND_ROWS, group=g, broadcast="ring")
    ref_nat = dict(vals=f.values_csr(), factor_counts=g.counts(), applies=[])
    apply = f.precond()
    for bb in b_nat:
        g.reset_counts()
        y = apply(torch.as_tensor(bb, device=dev)).cpu().numpy()
        ref_nat["applies"].append((y, g.counts()))
    inv = f.precond(method="inverse")
    g.reset_counts()
    ref_nat["inverse"] = (inv(torch.as_tensor(b_nat[0], device=dev)).cpu().numpy(), g.counts())
    parts = serve_ranks_cases(nx)
    t0 = time.perf_counter()
    out = run_ranks(dist_ranks_body, SHARDED_D, "gloo", ["cuda"] * SHARDED_D,
                    timeout_s=DIST_RANKS_TIMEOUT_S,
                    args=(nx, b, o.perm, b_nat, [p["args"] for p in parts]))
    wall = time.perf_counter() - t0
    say(f"[dist-ranks] poisson_2d({nx}) n={a.n} ILU(1), {SHARDED_D} gloo ranks of "
        f"{BAND_ROWS}-row bands on one card ({torch.cuda.get_device_name(0)}): {wall:.1f} s "
        "with the spawn, the ranks' imports, their CUDA contexts and host plans, and "
        f"[serve-ranks]' {sum(p['wall'] for p in out[0]['serve']):.1f} s")
    dist_ranks_check("dist-ranks", out, ref, ref_nat)
    t1 = time.perf_counter()
    serve_refs = serve_ranks_refs(dev, parts, out[0]["serve"])
    say(f"[serve-ranks] the one-card references: {time.perf_counter() - t1:.1f} s")
    serve_counts = serve_ranks_check("serve-ranks", out, parts, serve_refs)
    check_launches("serve-ranks", serve_counts, ("spmv_ell", "epoch_sweep", "superstep_factor"),
                   idle=("factor_wavefront", "tri_solve_wavefront", "inverse_chain"))
    check_launches("dist-ranks", out[0]["fusion"]["launches"],
                   ("epoch_sweep", "superstep_factor", "spmv_ell"),
                   idle=("factor_wavefront", "tri_solve_wavefront", "inverse_chain"))
    say(f"[dist-ranks] every rank: the fusion solve's x, steps, restarts and verdict bitwise "
        f"equal to the one-card run with maxiter {DIST_RANKS_MAXITER}, one superstep_factor "
        "launch per superstep, the one-card group's counts; the natural factors (ring), "
        f"{DIST_RANKS_APPLIES} sweep apply(ies) and the inverse apply equal to the one-card "
        f"ones over {SHARDED_D} owners, with equal counts")
    return out[0]["fusion"]["launches"], serve_counts, (b, o, ref, nx, parts)


def phase_dist_nccl(dev, b, o4, ref, nx=400, parts=None):
    """[dist-nccl]: with two cards or more, the fusion solve of [dist-ranks]
    over NCCL ranks, one card each (D = min(SHARDED_D, cards)), under the
    same requirements, held to ``ref`` ([dist-ranks]' one-card run) or, where
    D differs from SHARDED_D, to a one-card run of D owners; with SHARDED_D
    cards also [serve-ranks]' services (``parts``) over the NCCL ranks, held
    to the one-card engine. With one card it says that it did not run, and
    why."""
    import numpy as np
    import torch

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.ordering import fusion_aware_ordering
    from repro_torch.launch.dist import run_ranks

    cards = torch.cuda.device_count()
    if cards < 2:
        say(f"[dist-nccl] not run: this machine has {cards} card, and NCCL refuses two ranks "
            "on one card (the gloo ranks of [dist-ranks] share it instead)")
        return
    D = min(SHARDED_D, cards)
    ordering = o4
    if D != SHARDED_D:
        ordering = fusion_aware_ordering(poisson_2d(nx), D, band_rows=BAND_ROWS)
        ref = fusion_reference(dev, b, ordering, D, nx)
    serve = parts is not None and D == SHARDED_D
    out = run_ranks(dist_ranks_body, D, "nccl", None, timeout_s=DIST_RANKS_TIMEOUT_S,
                    args=(nx, b, np.asarray(ordering.perm), None,
                          [p["args"] for p in parts] if serve else ()))
    dist_ranks_check("dist-nccl", out, ref)
    say(f"[dist-nccl] {D} NCCL ranks, one card each: x, steps, restarts, verdict and counts "
        "equal to the one-card run")
    if serve:
        serve_ranks_check("dist-nccl serve-ranks", out, parts,
                          serve_ranks_refs(dev, parts, out[0]["serve"]), backend="NCCL")


def engines_of(matvec):
    return list(matvec.__dict__.get("_torch_engines", {}).values())


def replay_busy(engine, tag):
    """Wall, device busy time and kernels of one replay of a warmed
    restart's graph, under torch.profiler (device trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.graph.replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = kernel_events(prof)
    busy = sum(us for _, us in events) / 1e6
    share = (f"{len(events)} kernels traced, device busy {busy:.4f} s "
             f"({100 * busy / wall:.1f}% of wall)" if events
             else "no kernel events in the trace: device busy not measured")
    say(f"[profile {tag}] one replayed restart under torch.profiler: wall {wall:.4f} s, {share}")


def warm_counts():
    """The launches of a run: each wrapper's own, plus those its graph
    replays made (counted per graph at its capture, times its replays)."""
    from repro_torch.kernels import ops

    counts = ops.launch_counts()
    graphs = ops.graph_counts()
    for name, n in graphs["kernels"].items():
        counts[name] += n
    return counts, graphs


def phase_warm(dev, b, single, multi, dist_cold, fused_cold, o4, nx=400):
    """[warm]: warm_solve on the main path (nb buckets 1 and NB) and on path
    E (SHARDED_D owners, natural ordering: buckets 1 and NB; fusion ordering
    o4: bucket 1), each bucket's GMRES restart captured as one CUDA graph;
    the warmed solves replay it once per restart and must equal the cold
    solves bitwise ([main], the [multi-rhs] lanes, [distributed],
    [distributed-fusion]); a ragged batch of 3 through bucket NB equals its
    lanes' solo solves. Prints the capture seconds, the kernels per graph,
    the wall per restart, the replays, and one replayed restart's device
    busy share. Returns the launch counts of the main and path E warm
    solves (wrapper launches plus graph replays)."""
    import numpy as np

    from repro_torch.core import solvers
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded, solve_with_ilu, warm_solve
    from repro_torch.kernels import ops

    def same(got, want, what):
        require((got.iterations, got.verdict, len(got.history))
                == (want.iterations, want.verdict, len(want.history))
                and np.array_equal(got.x.view(np.int32), want.x.view(np.int32)),
                f"[warm] {what}: ({got.iterations}, {got.verdict}) != ({want.iterations}, "
                f"{want.verdict}) or x differs")

    def report(tag, secs, matvec):
        engines = sorted(engines_of(matvec), key=lambda e: e.nb)
        for e in engines:
            require(e.graph is not None, f"[warm] {tag}: nb={e.nb} was not captured")
            say(f"[warm] {tag} nb={e.nb}: restart graph of {sum(e.kernels.values())} kernels "
                f"({json.dumps(e.kernels)}) captured in {e.capture_seconds:.3f} s")
        say(f"[warm] {tag}: warm_solve seconds per batch size {json.dumps(secs)}")
        return engines

    bs, tols, multi_rs = multi
    by_path = {}
    # the main path
    a = poisson_2d(nx)
    secs = warm_solve(a, k=1, batch_sizes=(1, NB), sharded=False, tol=TOL, device=dev)
    mv = a.__dict__[solvers.SOLVE_CACHE_KEY][("matvec", str(dev))]
    engines = report("main", secs, mv)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, _ = solve_with_ilu(a, b, k=1, tol=TOL, device=dev)
    wall = time.perf_counter() - t0
    counts, graphs = warm_counts()
    same(res, single, "main nb=1 != [main]")
    require(graphs["replays"] == len(res.history), f"[warm] main: {graphs['replays']} replays "
            f"for {len(res.history)} restarts")
    say(f"[warm] main: {res.iterations} steps, residual {res.residual:.3e}, x bitwise equal to "
        f"[main]; wall {wall:.3f} s for {len(res.history)} restarts = "
        f"{wall / len(res.history):.4f} s per restart (factor cached), {graphs['replays']} "
        "graph replays")
    check_launches("warm", counts, ("spmv_ell", "tri_solve_wavefront"),
                   idle=("inverse_chain", "epoch_sweep"))
    by_path["warm"] = counts
    replay_busy(engines[0], "warm main")
    t0 = time.perf_counter()
    rs, _ = solve_with_ilu(a, bs, k=1, tol=tols, device=dev)
    wall = time.perf_counter() - t0
    for i, (g, w) in enumerate(zip(rs, multi_rs)):
        same(g, w, f"main nb={NB} lane {i} != [multi-rhs]")
    say(f"[warm] main nb={NB}: every lane bitwise equal to [multi-rhs]'s; wall {wall:.3f} s "
        f"({wall / NB:.3f} s per RHS)")
    replay_busy(engines[1], f"warm main nb={NB}")

    # path E, natural ordering
    a = poisson_2d(nx)
    secs = warm_solve(a, k=1, batch_sizes=(1, NB), n_devices=SHARDED_D, band_rows=BAND_ROWS,
                      tol=TOL, device=dev)
    cache = a.__dict__[solvers.SOLVE_CACHE_KEY]
    mv = next(v[1] for key, v in cache.items() if key[0] == "sharded_matvec")
    engines = report("distributed", secs, mv)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_sharded(a, b, k=1, n_devices=SHARDED_D, band_rows=BAND_ROWS, tol=TOL,
                              device=dev)
    wall = time.perf_counter() - t0
    counts, graphs = warm_counts()
    same(res, dist_cold, "distributed nb=1 != [distributed]")
    say(f"[warm] distributed: x bitwise equal to [distributed] (and [main]); wall {wall:.3f} s "
        f"for {len(res.history)} restarts = {wall / len(res.history):.4f} s per restart, "
        f"{graphs['replays']} graph replays")
    check_launches("warm-distributed", counts, ("spmv_ell", "epoch_sweep"),
                   idle=("tri_solve_wavefront", "inverse_chain", "superstep_factor"))
    by_path["warm-distributed"] = counts
    replay_busy(engines[0], "warm distributed")
    ragged, _ = solve_sharded(a, bs[:3], fact=fact, tol=tols[:3])
    require(len(ragged) == 3, "[warm] ragged batch: not 3 results")
    same(ragged[0], single, "distributed ragged lane 0 != [main]")
    for i in (1, 2):
        solo, _ = solve_sharded(a, bs[i], fact=fact, tol=float(tols[i]))
        same(ragged[i], solo, f"distributed ragged lane {i} != its solo solve")
    say(f"[warm] distributed: a ragged batch of 3 through bucket {NB}, each lane bitwise equal "
        "to its solo solve")

    # path E, fusion ordering
    a = poisson_2d(nx)
    secs = warm_solve(a, k=1, batch_sizes=(1,), n_devices=SHARDED_D, band_rows=BAND_ROWS,
                      ordering=o4, tol=TOL, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_sharded(a, b, k=1, n_devices=SHARDED_D, band_rows=BAND_ROWS, ordering=o4,
                              tol=TOL, device=dev)
    wall = time.perf_counter() - t0
    counts, graphs = warm_counts()
    same(res, fused_cold, "distributed-fusion != [distributed-fusion]")
    check_launches("warm-distributed-fusion", counts, ("spmv_ell", "epoch_sweep"),
                   idle=("tri_solve_wavefront", "inverse_chain", "superstep_factor"))
    by_path["warm-distributed-fusion"] = counts
    mv = next(v[1] for key, v in fact.a.__dict__[solvers.SOLVE_CACHE_KEY].items()
              if key[0] == "sharded_matvec")
    engines = report("distributed-fusion", secs, mv)
    say(f"[warm] distributed-fusion: x bitwise equal to [distributed-fusion]; wall {wall:.3f} s "
        f"for {len(res.history)} restarts = {wall / len(res.history):.4f} s per restart, "
        f"{graphs['replays']} graph replays")
    replay_busy(engines[0], "warm distributed-fusion")
    return by_path


def phase_bicgstab(dev):
    """[bicgstab]: ILU(1) BiCGSTAB on poisson_2d(400) and on the
    non-symmetric convection_diffusion_2d(BICGSTAB_CD_NX) at TOL. Where float32 stalls
    above TOL (a verdict other than converged, or a float64 true residual
    above 2·TOL), the solve runs again at BICGSTAB_FALLBACK_TOL with the
    factor cached, and says so; the gate is the float64 true residual <=
    2·tol of the solve that passes."""
    import numpy as np

    from repro_torch.core.matgen import convection_diffusion_2d, poisson_2d
    from repro_torch.core.solvers import solve_with_ilu
    from repro_torch.kernels import ops

    counts = None
    for name, make in (("poisson_2d(400)", lambda: poisson_2d(400)),
                       (f"convection_diffusion_2d({BICGSTAB_CD_NX})",
                        lambda: convection_diffusion_2d(BICGSTAB_CD_NX))):
        t0 = time.perf_counter()
        a = make()
        gen_s = time.perf_counter() - t0
        b = np.random.default_rng(SEED + 12).standard_normal(a.n).astype(np.float32)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res, fact = solve_with_ilu(a, b, k=1, method="bicgstab", tol=TOL, device=dev)
        wall = time.perf_counter() - t0
        counts = counts or ops.launch_counts()
        factor_s = fact.symbolic_seconds + fact.numeric_seconds
        true_rel = true_residual(a, b, res.x)
        t0 = time.perf_counter()
        again, _ = solve_with_ilu(a, b, k=1, method="bicgstab", tol=TOL, device=dev)
        cached = time.perf_counter() - t0
        require(bits_equal(again.x, res.x), f"bicgstab on {name}: a second solve differs")
        say(f"[bicgstab] {name} n={a.n} nnz={a.nnz} (made in {gen_s:.1f} s) ILU(1) fill "
            f"{fact.nnz:,}, BiCGSTAB tol={TOL}: verdict={res.verdict} iterations="
            f"{res.iterations} residual={res.residual:.3e} float64 true residual="
            f"{true_rel:.3e}; wall {wall:.3f} s = factor {factor_s:.3f} s + solve "
            f"{wall - factor_s:.3f} s (sweep plan, BiCGSTAB); again with the factor and "
            f"plan cached {cached:.3f} s = {cached * 1e3 / max(1, res.iterations):.2f} ms per "
            "iteration")
        require(np.isfinite(res.x).all() and res.x.shape == (a.n,),
                f"bicgstab x malformed on {name}")
        tol = TOL
        if res.verdict != "converged" or true_rel > 2 * TOL:
            tol = BICGSTAB_FALLBACK_TOL
            say(f"[bicgstab] {name}: float32 BiCGSTAB stalls above tol={TOL} here (verdict "
                f"{res.verdict}, float64 true residual {true_rel:.3e}); gated at tol={tol}")
            res, _ = solve_with_ilu(a, b, k=1, method="bicgstab", tol=tol, device=dev)
            true_rel = true_residual(a, b, res.x)
            say(f"[bicgstab] {name} tol={tol}: verdict={res.verdict} iterations="
                f"{res.iterations} float64 true residual={true_rel:.3e}")
        require(res.verdict == "converged", f"bicgstab on {name}: {res.verdict} at tol {tol}")
        require(true_rel <= 2 * tol, f"bicgstab on {name}: float64 true residual "
                f"{true_rel:.3e} > 2*tol")
    check_launches("bicgstab", counts, ("spmv_ell", "factor_wavefront", "tri_solve_wavefront"),
                   idle=("inverse_chain", "epoch_sweep"))
    return counts


def phase_breakdown(dev):
    """[breakdown]: the shift ladder (on_breakdown="shift") on the four
    breakdown fixtures at small n, on the card and on the CPU: equal shifts
    and equal factor bits, the settled factor bitwise equal to
    numeric_ilu_ref of the shifted matrix, single-device (factor_wavefront)
    and over SHARDED_D band owners (superstep_factor)."""
    import numpy as np

    from repro_torch.core import matgen
    from repro_torch.core.api import ilu, ilu_sharded
    from repro_torch.core.guard import shifted_matrix
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.kernels import ops

    fixtures = (("singular_block_matrix(64)", matgen.singular_block_matrix(64, 0.1, seed=3), {}),
                ("zero_diagonal_matrix(64)", matgen.zero_diagonal_matrix(64, 0.1, seed=4), {}),
                ("indefinite_matrix(8)", matgen.indefinite_matrix(8), dict(pivot_tol=1e-2)),
                ("denormal_pivot_matrix(64)", matgen.denormal_pivot_matrix(64, 0.1, seed=5), {}))
    ops.reset_launch_counts()
    for name, a, kw in fixtures:
        card = ilu(a, 1, on_breakdown="shift", device=dev, **kw)
        cpu = ilu(a, 1, on_breakdown="shift", device="cpu", **kw)
        h = card.health
        require(h.ok and h.shift > 0 and h.attempts > 1, f"[breakdown] {name}: {h.summary()}")
        want = numeric_ilu_ref(shifted_matrix(a, h.shift), card.pattern)
        require(cpu.health.shift == h.shift and bits_equal(card.vals, cpu.vals),
                f"[breakdown] {name}: card != CPU")
        require(bits_equal(card.vals, want), f"[breakdown] {name}: != numeric_ilu_ref(shifted)")
        sh = ilu_sharded(a, 1, n_devices=SHARDED_D, band_rows=16, on_breakdown="shift",
                         device=dev, **kw)
        require(sh.health.shift == h.shift and bits_equal(sh.values_csr(), want),
                f"[breakdown] {name}: sharded ladder != numeric_ilu_ref(shifted)")
        say(f"[breakdown] {name}: the ladder settles on shift {h.shift:g} after {h.attempts} "
            f"attempts, card and CPU equal bits, equal to numeric_ilu_ref of the shifted "
            f"matrix (single-device and over {SHARDED_D} owners)")
    counts = ops.launch_counts()
    check_launches("breakdown", counts, ("factor_wavefront", "superstep_factor"))
    return counts


def serve_traffic(svc, ids, n, seed):
    """One seeded run_traffic segment of [serve]'s: four tenants, bursts of
    1-8, tols from SERVE_TOLS; returns (records, responses, wall)."""
    from repro_torch.serve import run_traffic

    t0 = time.perf_counter()
    res = run_traffic(svc, ids, n, seed=seed, tenants=("t0", "t1", "t2", "t3"),
                      tol_choices=SERVE_TOLS, burst_max=8)
    wall = time.perf_counter() - t0
    require(not res.rejected, f"[serve] {len(res.rejected)} well-formed requests rejected")
    return res.records, res.responses, wall


def phase_serve(dev, nx=SERVE_NX, nx_cd=128):
    """[serve]: the multi-tenant solve service. A SolveService
    (device=dev, ILU(1), GMRES(30), maxiter 20, buckets SERVE_BUCKETS)
    with three resident matrices — p0 = poisson_2d(nx) (the main path's
    matrix, at SERVE_NX), p1 = the same structure with values x1.25 (sharing p0's
    engine) and cd = convection_diffusion_2d(nx_cd) — is warmed (each
    engine's bucket restarts captured as CUDA graphs), then serves
    SERVE_REQUESTS seeded requests of four tenants; between the first 24
    and the next 16 a value update of p1 starts in the background, one
    malformed request is rejected and one request's deadline expires; the
    last 8 come after the update has landed. Launch counts are read around
    the traffic (wrappers plus graph replays). Gates: every request
    answered, no build or capture and no cold restart after warm-up, and a
    seeded sample of 6 responses — every matrix and both versions of p1 —
    bitwise equal to a solo solve_with_ilu on a fresh matrix object warmed
    with warm_solve. Prints per-tenant p50/p99, solves per second,
    batches and occupancy, captures at warm-up and after, engines shared,
    bind and refactor seconds, the value-slot copies per batch and their
    device time, and one profiled batch's device-busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.matgen import convection_diffusion_2d, poisson_2d
    from repro_torch.core.solvers import engine_events, solve_with_ilu, warm_solve
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, SolveRequest, SolveService

    def scaled(a, s):
        return CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices,
                         data=(a.data * np.float32(s)).astype(np.float32))

    p0, cd = poisson_2d(nx), convection_diffusion_2d(nx_cd)
    mats = {"p0": p0, "p1": scaled(p0, 1.25), "cd": cd}
    svc = SolveService(ServeConfig(device=dev, k=1, restart=30, maxiter=20,
                                   buckets=SERVE_BUCKETS))
    factor_s = []
    real_factorize = svc.cache._factorize

    def timed_factorize(engine, a):
        t0 = time.perf_counter()
        out = real_factorize(engine, a)
        factor_s.append(time.perf_counter() - t0)
        return out

    svc.cache._factorize = timed_factorize
    for mid, a in mats.items():
        t0 = time.perf_counter()
        svc.register_matrix(mid, a)
        e = svc.cache.entry(mid)
        say(f"[serve] register {mid} n={a.n} nnz={a.nnz}: {time.perf_counter() - t0:.3f} s "
            f"(factor {factor_s[-1]:.3f} s, bind {e.binding.bound_seconds:.3f} s)")
    snap = svc.metrics_snapshot()
    engines = {id(svc.cache.entry(m).engine): svc.cache.entry(m).engine for m in mats}
    require(snap["cache"]["engines_shared"] == 1 and len(engines) == 2
            and svc.cache.entry("p1").engine is svc.cache.entry("p0").engine,
            f"[serve] p1 does not share p0's engine ({snap['cache']})")
    ev0 = engine_events()
    t0 = time.perf_counter()
    secs = svc.warmup()
    warm_wall = time.perf_counter() - t0
    ev1 = engine_events()
    require(svc.readyz()["ready"], "[serve] not ready after warmup")
    say(f"[serve] warmup {warm_wall:.3f} s: {ev1['captures'] - ev0['captures']} restart graphs "
        f"captured, {ev1['warm_builds'] - ev0['warm_builds']} restart engines built; seconds "
        "per matrix and bucket "
        f"{json.dumps({m: {b: round(t, 3) for b, t in v.items()} for m, v in secs.items()})}")

    ops.reset_launch_counts()
    ids = list(mats)
    p1_v0 = svc.cache.entry("p1").version  # versions count per engine: p0 and p1 share one
    rec_a, resp_a, wall_a = serve_traffic(svc, ids, 24, SEED + 22)
    update = (mats["p1"].data * np.float32(0.8)).astype(np.float32)
    t_up = time.perf_counter()
    worker = svc.update_matrix_values("p1", update, background=True)
    bad = svc.submit("t1", "cd", np.ones(cd.n + 3, np.float32))
    require(not bad.ok and bad.error_reason == "bad_shape", f"[serve] malformed: {bad}")
    late = svc.submit("t2", "p0", np.ones(p0.n, np.float32), tol=1e-4, deadline_seconds=1e-6)
    require(isinstance(late, SolveRequest), "[serve] the deadline request was not admitted")
    rec_b, resp_b, wall_b = serve_traffic(svc, ids, 16, SEED + 23)
    update_landed = not worker.is_alive()
    worker.join()
    up_wall = time.perf_counter() - t_up
    rec_c, resp_c, wall_c = serve_traffic(svc, ids, 8, SEED + 24)
    counts, graphs = warm_counts()
    snap = svc.metrics_snapshot()
    records, responses = rec_a + rec_b + rec_c, resp_a + resp_b + resp_c
    by_id = {r.request_id: r for r in responses}
    late_resp = by_id.pop(late.request_id, None)
    require(late_resp is not None and late_resp.error_reason == "deadline_exceeded",
            f"[serve] the expired request: {late_resp}")
    wall = wall_a + wall_b + wall_c
    require(len(records) == SERVE_REQUESTS and all(by_id[r.request_id].ok for r in records),
            "[serve] a request failed")
    require(snap["compiles"]["after_warmup"] == 0,
            f"[serve] builds or captures after warmup: {snap['compiles']}")
    require(snap["cold_restarts"]["after_warmup"] == 0,
            f"[serve] cold restarts after warmup: {snap['cold_restarts']}")
    require(snap["cache"]["refactorizations"] == 1, f"[serve] refactorizations {snap['cache']}")
    versions = sorted({(r.matrix_id, r.expected_version) for r in records})
    p1_versions = (p1_v0, svc.cache.entry("p1").version)
    require(all(("p1", v) in versions for v in p1_versions),
            f"[serve] the traffic did not see both versions {p1_versions} of p1: {versions}")
    up_bind = svc.cache.entry("p1").binding.bound_seconds
    say(f"[serve] {SERVE_REQUESTS} requests of 4 tenants over {len(mats)} matrices in "
        f"{wall:.3f} s = {SERVE_REQUESTS / wall:.2f} solves/s ({snap['ticks']} ticks); "
        f"value update of p1 in the background: refactor {factor_s[-1]:.3f} s + bind "
        f"{up_bind:.3f} s, landed {'during' if update_landed else 'after'} the 16 requests "
        f"after it ({up_wall:.3f} s of wall to the join)")
    co = snap["coalescing"]
    say(f"[serve] batches {co['batches']}, solved lanes {co['solved_lanes']}, padded lanes "
        f"{co['padded_lanes']}, occupancy mean {co['occupancy_mean']:.3f} min "
        f"{co['occupancy_min']:.3f}; rejected {json.dumps(snap['requests']['rejected_by_reason'])}"
        f"; robustness {json.dumps(snap['robustness'])}")
    for tenant, h in snap["tenants"].items():
        say(f"[serve] tenant {tenant}: {h['count']} responses, p50 {h['p50_seconds']:.4f} s, "
            f"p99 {h['p99_seconds']:.4f} s, max {h['max_seconds']:.4f} s")
    say(f"[serve] compiles {json.dumps(snap['compiles'])} (captures at warmup "
        f"{ev1['captures'] - ev0['captures']}, after it "
        f"{engine_events()['captures'] - ev1['captures']}); cold restarts "
        f"{json.dumps(snap['cold_restarts'])}; engines shared {snap['cache']['engines_shared']}; "
        f"graph replays {graphs['replays']}")
    check_launches("serve", counts, ("spmv_ell", "tri_solve_wavefront", "factor_wavefront"),
                   idle=("inverse_chain", "epoch_sweep", "superstep_factor"))

    # the value slots: copies per batch and their device time
    eng = svc.cache.entry("p0").engine
    loads = sum(e.loads for e in engines.values())
    copies = sum(e.load_copies for e in engines.values())
    resident = eng._resident
    fill_ms = device_ms_all(lambda: eng._fill(resident.value_args), reps=10)
    nbytes = sum(t.numel() * 4 for t in resident.value_args)
    say(f"[serve] value slots: {loads} refills in {co['batches']} batches ({copies} tensor "
        f"copies, {len(resident.value_args)} per refill of p0's engine, {nbytes / 1e6:.2f} MB); "
        f"device {fill_ms if fill_ms is None else round(fill_ms, 4)} ms per refill "
        f"({nbytes / HBM_BYTES_PER_S * 2e3:.4f} ms bound, bytes read and written)")

    # one profiled batch of 8 on p0
    rng = np.random.default_rng(SEED + 25)
    for i in range(8):
        svc.submit(f"t{i % 4}", "p0", rng.standard_normal(p0.n).astype(np.float32), tol=1e-5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = svc.tick()
        torch.cuda.synchronize()
        tick_wall = time.perf_counter() - t0
    busy = sum(us for _, us in kernel_events(prof)) / 1e6
    require(len(out) == 8 and all(r.ok for r in out), "[serve] the profiled batch failed")
    say(f"[profile serve] one batch of 8 on p0 under torch.profiler: wall {tick_wall:.3f} s, "
        f"{out[0].iterations} steps (lane 0), device busy {busy:.3f} s "
        f"({100 * busy / tick_wall:.1f}% of wall)")

    # the gate: a seeded sample against solo solves on fresh, warmed objects
    groups = {}
    for r in records:
        groups.setdefault((r.matrix_id, r.expected_version), []).append(r)
    pick = np.random.default_rng(SEED + 26)
    sample = [g[int(pick.integers(len(g)))] for g in (groups[k] for k in sorted(groups))]
    chosen = {id(r) for r in sample}
    rest = [r for r in records if id(r) not in chosen]
    sample += [rest[i] for i in pick.choice(len(rest), 6 - len(sample), replace=False)]
    fresh = {}
    for r in sample:
        key = (r.matrix_id, r.expected_version)
        if key not in fresh:
            base = {"p0": poisson_2d(nx), "cd": convection_diffusion_2d(nx_cd)}.get(r.matrix_id)
            if base is None:
                p = poisson_2d(nx)
                base = scaled(p, 1.25) if r.expected_version == p1_v0 else CSRMatrix(
                    n=p.n, indptr=p.indptr, indices=p.indices, data=update)
            warm_solve(base, k=1, batch_sizes=(1,), sharded=False, tol=r.tol, device=dev,
                       restart=30, maxiter=20)
            fresh[key] = base
        solo, _ = solve_with_ilu(fresh[key], r.b, k=1, tol=r.tol, device=dev, restart=30,
                                 maxiter=20)
        got = by_id[r.request_id]
        require(got.matrix_version == r.expected_version, "[serve] version mismatch")
        require(bits_equal(got.x, solo.x) and got.iterations == solo.iterations,
                f"[serve] response {r.request_id} ({r.matrix_id} v{r.expected_version}, bucket "
                f"{got.batch_lanes}) != its solo solve")
    names = ", ".join(f"{r.matrix_id} v{r.expected_version}" for r in sample)
    say(f"[serve] {len(sample)} sampled responses ({names}) "
        "bitwise equal to solo solve_with_ilu on fresh matrix objects warmed with warm_solve")
    return counts


def phase_serve_sharded(dev, nx=SERVE_SHARDED_NX):
    """[serve-sharded]: a SolveService over ShardedServeEngine, SHARDED_D
    band owners of BAND_ROWS-row bands on poisson_2d(nx), buckets (1, 4),
    warmed; 3 requests, a value update (x0.8, joined), 2 requests. Every
    response bitwise equal to the solo solve_sharded on its value version;
    no build or capture and no cold restart after warm-up."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded, warm_solve
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, SolveService

    a = poisson_2d(nx)
    svc = SolveService(ServeConfig(device=dev, k=1, restart=30, maxiter=20, buckets=(1, NB),
                                   sharded=True, n_devices=SHARDED_D, band_rows=BAND_ROWS))
    t0 = time.perf_counter()
    svc.register_matrix("s0", a)
    reg = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc.warmup()
    warm = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 27)
    bs = rng.standard_normal((5, a.n)).astype(np.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    first = [svc.submit(f"t{i}", "s0", bs[i], tol=TOL) for i in range(3)]
    out = svc.tick()
    update = (a.data * np.float32(0.8)).astype(np.float32)
    t1 = time.perf_counter()
    svc.update_matrix_values("s0", update, background=False)
    up = time.perf_counter() - t1
    second = [svc.submit(f"t{i}", "s0", bs[i], tol=TOL) for i in range(3, 5)]
    out += svc.tick()
    wall = time.perf_counter() - t0
    counts, graphs = warm_counts()
    snap = svc.metrics_snapshot()
    require(len(out) == 5 and all(r.ok for r in out), "[serve-sharded] a request failed")
    require(snap["compiles"]["after_warmup"] == 0 and snap["cold_restarts"]["after_warmup"] == 0,
            f"[serve-sharded] after warmup: {snap['compiles']} {snap['cold_restarts']}")
    check_launches("serve-sharded", counts, ("spmv_ell", "epoch_sweep", "superstep_factor"),
                   idle=("tri_solve_wavefront", "inverse_chain"))
    by_id = {r.request_id: r for r in out}
    a2 = CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices, data=update)
    for mat, reqs, version in ((poisson_2d(nx), first, 1), (a2, second, 2)):
        warm_solve(mat, k=1, batch_sizes=(1,), n_devices=SHARDED_D, band_rows=BAND_ROWS, tol=TOL,
                   device=dev, restart=30, maxiter=20)
        for req in reqs:
            solo, _ = solve_sharded(mat, req.b, k=1, n_devices=SHARDED_D, band_rows=BAND_ROWS,
                                    tol=TOL, device=dev, restart=30, maxiter=20)
            got = by_id[req.request_id]
            require(got.matrix_version == version and bits_equal(got.x, solo.x)
                    and got.iterations == solo.iterations,
                    f"[serve-sharded] response {req.request_id} != solo solve_sharded "
                    f"(v{version})")
    say(f"[serve-sharded] poisson_2d({nx}) over {SHARDED_D} owners: register {reg:.3f} s, "
        f"warmup {warm:.3f} s, 5 requests and one value update (refactor + bind {up:.3f} s) "
        f"in {wall:.3f} s, {snap['coalescing']['batches']} batches, {graphs['replays']} graph "
        f"replays; compiles {json.dumps(snap['compiles'])}, cold restarts "
        f"{json.dumps(snap['cold_restarts'])}; every response bitwise equal to the solo "
        "solve_sharded on its value version")
    return counts


def llm_decode(cfg, model, feed, gen, timed=False, frames=None):
    """Serve ``feed.shape[0]`` requests through make_serve_step: the tokens of
    ``feed`` (B, P) one per step, then ``gen`` greedy tokens (whisper: the
    cache's cross K/V filled from ``frames`` by precompute_cross_kv first).
    Returns the tokens fed (B, P + gen), the logits of every step as float32
    (B, P + gen, V) and, if ``timed``, the host ms of each step (each ends in
    a synchronize)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.train.step import make_serve_step

    serve = make_serve_step(cfg)
    B, P = feed.shape
    cache = M.init_cache(cfg, B, LLM_CACHE, device=feed.device)
    if frames is not None:
        cache = M.precompute_cross_kv(cfg, model, cache, frames)
    fed, logits, ms = [], [], []
    tok = feed[:, :1]
    for t in range(P + gen):
        if t < P:
            tok = feed[:, t:t + 1]
        fed.append(tok)
        t0 = time.perf_counter()
        tok, out, cache = serve(model, cache, tok)
        if timed:
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out[:, 0].float())
    return torch.cat(fed, 1), torch.stack(logits, 1), ms


def llm_parity(cfg, dec, full):
    """Teacher-forced parity of decode logits against the forward's on the
    same tokens: the max log-softmax error over vocab_real, and the
    positions where the forward's top-2 gap exceeds twice that error, at
    each of which the two argmaxes must agree. Returns (error, positions
    checked, argmax disagreements there)."""
    import torch

    V = cfg.vocab_real
    d, f = dec[..., :V].double(), full[..., :V].double()
    err = float((torch.log_softmax(d, -1) - torch.log_softmax(f, -1)).abs().max())
    top2 = torch.topk(f, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * err
    bad = int(((d.argmax(-1) != f.argmax(-1)) & sure).sum())
    return err, int(sure.sum()), bad


def llm_f32_parity(tag, cfg, model, prompt, phase="llm-serve", frames=None):
    """[llm-serve] float32 parity: LLM_GEN greedy tokens after ``prompt``,
    held against one forward over every token fed, teacher-forced (whisper:
    the forward's encoder and the decode's cross K/V from ``frames``).
    Returns the tokens fed and the forward's logits."""
    import torch

    from repro_torch.models import model as M

    fed, dec, _ = llm_decode(cfg, model, prompt, LLM_GEN, frames=frames)
    batch = {"tokens": fed} if frames is None else {"tokens": fed, "frames": frames}
    with torch.no_grad():
        full = M.forward(cfg, model, batch).float()
    require(bool(torch.isfinite(dec).all() and torch.isfinite(full).all()),
            f"[{phase}] {tag}: non-finite logits")
    require(dec.grad_fn is None and full.grad_fn is None and not dec.requires_grad,
            f"[{phase}] {tag}: serving built an autograd graph")
    err, checked, bad = llm_parity(cfg, dec, full)
    say(f"[{phase}] {tag} float32, q_chunk = kv_chunk = {cfg.q_chunk}: {fed.shape[0]} requests"
        f" x ({prompt.shape[1]} prompt + {LLM_GEN} greedy) steps; decode against forward "
        f"(teacher-forced): max log-softmax error {err:.3e} (gate {LLM_F32_GATE}; "
        f"test_decode_consistency's bound {LLM_LSM_BOUND}), argmax equal"
        f" at {checked - bad} of the {checked} positions (of {fed.numel()}) whose top-2 gap "
        f"exceeds 2x the error")
    require(err <= min(LLM_F32_GATE, LLM_LSM_BOUND),
            f"[{phase}] {tag}: log-softmax error {err:.3e}")
    require(bad == 0, f"[{phase}] {tag}: {bad} argmax disagreements past the top-2 gap")
    return fed, full


def nbytes(tree):
    """Bytes of the tensors in a nested dict / list / tuple (a cache)."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def llm_bf16(phase, dev, name, cfg, seed, fed, prefill_s, rng, frames=None):
    """bf16 serving of ``cfg``, drawn on the card from ``seed`` (the float32
    run's weights rounded where the seed is the same): the tokens of ``fed``
    (B, P) fed one per step after a warm run, ms per decode step, one
    profiled step, and a prefill of ``prefill_s`` seeded tokens (timed, then
    profiled once); whisper's cache filled from ``frames`` first. Returns the
    model, the decode's float32 logits (B, P, V) and the parameter count."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.train.step import make_prefill_step, make_serve_step

    t0 = time.perf_counter()
    model = M.Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    torch.cuda.synchronize()
    drawn = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    enc = ""
    if frames is not None:
        frames = frames.to(cfg.act_dtype)
        enc_ms = time_ms(lambda: M.precompute_cross_kv(
            cfg, model, M.init_cache(cfg, LLM_B, LLM_CACHE, device=dev), frames), reps=3)
        enc = (f"; precompute_cross_kv (encoder over {frames.shape[1]} frames + every layer's "
               f"cross K/V) {enc_ms:.2f} ms")
    llm_decode(cfg, model, fed[:, :4], 0, frames=frames)  # warm: cuBLAS handles, the allocator
    _, dec, ms = llm_decode(cfg, model, fed, 0, timed=True, frames=frames)
    toks = dec[..., :cfg.vocab_real].argmax(-1)
    require(bool(torch.isfinite(dec).all()), f"[{phase}] {name} bf16: non-finite logits")
    require(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_real,
            f"[{phase}] {name} bf16: a token outside [0, vocab_real)")
    step_ms = statistics.median(ms[1:])
    serve = make_serve_step(cfg)
    cache = M.init_cache(cfg, LLM_B, LLM_CACHE, device=dev)
    if frames is not None:
        cache = M.precompute_cross_kv(cfg, model, cache, frames)
    tok, _, cache = serve(model, cache, fed[:, :1])
    wall, launches, busy = profile_launches(lambda: serve(model, cache, tok))
    weights_mb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e6
    say(f"[{phase}] {name} bf16 ({cfg.n_layers} layers, {n_params} parameters, weights "
        f"{weights_mb:.1f} MB, cache of {LLM_CACHE} slots {nbytes(cache) / 1e6:.1f} MB, drawn on "
        f"the card in {drawn:.2f} s): {LLM_B} requests x {fed.shape[1]} steps, {step_ms:.3f} ms "
        f"per decode step (median of {len(ms) - 1} after a warm one; min {min(ms[1:]):.3f}, max "
        f"{max(ms[1:]):.3f}), {LLM_B * 1e3 / step_ms:.1f} tokens/s{enc}")
    say(f"[profile {phase}] {name} one bf16 decode step under torch.profiler: wall {wall:.3f} "
        f"ms, {launches} kernel launches, device busy {busy:.3f} ms ({100 * busy / wall:.1f}% "
        "of wall)")
    del cache
    if prefill_s:
        prefill = make_prefill_step(cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab_real, (LLM_B, prefill_s), generator=rng,
                                         device=dev, dtype=torch.int32)}
        if frames is not None:
            batch["frames"] = frames
        last = prefill(model, batch)
        require(bool(torch.isfinite(last).all()) and last.shape == (LLM_B, cfg.vocab),
                f"[{phase}] {name} bf16 prefill malformed")
        pre_ms = time_ms(lambda: prefill(model, batch), reps=2)
        pwall, plaunch, pbusy = profile_launches(lambda: prefill(model, batch))
        say(f"[{phase}] {name} bf16 prefill (make_prefill_step) B = {LLM_B}, S = {prefill_s}, "
            f"chunks {cfg.q_chunk}: {pre_ms:.2f} ms ({LLM_B * prefill_s * 1e3 / pre_ms:.0f} "
            f"tokens/s); profiled once: {plaunch} kernel launches, device busy {pbusy:.2f} ms "
            f"of {pwall:.2f} ({100 * pbusy / pwall:.1f}%)")
    return model, dec, n_params


def llm_bf16_parity(phase, tag, cfg, dec, full32):
    """Print (not gated) the teacher-forced parity of a bf16 decode's logits
    ``dec`` against the float32 forward's ``full32`` on the same tokens and
    the same weights rounded: the reading above LLM_F32_GATE, as the float32
    decode's is the one below it. Also the median over positions of each
    position's max error: a router near-tie that bf16 flips moves one
    position by O(1) and sets the max alone."""
    import torch

    err, checked, bad = llm_parity(cfg, dec, full32)
    V = cfg.vocab_real
    per_pos = (torch.log_softmax(dec[..., :V].double(), -1)
               - torch.log_softmax(full32[..., :V].double(), -1)).abs().amax(-1)
    say(f"[{phase}] {tag} bf16 decode against the float32 teacher-forced logits (not gated): "
        f"max log-softmax error {err:.3e} (median over positions {float(per_pos.median()):.3e}),"
        f" argmax disagreements {bad} of {checked} sure positions")


def llm_card_vs_cpu(phase, dev, names, seed):
    """Card against CPU: each config of ``names`` reduced, the same weights
    on both (drawn on the CPU from ``seed`` + its index); the forward over 2 x
    40 seeded tokens (whisper: with 2 x encoder_seq seeded frames) and 8
    decode steps within LLM_CPU_REL of max|logits|."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    for k, name in enumerate(names):
        c = get_config(name).reduced()
        cpu = M.Transformer(c, generator=torch.Generator().manual_seed(seed + k), device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        g = torch.Generator().manual_seed(seed + 10 + k)
        toks = torch.randint(0, c.vocab_real, (2, 40), generator=g, dtype=torch.int32)
        batch = {"tokens": toks}
        if c.family == "audio":
            batch["frames"] = torch.randn((2, c.encoder_seq, c.d_model), generator=g) * 0.02
        frames = batch.get("frames")
        with torch.no_grad():
            want = M.forward(c, cpu, batch)
            got = M.forward(c, card, {k2: v.to(dev) for k2, v in batch.items()}).cpu()
        _, want_dec, _ = llm_decode(c, cpu, toks[:, :8], 0, frames=frames)
        _, got_dec, _ = llm_decode(c, card, toks[:, :8].to(dev), 0,
                                   frames=None if frames is None else frames.to(dev))
        e_fwd = float((got - want).abs().max() / want.abs().max())
        e_dec = float((got_dec.cpu() - want_dec).abs().max() / want_dec.abs().max())
        say(f"[{phase}] card against CPU, {name} reduced: forward max|diff| / max|logits| "
            f"{e_fwd:.2e}, 8 decode steps {e_dec:.2e} (bound {LLM_CPU_REL})")
        require(e_fwd <= LLM_CPU_REL and e_dec <= LLM_CPU_REL,
                f"[{phase}] card against CPU, {name}: {e_fwd:.2e} / {e_dec:.2e}")


def phase_llm_serve(dev):
    """[llm-serve]: the model scaffolding's serving path (repro_torch.models,
    repro_torch.train.step) on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train.step import make_prefill_step

    require(not torch.backends.cuda.matmul.allow_tf32, "[llm-serve] float32 checks need TF32 off")
    arch = LLM_ARCH
    f32 = dict(param_dtype=torch.float32, act_dtype=torch.float32, q_chunk=LLM_CHUNK,
               kv_chunk=LLM_CHUNK)
    ops.reset_launch_counts()
    # (a) the full-size config in float32
    cfg = dataclasses.replace(get_config(arch), **f32)
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    t0 = time.perf_counter()
    model = M.Transformer(cfg, generator=g, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[llm-serve] {arch}: {cfg.n_layers} layers, d = {cfg.d_model}, {cfg.n_heads}:"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_real} (padded {cfg.vocab})"
        f", {n_params} parameters ({cfg.param_count()['total']} by param_count), drawn on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    rng = torch.Generator(device=dev).manual_seed(SEED + 41)
    prompt = torch.randint(0, cfg.vocab_real, (LLM_B, LLM_PROMPT), generator=rng, device=dev,
                           dtype=torch.int32)
    fed, full32 = llm_f32_parity(arch, cfg, model, prompt)
    del model
    # (b) the config's own bf16, the same weights rounded, the same tokens
    cfg16 = get_config(arch)
    model, dec16, _ = llm_bf16("llm-serve", dev, arch, cfg16, SEED + 40, fed, LLM_PREFILL_S, rng)
    llm_bf16_parity("llm-serve", arch, cfg16, dec16, full32)
    del model, full32, dec16
    # the other dense / vlm configs: full width, LLM_WIDE_LAYERS layers, float32
    for name in LLM_WIDE:
        c = dataclasses.replace(get_config(name), n_layers=LLM_WIDE_LAYERS, **f32)
        m = M.Transformer(c, generator=torch.Generator(device=dev).manual_seed(SEED + 42),
                          device=dev)
        p = torch.randint(0, c.vocab_real, (LLM_B, LLM_PROMPT), generator=rng, device=dev,
                          dtype=torch.int32)
        llm_f32_parity(f"{name} ({c.n_layers} layers, d = {c.d_model})", c, m, p)
        if c.family == "vlm":
            ve = torch.randn((LLM_B, c.vision_patches, c.d_model), generator=rng, device=dev)
            lg = make_prefill_step(c)(m, {"tokens": p.repeat(1, c.vision_patches // LLM_PROMPT
                                                           + 1), "vision_embeds": ve * 0.02})
            require(bool(torch.isfinite(lg).all()), f"[llm-serve] {name}: vision merge "
                    "gave non-finite logits")
            say(f"[llm-serve] {name}: prefill with {c.vision_patches} vision embeddings merged:"
                " finite logits")
        del m
    torch.cuda.empty_cache()
    llm_card_vs_cpu("llm-serve", dev, (arch, "starcoder2-15b"), SEED + 43)
    counts, _ = warm_counts()
    check_launches("llm-serve", counts, (), idle=tuple(counts))
    return counts


def phase_llm_families(dev):
    """[llm-families]: the serving path of the MoE + MLA, hybrid SSM, xLSTM
    and encoder-decoder families (repro_torch.models, repro_torch.train.step)
    on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    require(not torch.backends.cuda.matmul.allow_tf32,
            "[llm-families] float32 checks need TF32 off")
    ops.reset_launch_counts()
    rng = torch.Generator(device=dev).manual_seed(SEED + 60)

    def full_capacity(c):
        return dataclasses.replace(c, moe_capacity_factor=float(c.n_routed_experts)) \
            if c.n_routed_experts else c

    def f32(c, chunks=True):
        chunk = dict(q_chunk=LLM_CHUNK, kv_chunk=LLM_CHUNK) if chunks else {}
        return dataclasses.replace(full_capacity(c), param_dtype=torch.float32,
                                   act_dtype=torch.float32, **chunk)

    def frames_for(c):
        if c.family != "audio":
            return None
        return torch.randn((LLM_B, c.encoder_seq, c.d_model), generator=rng, device=dev) * 0.02

    def f32_parity(tag, c, seed, frames=None):
        m = M.Transformer(c, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
        p = torch.randint(0, c.vocab_real, (LLM_B, LLM_PROMPT), generator=rng, device=dev,
                          dtype=torch.int32)
        fed, full32 = llm_f32_parity(tag, c, m, p, phase="llm-families", frames=frames)
        del m
        torch.cuda.empty_cache()
        return fed, full32

    # (a) deepseek-v2-lite-16b: float32 parity at full width and few layers (and the
    # bf16 decode of those layers against it), then the published 27 layers in bf16
    arch = LLM_FAMILY_ARCH
    cfg = get_config(arch)
    few = dataclasses.replace(cfg, n_layers=LLM_FAMILY_F32_LAYERS)
    fed, full32 = f32_parity(f"{arch} ({few.n_layers} layers, d = {few.d_model}, "
                             f"{few.n_routed_experts} routed + {few.n_shared_experts} shared "
                             f"experts, top-{few.moe_top_k}, MLA r = {few.mla_kv_lora})",
                             f32(few), SEED + 61)
    c16 = full_capacity(few)
    m = M.Transformer(c16, generator=torch.Generator(device=dev).manual_seed(SEED + 61),
                      device=dev)
    _, dec, _ = llm_decode(c16, m, fed, 0)
    llm_bf16_parity("llm-families", f"{arch} ({few.n_layers} layers)", c16, dec, full32)
    del m, dec, full32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, _, n = llm_bf16("llm-families", dev, arch, cfg, SEED + 61, fed, LLM_PREFILL_S, rng)
    del model
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"[llm-families] {arch} at its published size: {n} parameters "
        f"({cfg.param_count()['total']} by param_count), peak memory allocated {peak:.2f} GiB")
    # (b) the other configs: float32 parity, then bf16 ms per step and the bf16
    # decode's parity against the float32 forward (at the float32 run's capacity)
    for k, (name, layers) in enumerate(LLM_FAMILY_OTHERS):
        base = get_config(name)
        if layers:
            base = dataclasses.replace(base, n_layers=layers)
        frames = frames_for(base)
        fed, full32 = f32_parity(f"{name} ({base.n_layers} layers, d = {base.d_model})",
                                 f32(base, chunks=base.family != "audio"),  # whisper: its own
                                 SEED + 62 + k, frames=frames)
        prefill_s = LLM_RECURRENT_PREFILL_S if base.family in ("hybrid", "ssm") else None
        model, dec, _ = llm_bf16("llm-families", dev, name, base, SEED + 62 + k, fed, prefill_s,
                                 rng, frames=frames)
        if base.n_routed_experts:
            c16 = full_capacity(base)
            _, dec, _ = llm_decode(c16, model, fed, 0)
        llm_bf16_parity("llm-families", name, base, dec, full32)
        del model, dec, full32
        torch.cuda.empty_cache()
    # (c) card against CPU: each reduced config, the same weights on both
    llm_card_vs_cpu("llm-families", dev, (arch,) + tuple(n for n, _ in LLM_FAMILY_OTHERS),
                    SEED + 70)
    counts, _ = warm_counts()
    check_launches("llm-families", counts, (), idle=tuple(counts))
    return counts


def leaf_errors(got, want):
    """Per leaf of two JAX-layout trees (``convert.keyed_leaves``): (key,
    max|diff|, max|want|, entries beyond LLM_TRAIN_REL·max|want|, size),
    computed on ``got``'s device."""
    from repro_torch.models.convert import keyed_leaves

    out = []
    for (key, a), (_, b) in zip(keyed_leaves(got), keyed_leaves(want)):
        a = a.detach().float()
        b = b.detach().float().to(a.device)
        err, scale = (a - b).abs(), float(b.abs().max())
        out.append((key, float(err.max()), scale, int((err > LLM_TRAIN_REL * scale).sum()),
                    err.numel()))
    return out


def train_grads(cfg, model, batch):
    """(loss, the gradient of loss_fn at ``model``'s parameters in the
    model's tree), as make_train_step takes them with one microbatch."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.convert import flatten, param_tree, unflatten
    from repro_torch.train.step import batch_to

    params = param_tree(M.trainable(model))
    with torch.enable_grad():
        loss = M.loss_fn(cfg, model, batch_to(batch, model.device))
        grads = torch.autograd.grad(loss, flatten(params))
    return loss.detach(), unflatten(params, grads)


def grad_leaves_differing(a, b):
    """Keys of the leaves of two JAX-layout gradient trees that differ in
    any bit."""
    import torch

    from repro_torch.models.convert import keyed_leaves

    return [k for (k, x), (_, y) in zip(keyed_leaves(a), keyed_leaves(b))
            if not torch.equal(x.view(torch.int32), y.view(torch.int32))]


def caught_train_step(cfg, opt, model, batch):
    """One step of make_train_step(cfg, opt) on ``model`` (one microbatch,
    from a fresh optimizer state, in place), with the gradient that the step
    hands to adamw.update caught on its way: (loss, grad_norm, lr, that
    gradient in the model's tree)."""
    from repro_torch.models.convert import param_tree
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    seen, real = [], adamw.update

    def update(c, grads, state, params):
        seen.append(grads)
        return real(c, grads, state, params)

    adamw.update = update
    try:
        _, _, m = make_train_step(cfg, opt)(model, adamw.init(param_tree(model)), batch)
    finally:
        adamw.update = real
    return float(m["loss"]), float(m["grad_norm"]), float(m["lr"]), seen[0]


def llm_train_f32(dev, tag, cfg, batch, phase="llm-train", seed=SEED + 50):
    """[phase] (a): one float32 step of make_train_step on the card and on
    the CPU, from the same weights (drawn on the card from ``seed``) and
    ``batch`` (numpy; whisper's with its frames). The losses agree within
    LLM_TRAIN_LOSS_REL; the gradients that the two steps hand to
    adamw.update agree per leaf within LLM_TRAIN_REL·max|g|, every entry.
    The update is held apart: the CPU's gradient goes through adamw.update
    on the card from the same start, and those parameters agree with the
    CPU step's within LLM_TRAIN_REL·max|p| but for at most
    LLM_TRAIN_OUTLIERS entries in all, each within 2·lr. (The card step's
    own parameters are printed against the CPU's, not gated: AdamW's first
    step g/(|g| + eps) turns a gradient difference far inside the gradient
    bound into up to 2·lr where the clipped gradient is near eps.) A second
    backward on the card, at the same parameters, must give the step's
    gradient bits: for the time scans' families (hymba, xLSTM) with the
    scans unchunked (``scan_utils.REMAT_CHUNK`` = 1); for the others the
    same computation again, and the leaves that differ are printed."""
    import copy

    import torch

    from repro_torch.models import model as M
    from repro_torch.models import scan_utils
    from repro_torch.models.convert import (flatten, keyed_leaves, param_tree, tree_to_jax,
                                            unflatten)
    from repro_torch.optim import adamw

    opt = adamw.AdamWConfig(lr=LLM_TRAIN_LR, warmup_steps=LLM_TRAIN_WARMUP, total_steps=100)
    t_all = time.perf_counter()
    card = M.Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    cpu = copy.deepcopy(card).to("cpu")
    t_draw = time.perf_counter() - t_all
    B, S = batch["tokens"].shape
    t0 = time.perf_counter()
    l0, g0, lr0, gcpu = caught_train_step(cfg, opt, cpu, batch)
    s0 = time.perf_counter() - t0
    d0, p0 = tree_to_jax(gcpu), tree_to_jax(param_tree(cpu))
    del cpu
    t0 = time.perf_counter()
    scans = cfg.family in ("ssm", "hybrid")
    chunk = scan_utils.REMAT_CHUNK
    if scans:
        scan_utils.REMAT_CHUNK = 1
    try:
        again = tree_to_jax(train_grads(cfg, card, batch)[1])
    finally:
        scan_utils.REMAT_CHUNK = chunk
    start = unflatten(param_tree(card), [t.detach().clone() for t in flatten(param_tree(card))])
    l1, g1, lr1, gcard = caught_train_step(cfg, opt, card, batch)
    s1 = time.perf_counter() - t0
    d1 = tree_to_jax(gcard)
    del gcard
    differ = grad_leaves_differing(d1, again)
    n_leaves = len(keyed_leaves(d1))
    del again
    if scans:
        say(f"[{phase}] (a) {tag}: the card step's gradient with chunked time scans (chunks of "
            f"{scan_utils.chunk_size(S, chunk)}) against the plain loop's: {len(differ)} of "
            f"{n_leaves} leaves differ in any bit"
            + (f" ({', '.join(differ)})" if differ else "") + " (bound 0)")
        require(not differ, f"[{phase}] (a) {tag}: chunking changed the gradient of {differ}")
    else:
        say(f"[{phase}] (a) {tag}: two identical backward passes on the card differ in "
            f"{len(differ)} of {n_leaves} leaves" + (f" ({', '.join(differ)})" if differ else "")
            + " (not gated)")
    # the update alone: the CPU's gradient through adamw.update on the card, from the start
    adamw.update(opt, unflatten(start, [g.to(dev) for g in flatten(gcpu)]),
                 adamw.init(start), start)
    del gcpu
    t_cmp = time.perf_counter()
    g_errs = leaf_errors(d1, d0)
    del d1, d0
    p_errs = leaf_errors(tree_to_jax(start), p0)
    del start
    own = sum(e[3] for e in leaf_errors(tree_to_jax(param_tree(card)), p0))
    t_cmp = time.perf_counter() - t_cmp
    g_worst = max(g_errs, key=lambda e: e[1] / e[2])
    p_worst = max(p_errs, key=lambda e: e[1] / e[2])
    g_beyond, p_beyond = sum(e[3] for e in g_errs), sum(e[3] for e in p_errs)
    p_cap = max(e[1] for e in p_errs)
    size = sum(e[4] for e in p_errs)
    say(f"[{phase}] (a) {tag} float32, remat {cfg.remat}, B = {B}, S = {S}: make_train_step on "
        f"the card ({s1:.2f} s with the second backward) and the CPU ({s0:.2f} s): loss "
        f"{l1:.7f} / {l0:.7f} (rel {abs(l1 - l0) / abs(l0):.2e}, bound {LLM_TRAIN_LOSS_REL}), "
        f"grad_norm {g1:.6f} / {g0:.6f} (rel {abs(g1 - g0) / g0:.2e}), lr {lr1:.3e}")
    say(f"[{phase}] (a) {tag} the steps' gradients: worst leaf {g_worst[0]} max|diff| "
        f"{g_worst[1]:.3e} = {g_worst[1] / g_worst[2]:.2e} x max|g|; {g_beyond} of {size} "
        f"entries beyond {LLM_TRAIN_REL} x max|g| of their leaf (bound 0)")
    say(f"[{phase}] (a) {tag} the CPU's gradient through adamw.update on the card against the "
        f"CPU step: worst leaf {p_worst[0]} max|diff| {p_worst[1]:.3e} = "
        f"{p_worst[1] / p_worst[2]:.2e} x max|p|; {p_beyond} of {size} entries beyond "
        f"{LLM_TRAIN_REL} x max|p| of their leaf (bound {LLM_TRAIN_OUTLIERS} in all), max|diff| "
        f"{p_cap:.3e} (bound 2 x lr = {2 * lr0:.3e}); the card step's own parameters: {own} "
        "entries beyond (not gated)")
    say(f"[time] {phase} (a) {tag}: {time.perf_counter() - t_all:.1f} s (weights drawn on the "
        f"card and copied to the CPU {t_draw:.1f} s, the comparisons {t_cmp:.1f} s)")
    require(abs(l1 - l0) <= LLM_TRAIN_LOSS_REL * abs(l0), f"[{phase}] (a) {tag} loss, card != CPU")
    require(abs(g1 - g0) <= LLM_TRAIN_REL * g0, f"[{phase}] (a) {tag} grad_norm, card != CPU")
    require(g_beyond == 0, f"[{phase}] (a) {tag} gradients, card != CPU: "
            + ", ".join(f"{k} {n} entries" for k, _, _, n, _ in g_errs if n))
    require(p_beyond <= LLM_TRAIN_OUTLIERS and p_cap <= 2 * lr0,
            f"[{phase}] (a) {tag} parameters, card != CPU: {p_beyond} entries beyond the bound, "
            f"max|diff| {p_cap:.3e}")


def llm_pipe_body(group, arch, seed):
    """[llm-train] (d), on each rank: the rank's stage of the full-size
    float32 stack (weights drawn from ``seed`` on the card, as every rank
    and the sequential run draw them), the pipelined forward and the
    gradients of sum(y²); and the sequential stack on the same card. A
    first forward and backward of one layer on a small input, timed on its
    own, pays the process's one-time costs (the CUDA libraries' set-up, the
    checkpoint's first imports) so that the timed runs are warm. Returns the
    worst relative errors and the walls."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.transformer import stack_forward
    from repro_torch.train.pipeline import make_pipelined_forward, stage_slice

    dev = group.device
    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.float32,
                              act_dtype=torch.float32)
    model = M.trainable(M.Transformer(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed), device=dev))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((LLM_PIPE_B, LLM_PIPE_S, cfg.d_model), generator=g, device=dev) * 0.1
    positions = torch.arange(LLM_PIPE_S, device=dev)
    sl = stage_slice(cfg.n_layers, group)
    stage = model.layers[sl]
    pipe = make_pipelined_forward(cfg, group, LLM_PIPE_MB)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    xw = x[:1, :16].clone().requires_grad_(True)
    yw = stack_forward(cfg, model.layers[:1], xw, positions[:16])
    torch.autograd.grad((yw ** 2).sum(), [xw] + list(model.layers[0].parameters()))
    sync()
    first_s = time.perf_counter() - t0
    out = {}
    for name, run in (("seq", lambda xx: stack_forward(cfg, model.layers, xx, positions)),
                      ("pipe_cold", lambda xx: pipe(stage, xx, positions)),
                      ("pipe", lambda xx: pipe(stage, xx, positions))):
        xx = x.clone().requires_grad_(True)
        sync()
        pipe.link.seconds = 0.0
        t0 = time.perf_counter()
        y = run(xx)
        sync()
        t1 = time.perf_counter()
        grads = torch.autograd.grad((y ** 2).sum(), [xx] + list(stage.parameters()))
        sync()
        out[name] = (y.detach(), grads, t1 - t0, time.perf_counter() - t1, pipe.link.seconds)
    ys, gs = out["seq"][:2]
    y_err = max(float((out[k][0] - ys).abs().max() / ys.abs().max()) for k in ("pipe_cold",
                                                                               "pipe"))
    g_err = max(float((a - b).abs().max() / b.abs().max())
                for k in ("pipe_cold", "pipe") for a, b in zip(out[k][1], gs))
    return dict(rank=group.rank, layers=(sl.start, sl.stop), y_err=y_err, g_err=g_err,
                first_s=first_s, walls={k: v[2:] for k, v in out.items()}, n_grads=len(gs))


def phase_llm_train(dev):
    """[llm-train]: the model scaffolding's training path on the card."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.ckpt import latest_step, restore
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.dist import run_ranks
    from repro_torch.models import model as M
    from repro_torch.models.convert import flatten, param_tree
    from repro_torch.optim import adamw
    from repro_torch.train.loop import train
    from repro_torch.train.pipeline import pipeline_bubble_fraction
    from repro_torch.train.step import make_train_step

    require(not torch.backends.cuda.matmul.allow_tf32, "[llm-train] float32 checks need TF32 off")
    arch = LLM_ARCH
    ops.reset_launch_counts()
    few = dataclasses.replace(get_config(arch), n_layers=LLM_TRAIN_F32_LAYERS,
                              param_dtype=torch.float32, act_dtype=torch.float32)
    llm_train_f32(dev, f"{arch}, d = {few.d_model}, {few.n_layers} layers", few,
                  SyntheticLM(few.vocab_real, LLM_TRAIN_F32_S, LLM_TRAIN_F32_B).batch_at(0))
    # (b) the published size in bf16 through the training loop, checkpoints every 10
    cfg = get_config(arch)
    opt = adamw.AdamWConfig(lr=LLM_TRAIN_LR, warmup_steps=LLM_TRAIN_WARMUP,
                            total_steps=LLM_TRAIN_STEPS)
    ckpt = tempfile.mkdtemp(prefix="llm_train_")
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train(cfg, n_steps=LLM_TRAIN_STEPS, opt_cfg=opt, ckpt_dir=ckpt,
                    save_every=LLM_TRAIN_SAVE, seed=SEED, log_every=LLM_TRAIN_SAVE,
                    seq_len=LLM_TRAIN_S, global_batch=LLM_TRAIN_B, device=dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = res.losses
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        ms = [t * 1e3 for t in res.step_seconds[1:]]
        step_ms = statistics.median(ms)
        tokens = LLM_TRAIN_B * LLM_TRAIN_S
        say(f"[llm-train] (b) {arch} at its published size ({cfg.n_layers} layers, d = "
            f"{cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab "
            f"{cfg.vocab_real}, tied head), bf16, remat {cfg.remat}, train.loop.train: "
            f"{LLM_TRAIN_STEPS} steps of B = {LLM_TRAIN_B} x S = {LLM_TRAIN_S} in {wall:.1f} s; "
            f"{step_ms:.1f} ms per step (median of {len(ms)} after the warm-up step of "
            f"{res.step_seconds[0] * 1e3:.1f} ms; min {min(ms):.1f}, max {max(ms):.1f}), "
            f"{tokens * 1e3 / step_ms:.0f} tokens/s; peak memory allocated {peak:.2f} GiB")
        say(f"[llm-train] (b) losses {' '.join(f'{v:.4f}' for v in losses)}; first-five mean "
            f"{first:.4f}, last-five mean {last:.4f}")
        require(all(math.isfinite(v) for v in losses), "[llm-train] (b) a loss is not finite")
        require(last < first, f"[llm-train] (b) the loss did not fall: {first:.4f} -> {last:.4f}")
        # (c) the last step's checkpoint restored into a fresh model equals the live state
        saved = sorted(d for d in os.listdir(ckpt) if d.startswith("step_"))
        require(latest_step(ckpt) == LLM_TRAIN_STEPS, f"[llm-train] (c) checkpoints {saved}")
        fresh = M.Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 51),
                              device=dev)
        live = (param_tree(res.model), res.opt_state)
        like = (param_tree(fresh), adamw.init(param_tree(fresh)))
        t0 = time.perf_counter()
        got, _ = restore(ckpt, LLM_TRAIN_STEPS, like, device=dev)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        pairs = list(zip(flatten(got), flatten(live)))
        bad = [i for i, (a, b) in enumerate(pairs)
               if a.dtype != b.dtype or a.device != b.device
               or not torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                  b.view(torch.int16) if b.dtype == torch.bfloat16 else b)]
        nbytes = sum(a.numel() * a.element_size() for a, _ in pairs)
        del got, fresh, like
        # ... and the loop resumed from the first checkpoint runs its next two steps as the
        # first run did
        resume = tempfile.mkdtemp(prefix="llm_resume_")
        step_dir = f"step_{LLM_TRAIN_SAVE:08d}"
        shutil.copytree(os.path.join(ckpt, step_dir), os.path.join(resume, step_dir))
        res2 = train(cfg, n_steps=LLM_TRAIN_SAVE + 2, opt_cfg=opt, ckpt_dir=resume,
                     save_every=10 ** 9, seed=SEED + 52, log_every=0, seq_len=LLM_TRAIN_S,
                     global_batch=LLM_TRAIN_B, device=dev)
        shutil.rmtree(resume, ignore_errors=True)
        want = losses[LLM_TRAIN_SAVE:LLM_TRAIN_SAVE + 2]
        rel = max(abs(a - b) / abs(b) for a, b in zip(res2.losses, want))
        say(f"[llm-train] (c) checkpoints {', '.join(saved)} (AsyncCheckpointer, atomic); step "
            f"{LLM_TRAIN_STEPS} restored into a fresh model and optimizer state on the card in "
            f"{t_restore:.2f} s: {len(pairs) - len(bad)} of {len(pairs)} leaves "
            f"({nbytes / 1e6:.1f} MB) bitwise equal to the live state; resumed from step "
            f"{res2.restored_from}: losses {' '.join(f'{v:.6f}' for v in res2.losses)} against "
            f"{' '.join(f'{v:.6f}' for v in want)} (max rel {rel:.2e}, bound {LLM_RESUME_REL})")
        require(not bad, f"[llm-train] (c) leaves {bad[:5]} differ after restore")
        require(res2.restored_from == LLM_TRAIN_SAVE and len(res2.losses) == 2,
                "[llm-train] (c) the resumed loop did not start from the checkpoint")
        require(rel <= LLM_RESUME_REL, f"[llm-train] (c) resumed losses off by {rel:.2e}")
        del res2
        # one profiled step of the full-size model
        step = make_train_step(cfg, opt)
        batch = SyntheticLM(cfg.vocab_real, LLM_TRAIN_S, LLM_TRAIN_B).batch_at(LLM_TRAIN_STEPS)
        model, state = res.model, res.opt_state
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model, state, m = step(model, state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        events = kernel_events(prof)
        kernels = [e for e in events if not e[0].startswith(("Memcpy", "Memset"))]
        busy = sum(us for _, us in events) / 1e6
        top = {}
        for name, us in kernels:
            key = name.split("<")[0].split("(")[0][:60]
            top[key] = top.get(key, 0.0) + us
        heavy = sorted(top.items(), key=lambda kv: -kv[1])[:5]
        say(f"[profile llm-train] one bf16 train step under torch.profiler: wall "
            f"{pwall * 1e3:.1f} ms, {len(kernels)} kernel launches ({len(events)} device events)"
            f", device busy {busy * 1e3:.1f} ms ({100 * busy / pwall:.1f}% of wall); heaviest "
            f"kernels (ms): " + "; ".join(f"{k} {v / 1e3:.1f}" for k, v in heavy))
        del res, model, state
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    # (d) the GPipe pipeline over ranks sharing the card
    t0 = time.perf_counter()
    outs = run_ranks(llm_pipe_body, LLM_PIPE_RANKS, "gloo", ["cuda"] * LLM_PIPE_RANKS,
                     timeout_s=600, args=(arch, SEED + 53))
    y_err = max(o["y_err"] for o in outs)
    g_err = max(o["g_err"] for o in outs)
    say(f"[llm-train] (d) {arch} float32, {cfg.n_layers} layers as a {LLM_PIPE_RANKS}-stage "
        f"GPipe pipeline over gloo ranks sharing the card (stages {[o['layers'] for o in outs]}"
        f"), B = {LLM_PIPE_B}, S = {LLM_PIPE_S}, {LLM_PIPE_MB} microbatches (bubble fraction "
        f"{pipeline_bubble_fraction(LLM_PIPE_RANKS, LLM_PIPE_MB):.2f}): output max|diff| = "
        f"{y_err:.2e} x max|y|, gradients (x and every layer's parameters, "
        f"{sum(o['n_grads'] for o in outs)} tensors) {g_err:.2e} x max|g| of the sequential "
        f"stack on the card (bound {LLM_PIPE_REL}); {time.perf_counter() - t0:.1f} s with the "
        "ranks' start")
    for o in outs:
        say(f"[llm-train] (d) rank {o['rank']}: first call (one layer, B = 1, S = 16) "
            f"{o['first_s']:.3f} s; forward / backward / in messages (s): "
            + "; ".join(f"{k} {f:.3f} / {b:.3f} / {m:.3f}" for k, (f, b, m) in o["walls"].items()))
    require(y_err <= LLM_PIPE_REL and g_err <= LLM_PIPE_REL,
            f"[llm-train] (d) pipeline off the sequential stack: {y_err:.2e} / {g_err:.2e}")
    counts, _ = warm_counts()
    check_launches("llm-train", counts, (), idle=tuple(counts))
    return counts


def family_batch(cfg, B, S, seed):
    """SyntheticLM's batch ``seed`` of B x S tokens (numpy), with B x
    encoder_seq seeded frame embeddings for whisper."""
    import numpy as np

    from repro_torch.data.pipeline import SyntheticLM

    batch = SyntheticLM(cfg.vocab_real, S, B).batch_at(seed)
    if cfg.family == "audio":
        batch["frames"] = (np.random.default_rng(seed).standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def moe_repeatability(dev, cfg, phase):
    """The standalone ``moe_ffn`` at ``cfg``'s width, forward and backward
    twice on the same inputs and cotangent (float32 and bf16): the
    gradients of x and of every router, expert and shared-expert leaf must
    agree bitwise."""
    import dataclasses

    import torch

    from repro_torch.models.convert import keyed_leaves
    from repro_torch.models.ffn import capacity, init_moe, moe_ffn

    for dt in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, param_dtype=dt, act_dtype=dt)
        g = torch.Generator(device=dev).manual_seed(SEED + 81)
        p = init_moe(c, g, dev)
        keyed = keyed_leaves(p)
        for _, t in keyed:
            t.requires_grad_(True)
        x = torch.randn((LLM_FT_MOE_B, LLM_FT_MOE_S, c.d_model), generator=g, device=dev,
                        dtype=dt).requires_grad_(True)
        w = torch.randn(x.shape, generator=g, device=dev, dtype=dt)
        leaves = [x] + [t for _, t in keyed]
        runs = [torch.autograd.grad((moe_ffn(p, x, c) * w).float().sum(), leaves)
                for _ in range(2)]
        names = ["x"] + [k for k, _ in keyed]
        view = torch.int16 if dt == torch.bfloat16 else torch.int32
        differ = [n for n, a, b in zip(names, *runs) if not torch.equal(a.view(view), b.view(view))]
        T = LLM_FT_MOE_B * LLM_FT_MOE_S
        say(f"[{phase}] (a) moe_ffn at {cfg.arch}'s width ({c.n_routed_experts} experts of "
            f"{c.d_expert}, top-{c.moe_top_k}, capacity {capacity(c, T)} slots for {T} tokens) "
            f"in {str(dt).split('.')[-1]}: two identical backward passes differ in {len(differ)} "
            f"of {len(names)} gradients" + (f" ({', '.join(differ)})" if differ else ""))
        require(not differ, f"[{phase}] moe_ffn gradients not repeatable: {differ}")
        del p, x, w, runs


def llm_train_bf16(dev, phase, name, cfg, B, S, steps, seed):
    """[phase] (b): ``cfg`` (its own bf16 and remat) drawn on the card from
    ``seed``; one warm-up step and ``steps`` timed steps of
    make_train_step on one seeded batch, the warm-up under the profiler.
    Every loss finite, the last below the first. Returns the peak GiB of
    the steps."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.convert import param_tree
    from repro_torch.optim import adamw
    from repro_torch.train.step import batch_to, make_train_step

    torch.cuda.empty_cache()
    model = M.Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = sum(t.numel() for t in model.parameters())
    batch = batch_to(family_batch(cfg, B, S, seed), dev)
    state = adamw.init(param_tree(model))
    step = make_train_step(cfg, adamw.AdamWConfig(lr=LLM_FT_LR, warmup_steps=1,
                                                  total_steps=100))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    # the warm-up step runs under the profiler (launches and busy share), the rest timed
    wall, launches, busy = profile_launches(
        lambda: losses.append(float(step(model, state, batch)[2]["loss"])))
    for _ in range(steps):
        t0 = time.perf_counter()
        _, _, m = step(model, state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(ms)
    say(f"[{phase}] (b) {name} bf16 ({cfg.n_layers} layers, d = {cfg.d_model}, {n_params} "
        f"parameters), remat {cfg.remat}, B = {B} x S = {S}: {step_ms:.1f} ms per step (median "
        f"of {steps} after the warm-up; min {min(ms):.1f}, max {max(ms):.1f}), "
        f"{B * S * 1e3 / step_ms:.0f} tokens/s; peak memory allocated {peak:.2f} GiB; losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    say(f"[profile {phase}] {name} the warm-up bf16 train step under torch.profiler (the card's "
        f"activity alone): wall "
        f"{wall:.1f} ms, {launches} kernel launches, device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}% of wall)")
    require(all(math.isfinite(v) for v in losses), f"[{phase}] (b) {name}: a loss is not finite")
    require(losses[-1] < losses[0],
            f"[{phase}] (b) {name}: the loss did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    del model, state, batch
    return peak


def phase_llm_families_train(dev):
    """[llm-families-train]: training of the MoE + MLA, hybrid SSM, xLSTM
    and encoder-decoder families (loss_fn, the backward with layer remat and
    chunked time scans, make_train_step) on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    phase = "llm-families-train"
    require(not torch.backends.cuda.matmul.allow_tf32, f"[{phase}] float32 checks need TF32 off")
    ops.reset_launch_counts()
    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60)
    say(f"[{phase}] host memory (free -g): " + " | ".join(
        " ".join(line.split()) for line in free.stdout.strip().splitlines()))
    # (a) float32 card against CPU, one train step of each family at full width
    for k, (name, changes, B, S) in enumerate(LLM_FT_F32):
        cfg = dataclasses.replace(get_config(name), param_dtype=torch.float32,
                                  act_dtype=torch.float32, **changes)
        if cfg.n_routed_experts:
            cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_routed_experts))
            t0 = time.perf_counter()
            moe_repeatability(dev, get_config(name), phase)
            say(f"[time] {phase} (a) moe_ffn repeatability: {time.perf_counter() - t0:.1f} s")
        layout = (f"blocks {''.join(cfg.block_types)}" if cfg.block_types
                  else f"{cfg.n_layers} layers")
        llm_train_f32(dev, f"{name} (d = {cfg.d_model}, {layout})", cfg,
                      family_batch(cfg, B, S, k), phase=phase, seed=SEED + 80 + k)
        torch.cuda.empty_cache()
    # (b) bf16 train steps at full width, timed
    for k, (name, changes, B, S, steps) in enumerate(LLM_FT_BF16):
        cfg = dataclasses.replace(get_config(name), **changes)
        t0 = time.perf_counter()
        peak = llm_train_bf16(dev, phase, name, cfg, B, S, steps, SEED + 90 + k)
        say(f"[time] {phase} (b) {name}: {time.perf_counter() - t0:.1f} s")
        if cfg.family == "ssm":
            from repro_torch.models import scan_utils

            H = cfg.n_heads
            hd = 2 * cfg.d_model // H
            n_m = cfg.block_types.count("m")
            n_pub = get_config(name).block_types.count("m")
            per_block = 3 * B * H * hd * hd * 4 * S
            say(f"[{phase}] (b) {name}: peak {peak:.2f} GiB with the mLSTM scans in chunks of "
                f"{scan_utils.chunk_size(S, scan_utils.REMAT_CHUNK)} steps, against "
                f"{per_block * n_m / 1e9:.1f} GB reckoned for the plain loop (3 float32 states "
                f"of {B} x {H} x {hd} x {hd} kept per step, {S} steps, {n_m} mLSTM blocks; "
                f"{per_block * n_pub / 1e9:.1f} GB at the published {n_pub})")
        torch.cuda.empty_cache()
    counts, _ = warm_counts()
    check_launches(phase, counts, (), idle=tuple(counts))
    return counts


def phase_dryrun():
    """[dryrun]: the dry run in a process of its own (its meshes start a
    fake process group); its lines are printed as they are."""
    import torch

    torch.cuda.empty_cache()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--dryrun-phase"],
                         capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    for line in out.stdout.splitlines():
        say(line)
    require(out.returncode == 0 and "[dryrun] ok" in out.stdout,
            f"[dryrun] exited {out.returncode}: {out.stderr[-3000:]}")


def dryrun_allocated(what, make, reckoned, card):
    """(b): the bytes ``make()`` asks the allocator for (its
    ``requested_bytes``) equal ``reckoned``, and its ``memory_allocated``
    delta exceeds them by no more than the allocator's rounding: 512 B per
    tensor, and for a tensor of more than 1 MiB a segment tail of at most 1
    MiB that it does not split off. Returns what ``make`` made."""
    import torch

    from repro_torch.models.convert import flatten

    def now():
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated(),
                torch.cuda.memory_stats()["requested_bytes.all.current"])

    before = now()
    made = make()
    after = now()
    delta, requested = after[0] - before[0], after[1] - before[1]
    leaves = (list(made.parameters()) if isinstance(made, torch.nn.Module)
              else [t for t in flatten(made) if torch.is_tensor(t)])
    sizes = [t.numel() * t.element_size() for t in leaves]
    slack = sum(DRYRUN_ROUNDING + (DRYRUN_UNSPLIT_TAIL if n > DRYRUN_UNSPLIT_TAIL else 0)
                for n in sizes)
    over = sum(n > DRYRUN_UNSPLIT_TAIL for n in sizes)
    say(f"[dryrun] (b) {what}: reckoned {reckoned:,} B, {len(leaves)} tensors of {sum(sizes):,} "
        f"B, requested {requested:,} B, allocated {delta:,} B (+{delta - reckoned:,}; "
        f"{delta - reckoned - DRYRUN_ROUNDING * len(leaves):,} past 512 B per tensor, "
        f"{over} tensors above 1 MiB) ({card})")
    require(sum(sizes) == reckoned == requested,
            f"[dryrun] (b) {what}: reckoned {reckoned} B, made {sum(sizes)} B, "
            f"requested {requested} B")
    require(0 <= delta - reckoned <= slack,
            f"[dryrun] (b) {what}: allocated {delta} B against {reckoned} B reckoned")
    return made


def run_dryrun_phase():
    """The body of [dryrun] (``python3 chip_smoke.py --dryrun-phase``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.models.convert import param_tree
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() or torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    # (a) the production-mesh cells, built on meta
    for arch, shape in DRYRUN_CELLS:
        r = dryrun.build_cell(arch, shape, False, {})
        require(r.get("status") == "ok", f"[dryrun] (a) {arch} {shape}: {r}")
        m = r["memory_stats"]
        require(m["temp_bytes"] is not None, f"[dryrun] (a) {arch} {shape}: "
                f"{r['temp_bytes_source']}")
        say(f"[dryrun] (a) {arch} {shape} on {r['mesh']} ({r['chips']} chips): per device "
            f"params {m['param_bytes']:,} B, optimizer {m['optimizer_bytes']:,} B, batch "
            f"{m['batch_bytes']:,} B, cache {m['cache_bytes']:,} B, temp "
            f"{m['temp_bytes']:,.0f} B (ceiling); fits 80 GB: {r['fits_hbm_80g']} "
            f"({r['fits_hbm_80g_from']}); "
            f"terms (floors, {r['hardware']['name']}) compute {r['compute_s']:.6g} s, memory "
            f"{r['memory_s']:.6g} s, collective {r['collective_s']:.6g} s -> "
            f"{r['bottleneck']}; FLOPs {r['flops_global']:.6g} counted, {r['model_flops']:.6g} "
            f"model ({r['useful_ratio']:.3f}); passes {r['pass_a_s']} + {r['pass_b_s']} s "
            f"({card})")
    # (b) the bytes reckoned on a 1x1 mesh against the allocator
    dev = torch.device("cuda")
    cfg = get_config(LLM_ARCH)
    mesh = ((1, 1), ("data", "model"))
    train = dryrun.dry_run(cfg, (LLM_TRAIN_S, LLM_TRAIN_B, "train"), *mesh)
    decode = dryrun.dry_run(cfg, (LLM_CACHE, LLM_B, "decode"), *mesh, {"skip_cost_pass": True})
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    model = dryrun_allocated("parameters", lambda: M.Transformer(cfg, generator=gen, device=dev),
                             train["memory_stats"]["param_bytes"], card)
    state = dryrun_allocated("AdamW moments", lambda: adamw.init(param_tree(model)),
                             train["memory_stats"]["optimizer_bytes"], card)
    cache = dryrun_allocated(f"decode cache (B = {LLM_B}, {LLM_CACHE} slots)",
                             lambda: M.init_cache(cfg, LLM_B, LLM_CACHE, device=dev),
                             decode["memory_stats"]["cache_bytes"], card)
    del cache
    # (c) [llm-train]'s step: FLOPs counted on the card against meta, the bound's share
    shape = (LLM_TRAIN_S, LLM_TRAIN_B, "train")
    meta_flops = dryrun.count_flops(cfg, shape)
    batch = SyntheticLM(cfg.vocab_real, LLM_TRAIN_S, LLM_TRAIN_B).batch_at(0)
    step = make_train_step(cfg, adamw.AdamWConfig())
    step(model, state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    step(model, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    with FlopCounterMode(display=False) as fc:
        step(model, state, batch)
    card_flops = float(fc.get_total_flops())
    bound = max(train["compute_s"], train["memory_s"], train["collective_s"])
    m = train["memory_stats"]
    say(f"[dryrun] (c) {LLM_ARCH} bf16 train step B = {LLM_TRAIN_B}, S = {LLM_TRAIN_S}: FLOPs "
        f"{card_flops:.9g} on the card, {meta_flops:.9g} on meta, {train['flops_global']:.9g} "
        f"by the dry run's 1-and-2-layer extrapolation; H100 bound {bound * 1e3:.3f} ms "
        f"({train['bottleneck']}) against a step of {wall * 1e3:.1f} ms: {100 * bound / wall:.2f}% "
        f"of it; peak {peak / 2**30:.2f} GiB on the card, dry run arguments + temp "
        f"{(m['argument_bytes'] + m['temp_bytes']) / 2**30:.2f} GiB ({card})")
    require(card_flops == meta_flops,
            f"[dryrun] (c) the card counted {card_flops} FLOPs, meta {meta_flops}")
    require(bound <= wall, f"[dryrun] (c) the bound {bound} s exceeds the step's {wall} s")
    say(f"[dryrun] ok in {time.perf_counter() - t0:.1f} s ({card})")
    return 0


def run(oracles):
    import torch

    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    say(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    say(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    so = build.build()
    build.load()
    say(f"[setup] kernels built and loaded in {time.perf_counter() - t0:.2f} s: {so}")
    for line in (so.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say(f"[setup]   {line.strip()}")
    dev = torch.device("cuda")
    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        say(f"[time] {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    rows = phase_kernels(dev)
    lap("kernels")
    phase_sweep_window(dev)
    rows.update(phase_tile_kernels(dev))
    phase_large_tiles(dev)
    lap("sweep-window, tiles, large-tiles")
    phase_factors(dev)
    phase_inverse_oracles(dev, oracles)
    lap("factors")
    by_path = {}
    counts, b, single, single_wall, main_fact = phase_main_path(dev)
    by_path["main"] = counts
    by_path["main-inverse"], inv_single = phase_main_inverse(dev, b)
    by_path["multi-rhs"], multi = phase_multi_rhs(dev, b, single, single_wall)
    lap("main, main-inverse, multi-rhs")
    phase_card_vs_cpu(dev)
    lap("card-vs-cpu")
    for bs in BILU_SIZES:
        by_path[f"bilu-bs{bs}"] = phase_bilu(dev, bs)
    phase_bilu_card_vs_cpu(dev)
    by_path["cg"] = phase_cg(dev, b)
    lap("bilu, cg")
    fact4, _ = phase_topilu(dev, main_fact)
    rows.update(phase_distributed_kernels(dev, fact4))
    lap("topilu, distributed kernels")
    rows.update(phase_sharded_sweep(dev, main_fact))
    phase_sharded_apply(dev, main_fact, fact4)
    lap("sharded-sweep, sharded-apply")
    by_path["distributed"], dist_cold = phase_distributed(dev, b, single)
    by_path["distributed-inverse"] = phase_distributed_inverse(dev, b, inv_single)
    phase_sharded_card_vs_cpu(dev)
    phase_wide_band(dev)
    lap("distributed, wide-band")
    o4 = phase_ordering()
    by_path["distributed-fusion"], fused_cold = phase_distributed_fusion(dev, b, o4)
    lap("ordering, distributed-fusion")
    by_path["dist-ranks"], by_path["serve-ranks"], nccl_args = phase_dist_ranks(dev)
    lap("dist-ranks, serve-ranks")
    phase_dist_nccl(dev, *nccl_args)
    lap("dist-nccl")
    by_path["pipeline-demo"] = phase_pipeline_demo(dev)
    lap("pipeline-demo")
    by_path.update(phase_warm(dev, b, single, multi, dist_cold, fused_cold, o4))
    lap("warm")
    by_path["bicgstab"] = phase_bicgstab(dev)
    by_path["breakdown"] = phase_breakdown(dev)
    lap("bicgstab, breakdown")
    by_path["serve"] = phase_serve(dev)
    lap("serve")
    by_path["serve-sharded"] = phase_serve_sharded(dev)
    lap("serve-sharded")
    by_path["llm-serve"] = phase_llm_serve(dev)
    lap("llm-serve")
    by_path["llm-train"] = phase_llm_train(dev)
    lap("llm-train")
    by_path["llm-families"] = phase_llm_families(dev)
    lap("llm-families")
    by_path["llm-families-train"] = phase_llm_families_train(dev)
    lap("llm-families-train")
    phase_dryrun()
    lap("dryrun")

    for name, r in rows.items():
        path = ("main-inverse" if name == "inverse_chain"
                else f"bilu-bs{BS_TILE}" if name.removesuffix("_bf16") in TILE_KERNELS
                else "distributed" if name in DISTRIBUTED_KERNELS else "main")
        r["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        r["launches"] = r["launches_by_path"][path]
    say(json.dumps({"kernels": list(rows.values())}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def run_dist_nccl():
    """``python3 chip_smoke.py --dist-nccl``, on a machine with two cards or
    more: the build and [dist-nccl] alone (the NCCL ranks' fusion solve
    against its one-card run on card 0), then a last line
    ``{"dist_nccl": {"ok": true, "cards": N}}``."""
    import numpy as np
    import torch

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.ordering import fusion_aware_ordering
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    say(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    cards = torch.cuda.device_count()
    require(cards >= 2, f"--dist-nccl needs two cards or more, this machine has {cards}")
    build.build()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    nx = DIST_RANKS_NX
    b = np.random.default_rng(SEED + 1).standard_normal(nx * nx).astype(np.float32)
    o4 = fusion_aware_ordering(poisson_2d(nx), SHARDED_D, band_rows=BAND_ROWS)
    phase_dist_nccl(dev, b, o4, fusion_reference(dev, b, o4, SHARDED_D, nx), nx,
                    serve_ranks_cases(nx))
    say(f"[time] dist-nccl: {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"dist_nccl": {"ok": True, "cards": cards}}))
    return 0


def main():
    setup()
    if sys.argv[1:] == ["--dist-nccl"]:
        return run_dist_nccl()
    if sys.argv[1:] == ["--dryrun-phase"]:
        return run_dryrun_phase()
    # the sequential inverse oracles of phase 3b are pure Python (about a
    # minute for convection_diffusion_2d(32) at k=2); two worker processes
    # run them, the longest first, while the card works through phases 2-3.
    # They are done before the timed solves of phase 4 start.
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=2, mp_context=ctx) as pool:
        oracles = {(name, k): pool.submit(inverse_oracle, name, k)
                   for name in reversed(SMALL) for k in (2, 1, 0)}
        return run(oracles)


if __name__ == "__main__":
    sys.exit(main())
