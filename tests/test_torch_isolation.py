"""The port stands alone: no jax, nothing of ``repro``, no quiet CPU fallback.

* A child process imports the port with ``jax`` blocked and runs a tiny
  GMRES and CG solve, a Block-ILU, a distributed solve over two band
  owners, an RCM-ordered BiCGSTAB solve, a fusion-ordered batch, a
  warm-up, a two-tenant round trip of the solve service, a solve over
  two gloo ranks (``repro_torch.launch.dist``), imports the solve service
  over ranks (``repro_torch.serve.ranks``) and runs three greedy decode
  steps of a reduced smollm-135m (``repro_torch.models``,
  ``repro_torch.train.step``), one decode step each of a reduced
  deepseek-v2-lite (MoE, MLA) and whisper-tiny (after
  ``precompute_cross_kv``), a train step of it (two microbatches,
  compressed gradients) and a checkpoint round trip, a train step of a
  reduced xlstm-125m whose scans run in chunks (``models.scan_utils``),
  imports the pipeline and the training CLI, and runs one reduced dry-run
  cell (deepseek, train) on the (2,4) mesh (``launch.mesh``,
  ``launch.sharding``, ``launch.dryrun``, ``roofline.analysis``,
  ``core.perf_model``), on the CPU; no ``repro`` module may get loaded.
* No source file of the port (its examples included) mentions an import
  of jax or of ``repro``.
* Without a GPU, the entry points (the training loop, its CLI, example
  and ``restore`` included) raise unless the caller passes
  ``device="cpu"``, and ``resolve_device(None)`` raises; ``"meta"`` is
  taken only when named; and ``chip_smoke.py`` fails without printing a
  result.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

CHILD = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import repro_torch.core.api, repro_torch.core.solvers, repro_torch.kernels.ops
import repro_torch.kernels.build
from repro_torch.core.bilu import bilu
from repro_torch.core.matgen import poisson_2d
from repro_torch.core.solvers import solve_with_ilu
a = poisson_2d(6)
r, _ = solve_with_ilu(a, np.ones(a.n, np.float32), k=1, device="cpu")
assert r.verdict == "converged", r.verdict
r, _ = solve_with_ilu(a, np.ones(a.n, np.float32), k=1, method="cg", device="cpu")
assert r.verdict == "converged", r.verdict
f = bilu(a, 1, bs=8, device="cpu")
assert f.tiles.shape == (len(f.tile_index), 8, 8)
import repro_torch.core.top_ilu, repro_torch.core.numeric, repro_torch.core.guard
from repro_torch.core.solvers import solve_sharded
r, f = solve_sharded(a, np.ones(a.n, np.float32), k=1, n_devices=2, band_rows=8, device="cpu")
assert r.verdict == "converged" and f.n_devices == 2, r.verdict
r, _ = solve_sharded(a, np.ones(a.n, np.float32), k=1, n_devices=2, band_rows=8, device="cpu",
                     precond_method="inverse", tol=1e-4)
assert r.verdict == "converged", r.verdict
import repro_torch.core.ordering
from repro_torch.core.ordering import fusion_aware_ordering, sweep_comm_model
r, f = solve_with_ilu(a, np.ones(a.n, np.float32), k=1, ordering="rcm", method="bicgstab",
                      device="cpu")
assert r.verdict == "converged" and f.ordering.name == "rcm", r.verdict
o = fusion_aware_ordering(a, 2, band_rows=8)
r, f = solve_sharded(a, np.ones((3, a.n), np.float32), k=1, n_devices=2, band_rows=8,
                     ordering=o, device="cpu")
assert len(r) == 3 and f.ordering is o
assert sweep_comm_model(f.pattern, 8, 2)["epochs"] >= 1
from repro_torch.core.solvers import warm_solve
assert set(warm_solve(a, k=1, batch_sizes=(1, 2), sharded=False, device="cpu")) == {1, 2}
import repro_torch.serve, repro_torch.runtime.fault
from repro_torch.core.sparse import CSRMatrix
from repro_torch.serve import ServeConfig, SolveService
svc = SolveService(ServeConfig(device="cpu", buckets=(1, 2), restart=8))
svc.register_matrix("m0", a)
svc.register_matrix("m1", CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices,
                                    data=(a.data * 2).astype(np.float32)))
svc.warmup()
for tenant, mid in (("t0", "m0"), ("t1", "m1"), ("t1", "m0")):
    svc.submit(tenant, mid, np.ones(a.n, np.float32))
out = svc.tick()
assert len(out) == 3 and all(r.ok and r.verdict == "converged" for r in out), out
assert svc.metrics_snapshot()["compiles"]["after_warmup"] == 0
import repro_torch.core.dist, repro_torch.launch.dist, repro_torch.serve.ranks
from repro_torch.launch.dist import run_ranks, serve_rank, solve_rank
from repro_torch.serve.ranks import follow, lead, open_lanes
out = run_ranks(solve_rank, 2, "gloo", ["cpu"] * 2, timeout_s=120,
                args=(40, 0.1, 1, "gmres", "gather", 8, "natural", 0))
assert all(o["verdict"] == "converged" for o in out), out
assert np.array_equal(out[0]["x"].view(np.int32), out[1]["x"].view(np.int32))
import torch
import repro_torch.models.model, repro_torch.configs, repro_torch.train.step
from repro_torch.configs import get_config
from repro_torch.models import model as LM
from repro_torch.train.step import make_serve_step
cfg = get_config("smollm-135m").reduced()
lm = LM.Transformer(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
cache = LM.init_cache(cfg, 2, 8, device="cpu")
serve = make_serve_step(cfg)
tok = torch.zeros((2, 1), dtype=torch.int32)
for _ in range(3):
    tok, logits, cache = serve(lm, cache, tok)
assert logits.shape == (2, 1, cfg.vocab) and cache["kv"]["len"].eq(3).all()
assert bool(torch.isfinite(logits).all()) and int(tok.max()) < cfg.vocab_real
import repro_torch.models.ffn, repro_torch.models.ssm, repro_torch.models.xlstm
for arch in ("deepseek-v2-lite-16b", "whisper-tiny"):
    fcfg = get_config(arch).reduced()
    fm = LM.Transformer(fcfg, generator=torch.Generator().manual_seed(1), device="cpu")
    fcache = LM.init_cache(fcfg, 2, 8, device="cpu")
    if fcfg.family == "audio":
        frames = torch.randn((2, fcfg.encoder_seq, fcfg.d_model), generator=torch.Generator())
        fcache = LM.precompute_cross_kv(fcfg, fm, fcache, frames * 0.02)
    ftok = torch.zeros((2, 1), dtype=torch.int32)
    ftok, flogits, fcache = make_serve_step(fcfg)(fm, fcache, ftok)
    assert flogits.shape == (2, 1, fcfg.vocab) and bool(torch.isfinite(flogits).all()), arch
import tempfile
import repro_torch.train.pipeline, repro_torch.launch.train, repro_torch.train.loop
from repro_torch.checkpoint.ckpt import restore, save
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.convert import flatten, param_tree
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step
state = adamw.init(param_tree(lm))
step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1), microbatches=2,
                       compress_grads=True)
lm, state, m = step(lm, state, SyntheticLM(cfg.vocab_real, 8, 2).batch_at(0))
assert int(state["count"]) == 1 and bool(torch.isfinite(m["loss"]))
with tempfile.TemporaryDirectory() as d:
    save(d, 1, (param_tree(lm), state))
    got, _ = restore(d, 1, (param_tree(lm), state), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(flatten(got), flatten((param_tree(lm), state))))
from repro_torch.models import scan_utils
scan_utils.REMAT_CHUNK = 4  # the 8 steps in two chunks
xcfg = get_config("xlstm-125m").reduced()
xm = LM.Transformer(xcfg, generator=torch.Generator().manual_seed(2), device="cpu")
xstate = adamw.init(param_tree(xm))
xm, xstate, xmet = make_train_step(xcfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1))(
    xm, xstate, SyntheticLM(xcfg.vocab_real, 8, 2).batch_at(0))
assert int(xstate["count"]) == 1 and bool(torch.isfinite(xmet["grad_norm"]))
import dataclasses
import torch.distributed as dist
import repro_torch.launch.mesh, repro_torch.launch.sharding, repro_torch.roofline.analysis
import repro_torch.core.perf_model
from repro_torch.launch.dryrun import dry_run
dcfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(), q_chunk=16, kv_chunk=16)
cell = dry_run(dcfg, (32, 4, "train"), (2, 4), ("data", "model"), {"zero1": True})
assert cell["status"] == "ok" and cell["flops_global"] > 0 and not dist.is_initialized(), cell
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print("ISOLATED")
"""


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def test_port_imports_and_solves_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", CHILD], env=_child_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED" in out.stdout


def test_no_source_file_imports_jax_or_repro():
    pat = re.compile(r"import jax|from jax|from repro\.|import repro\b(?!_torch)")
    files = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples").glob("*_torch.py"))
             + [ROOT / "chip_smoke.py"])
    assert len(files) > 10
    scanned = {f.relative_to(PORT).parts[0] for f in files if PORT in f.parents}
    assert {"configs", "models", "train", "core", "kernels", "serve", "optim", "data",
            "checkpoint", "launch", "roofline"} <= scanned
    assert ROOT / "examples" / "serve_decode_torch.py" in files
    assert ROOT / "examples" / "train_smollm_torch.py" in files
    assert PORT / "models" / "scan_utils.py" in files
    assert {PORT / "launch" / "dryrun.py", PORT / "roofline" / "analysis.py",
            PORT / "core" / "perf_model.py", ROOT / "examples" / "quickstart_torch.py",
            PORT / "serve" / "ranks.py", ROOT / "examples" / "ilu_pipeline_demo_torch.py"} <= set(files)
    for f in files:
        for no, line in enumerate(f.read_text().splitlines(), 1):
            assert not pat.search(line), f"{f.relative_to(ROOT)}:{no}: {line.strip()}"


def test_entry_points_raise_without_gpu(monkeypatch):
    from repro_torch.core.api import ilu
    from repro_torch.core.bilu import bilu
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_with_ilu

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = poisson_2d(4)
    b = np.ones(a.n, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_with_ilu(a, b, k=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ilu(a, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bilu(a, 1, bs=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_with_ilu(a, b, k=1, method="cg")
    with pytest.raises(RuntimeError):
        solve_with_ilu(a, b, k=1, device="cuda")
    r, _ = solve_with_ilu(a, b, k=1, device="cpu")
    assert r.converged


def test_distributed_entry_points_raise_without_gpu(monkeypatch):
    from repro_torch.core.api import ilu, ilu_sharded
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded
    from repro_torch.core.top_ilu import BandGroup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = poisson_2d(4)
    b = np.ones(a.n, np.float32)
    for call in (lambda: solve_sharded(a, b, k=1, n_devices=2, band_rows=4),
                 lambda: ilu_sharded(a, 1, n_devices=2, band_rows=4),
                 lambda: ilu(a, 1, backend="topilu", n_devices=2, band_rows=4),
                 lambda: BandGroup(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    r, f = solve_sharded(a, b, k=1, n_devices=2, band_rows=4, device="cpu")
    assert r.converged and f.device.type == "cpu"


def test_model_entry_points_raise_without_gpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.models import model as M

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.Transformer(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_cache(cfg, 1, 4)
    assert M.Transformer(cfg, generator=torch.Generator(), device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("meta").type == "meta"
    meta = M.Transformer(cfg, device="meta", params=M.init_params(cfg, None, torch.device("meta")))
    assert meta.device.type == "meta" and M.init_cache(cfg, 1, 4, device="meta")["kv"]["k"].is_meta
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_decode_torch.py"),
                          "--tokens", "2"], env={**_child_env(), "CUDA_VISIBLE_DEVICES": ""},
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "device='cpu'" in out.stderr, out.stderr[-2000:]


def test_training_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.configs import get_config
    from repro_torch.launch import train as cli
    from repro_torch.train.loop import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, n_steps=1, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
    save(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore(str(tmp_path), 1, {"w": torch.ones(2)})
    res = train(cfg, n_steps=1, seq_len=8, global_batch=2, log_every=0, device="cpu")
    assert res.steps == 1 and res.model.device.type == "cpu"
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "train_smollm_torch.py"),
                          "--steps", "1"], env={**_child_env(), "CUDA_VISIBLE_DEVICES": ""},
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "device='cpu'" in out.stderr, out.stderr[-2000:]


def _no_result(out):
    return '"ok": true' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    env = _child_env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # hides any GPU, so the check is the same everywhere
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and _no_result(out), out.stdout[-2000:]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(alone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and _no_result(out), out.stdout[-2000:]
