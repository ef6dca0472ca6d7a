"""``examples/ilu_pipeline_demo_torch.py``, the port's counterpart of
``examples/ilu_pipeline_demo.py`` (TOP-ILU over 8 band owners, the paper's
Fig 4 pipeline).

* The example runs in a subprocess with ``--device cpu`` (one
  ``BandGroup`` of 8 owners) and with ``--device cpu --ranks --owners 4``
  (4 gloo ranks, one owner each; 4 rather than 8 to hold the suite's
  time): each exits 0 and prints ``bitwise-equal=YES`` for ``psum`` and
  ``ring``. Both run at once, beside the check below.
* The port's ``topilu_numeric`` over 8 owners, under both broadcasts, is
  int32-equal to the JAX package's ``numeric_ilu_ref`` on the demo's matrix
  (the JAX package's own ``matgen`` and ``pilu1_symbolic``, equal to the
  port's).
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
DEMO = ROOT / "examples" / "ilu_pipeline_demo_torch.py"
RUNS = {"band-group-8": ["--device", "cpu"],
        "ranks-4": ["--device", "cpu", "--ranks", "--owners", "4"]}
TIMEOUT_S = 300


def _load_demo():
    spec = importlib.util.spec_from_file_location("ilu_pipeline_demo_torch", DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def demo_runs():
    """Both subprocess runs, started together and read after the port's
    factors at 8 owners are computed here."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    procs = {name: subprocess.Popen([sys.executable, str(DEMO), *argv], env=env, cwd=ROOT,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, argv in RUNS.items()}
    try:
        from repro_torch.core.top_ilu import BandGroup

        demo = _load_demo()
        factors = {bc: vals for bc, (vals, _, _) in demo.factor_both(BandGroup(8, "cpu")).items()}
        outs = {name: p.communicate(timeout=TIMEOUT_S) + (p.returncode,)
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return dict(factors=factors, outs=outs, demo=demo)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_demo_prints_bitwise_equal_for_both_broadcasts(demo_runs, run):
    out, err, rc = demo_runs["outs"][run]
    assert rc == 0, f"{out}\n{err[-3000:]}"
    for broadcast in ("psum", "ring"):
        lines = [ln for ln in out.splitlines() if ln.startswith(f"broadcast={broadcast}")]
        assert len(lines) == 1 and lines[0].endswith("bitwise-equal=YES"), out
    owners = 4 if run == "ranks-4" else 8
    assert f"round-robin over {owners} owners" in out


@pytest.mark.parametrize("broadcast", ["psum", "ring"])
def test_port_factors_at_8_owners_equal_jax_numeric_ilu_ref(demo_runs, broadcast):
    from repro.core.numeric_ref import numeric_ilu_ref as j_numeric_ilu_ref
    from repro.core.symbolic import pilu1_symbolic as j_pilu1

    jmg = importlib.import_module("repro.core.matgen")  # `repro.core.matgen` is also a function
    demo = demo_runs["demo"]
    ja = jmg.matgen(demo.N, density=demo.DENSITY, seed=demo.SEED)
    a, pat = demo.demo_matrix()
    assert np.array_equal(ja.data, a.data) and np.array_equal(ja.indices, a.indices)
    jpat = j_pilu1(ja)
    assert np.array_equal(np.asarray(jpat.indices), np.asarray(pat.indices))
    want = np.asarray(j_numeric_ilu_ref(ja, jpat), np.float32)
    got = demo_runs["factors"][broadcast]
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
