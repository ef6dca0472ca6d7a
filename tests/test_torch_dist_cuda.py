"""Band owners as processes on the card: gloo ranks sharing one GPU (each
exchange staged through pinned host memory) against the one-device
``BandGroup`` on the same card. ``cuda``-marked: each test skips from
inside where no GPU is present. This file imports no JAX, so on the GPU
machine ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dist_cuda.py``
runs it; the CPU twins are ``test_torch_dist.py`` and
``test_torch_dist_solve.py``.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro_torch.core.matgen import poisson_2d
from repro_torch.core.top_ilu import BandGroup
from repro_torch.launch.dist import run_ranks


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _arrays(a):
    return (a.n, np.asarray(a.indptr), np.asarray(a.indices), np.asarray(a.data))


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", ["gather", "ring"])
def test_gloo_ranks_on_one_card_equal_the_one_device_group(broadcast, tmp_path):
    dev = _card()
    a = poisson_2d(16)
    rng = np.random.default_rng(3)
    cases = [dict(matrix=_arrays(a), k=1, ordering=o, broadcast=broadcast, band_rows=8,
                  applies=[rng.standard_normal(a.n).astype(np.float32),
                           rng.standard_normal((3, a.n)).astype(np.float32)])
             for o in ("natural", "fusion")]
    got = run_ranks(ranks.factor_cases, 2, "gloo", ["cuda"] * 2,
                    init_file=str(tmp_path / "store"), timeout_s=300, args=(cases,))
    for i, case in enumerate(cases):
        want = ranks.factor_case(BandGroup(2, dev), case)
        for r in got:
            r = r[i]
            assert np.array_equal(r["vals"].view(np.int32), want["vals"].view(np.int32))
            assert r["counts"] == want["counts"]
            for key, (y, counts) in want["applies"].items():
                assert np.array_equal(r["applies"][key][0].view(np.int32), y.view(np.int32))
                assert r["applies"][key][1] == counts


@pytest.mark.cuda
def test_gloo_ranks_on_one_card_solve_like_the_one_device_group(tmp_path):
    dev = _card()
    a = poisson_2d(16)
    case = dict(matrix=_arrays(a), b=np.random.default_rng(4).standard_normal(a.n)
                .astype(np.float32), kw=dict(k=1, band_rows=8, ordering="fusion", restart=10))
    got = run_ranks(ranks.solve_cases, 2, "gloo", ["cuda"] * 2,
                    init_file=str(tmp_path / "store"), timeout_s=300, args=([case],))
    want = ranks.solve_case(BandGroup(2, dev), case)
    assert want["verdict"] == ["converged"]
    for r in got:
        r = r[0]
        assert np.array_equal(r["x"][0].view(np.int32), want["x"][0].view(np.int32))
        assert (r["iterations"], r["verdict"], r["counts"]) == (
            want["iterations"], want["verdict"], want["counts"])
