"""The port's roofline and performance models held to the JAX package's.

* ``model_flops`` and ``recurrent_scan_correction`` (on the single- and
  multi-pod chip counts) equal ``repro.roofline.analysis``'s exactly for
  all ten configs and the four shapes;
* ``predict_times`` and ``speedup_curve`` equal ``repro.core.perf_model``'s
  exactly;
* ``analyze_costs`` on the TPU v5e record equals JAX's ``RooflineReport``
  field by field; on the default record it uses the H100's constants;
* ``extrapolate_costs`` of the counted FLOPs of 1- and 2-layer cost
  configs equals a direct count of 4 layers, for reduced smollm and
  deepseek at a train and a prefill shape, and so does a count of 4
  layers through the KV-chunk walk (``attn_unroll`` off).
"""
import dataclasses

import pytest

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.core import perf_model
from repro_torch.launch.dryrun import _depth, count_flops
from repro_torch.roofline import analysis as A

WORKLOADS = [
    dict(n=160000, n_f=1120654, t_symbolic=6.0, t_numeric=1.4, n_bands=5000, k=1),
    dict(n=4096, n_f=60000, t_symbolic=0.31, t_numeric=0.07, n_bands=128, k=2),
]
CLUSTERS = [dict(), dict(bandwidth=1.25e9, latency=5e-6),
            dict(n_clusters=3, inter_latency=2e-3)]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_scan_correction_equal_jax(arch, shape):
    from repro.configs import get_config as jax_config
    from repro.roofline import analysis as JA

    cfg, jcfg = get_config(arch), jax_config(arch)
    assert A.model_flops(cfg, shape) == JA.model_flops(jcfg, shape)
    for chips in (256, 512):
        assert (A.recurrent_scan_correction(cfg, shape, chips)
                == JA.recurrent_scan_correction(jcfg, shape, chips))


@pytest.mark.parametrize("dynamic_lb", [False, True])
@pytest.mark.parametrize("w", range(len(WORKLOADS)))
def test_perf_model_equals_jax(w, dynamic_lb):
    from repro.core import perf_model as JP

    ps = (1, 2, 8, 60, 100)
    for spec in CLUSTERS:
        got_w, want_w = perf_model.WorkloadStats(**WORKLOADS[w]), JP.WorkloadStats(**WORKLOADS[w])
        got_c, want_c = perf_model.ClusterSpec(**spec), JP.ClusterSpec(**spec)
        for p in ps:
            assert (perf_model.predict_times(got_w, p, got_c, dynamic_lb)
                    == JP.predict_times(want_w, p, want_c, dynamic_lb))
        assert (perf_model.speedup_curve(got_w, ps, got_c, dynamic_lb)
                == JP.speedup_curve(want_w, ps, want_c, dynamic_lb))


@pytest.mark.parametrize("case", range(3))
def test_analyze_costs_on_v5e_equals_jax(case):
    from repro.roofline import analysis as JA

    costs = [dict(flops=3.1e15, bytes=2.2e11, **{"coll/all-reduce": 1.2e9}),
             dict(flops=1.0e9, bytes=9.9e11, **{"coll/all-gather": 4e8, "coll/all-to-all": 1e7}),
             dict(flops=0.0, bytes=1.0, **{"coll/all-reduce": 8e12})][case]
    kw = dict(arch="smollm-135m", shape="train_4k", mesh_name="16x16", chips=256,
              model_flops_global=8.46e14, memory_stats={"argument_bytes": 3.3e8},
              corrections={"flops": 1e12, "bytes": 2e9} if case == 0 else None)
    got = A.analyze_costs(dict(costs), hardware=A.TPU_V5E, **kw).to_json()
    want = JA.analyze_costs(dict(costs), **kw).to_json()
    assert got == want
    h100 = A.analyze_costs(dict(costs), **kw)
    assert h100.compute_s == got["flops_per_device"] / 989e12
    assert h100.memory_s == got["bytes_per_device"] / 3.35e12
    assert h100.collective_s == got["collective_bytes"] / 450e9
    assert (A.TPU_V5E.peak_flops, A.TPU_V5E.hbm_bw, A.TPU_V5E.link_bw) == (
        JA.PEAK_FLOPS, JA.HBM_BW, JA.LINK_BW)


def test_ring_bytes_are_jax_wire_models():
    assert A.ring_bytes("all-reduce", 100.0, 4) == 2 * 3 / 4 * 100.0
    assert A.ring_bytes("all-gather", 100.0, 4) == 3 / 4 * 100.0
    assert A.ring_bytes("reduce-scatter", 100.0, 4) == 300.0
    assert A.ring_bytes("collective-permute", 100.0, 4) == 100.0
    assert A.ring_bytes("all-reduce", 100.0, 1) == 0.0


@pytest.mark.parametrize("shape", [(32, 2, "train"), (64, 2, "prefill")])
@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b"])
def test_layer_extrapolation_equals_a_direct_count(arch, shape):
    cfg = dataclasses.replace(get_config(arch).reduced(), q_chunk=16, kv_chunk=16)
    c1, c2, c4 = (count_flops(_depth(cfg, n, attn_unroll=True), shape) for n in (1, 2, 4))
    assert c2 > c1 > 0
    assert A.extrapolate_costs({"flops": c1}, {"flops": c2}, 4)["flops"] == c4
    # the cost form does the KV-chunk walk's multiply-adds, no more and no fewer
    assert count_flops(_depth(cfg, 4), shape) == c4
