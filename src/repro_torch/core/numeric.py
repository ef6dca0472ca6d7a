"""Device-side numeric factorization (Phase II) over a FactorPlan.

The port's counterpart of the single-device engine of
``repro/core/numeric_jax.py``: the round-major pivot-op wavefront sweep,
run by the ``factor_wavefront`` CUDA kernel on a GPU and by its plain
PyTorch version on the CPU (:func:`repro_torch.kernels.ops.factor_wavefront`).
Both give the values of :func:`repro_torch.core.numeric_ref.numeric_ilu_ref`
bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def make_wavefront_factorizer(plan, device):
    """``(n+1, W) A values -> (n, W) factor values`` on ``device``.

    The schedule arrays are uploaded once; the returned callable takes a
    NumPy array or a tensor and returns a tensor on ``device``.
    """
    dev = torch.device(device)
    sched = plan.schedule_tensors(dev)

    def factorize(vals) -> torch.Tensor:
        a_vals_ext = torch.as_tensor(vals, dtype=torch.float32, device=dev).contiguous()
        return ops.factor_wavefront(sched["op_row"], sched["op_lane"], sched["op_piv"],
                                    sched["op_dlane"], sched["op_dst"], sched["dst_flat"],
                                    a_vals_ext)

    return factorize
