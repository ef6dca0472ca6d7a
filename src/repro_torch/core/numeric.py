"""Device-side numeric factorization (Phase II): two executors.

The port's counterpart of ``repro/core/numeric_jax.py``:

* :func:`make_wavefront_factorizer` — the single-device path, the
  round-major pivot-op wavefront sweep over a FactorPlan, run by the
  ``factor_wavefront`` CUDA kernel on a GPU and by its plain PyTorch
  version on the CPU (:func:`repro_torch.kernels.ops.factor_wavefront`);
* :func:`make_superstep_factorizer` — the banded TOP-ILU executor over a
  :class:`~repro_torch.core.planner.NumericPlan`: D band owners, with all
  of them on one GPU one persistent ``superstep_factor`` launch per
  factorization (every superstep and halo exchange inside it); on the CPU,
  and over processes (one owner per rank), one superstep and one halo
  exchange at a time.

Both give the values of :func:`repro_torch.core.numeric_ref.numeric_ilu_ref`
bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

from .factor_plan import SCHEDULE_FIELDS


def make_wavefront_factorizer(plan, device):
    """``(n+1, W) A values -> (n, W) factor values`` on ``device``.

    The schedule arrays are uploaded, checked and (on a GPU) packed once
    (:class:`repro_torch.kernels.ops.FactorWavefront`); the returned
    callable takes a NumPy array or a tensor and returns a tensor on
    ``device``.
    """
    dev = torch.device(device)
    sched = plan.schedule_tensors(dev)
    kernel = ops.FactorWavefront(*(sched[f] for f in SCHEDULE_FIELDS), plan.n)

    def factorize(vals) -> torch.Tensor:
        return kernel(torch.as_tensor(vals, dtype=torch.float32, device=dev).contiguous())

    return factorize


# --------------------------------------------------------------------------
# band superstep executor (TOP-ILU over D band owners, sharded values)
# --------------------------------------------------------------------------
def _device_major(plan, x):
    """(n_pad, ...) row table -> (D, s_loc, ...) owner blocks."""
    return plan.rows_device_major(x).reshape((plan.n_devices, plan.s_loc) + x.shape[1:])


def plan_state_array(plan, a=None, owners=None) -> np.ndarray:
    """The (len(owners), state_rows, W) initial value state of the owners
    ``owners`` (all D when None): band-local A values (owner-major), zero
    halo, zero scratch. ``a=None`` uses the values captured at plan build;
    a matrix with the same structure re-scatters its current data (the
    refactorization path)."""
    owners = range(plan.n_devices) if owners is None else owners
    vals = plan.a_vals if a is None else plan.scatter_values(a)
    state = np.zeros((len(owners), plan.state_rows, plan.width), np.float32)
    state[:, : plan.s_loc] = _device_major(plan, vals)[list(owners)]
    return state


def plan_device_arrays(plan, keys=None, owners=None) -> dict:
    """Host-side inputs of the superstep factorizer, each with a leading
    owner axis: every per-row table is permuted owner-major, so owner d's
    block holds exactly the rows it owns. ``keys`` restricts which arrays
    are built (the value ``state`` is rebuilt per factorization). With
    ``owners``, every owner-major table keeps only those owners, in the
    local form one launch over them reads
    (:func:`repro_torch.kernels.ops.owner_tables`)."""
    def dm(x):
        return _device_major(plan, x)

    builders = dict(
        state=lambda: plan_state_array(plan),
        sched=lambda: plan.superstep_bands,
        piv_addr=lambda: dm(plan.piv_addr),
        piv_dlane=lambda: dm(plan.piv_dlane),
        piv_dst=lambda: dm(plan.piv_dst),
        n_piv=lambda: dm(plan.diag_pos.astype(np.int32)),
        egress=lambda: plan.egress_idx,
        ingress=lambda: plan.ingress_idx,
    )
    keys = builders.keys() if keys is None else keys
    out = {k: builders[k]() for k in keys}
    if owners is None:
        return out
    if "state" in out:
        out["state"] = out["state"][list(owners)]
    return ops.owner_tables(out, owners, plan.n_bands, plan.n_devices)


def make_superstep_factorizer(plan, group, broadcast: str = "gather"):
    """``(L, state_rows, W) state -> (L, s_loc, W)`` factored local values of
    the L = len(local_owners) owners of ``group`` that live here (a
    :class:`~repro_torch.core.top_ilu.BandGroup` of ``plan.n_devices``, all
    local, or a :class:`~repro_torch.core.dist.DistBandGroup`, one per rank).

    The plan's tables are checked and bound once
    (:class:`repro_torch.kernels.ops.SuperstepFactor`); each rank keeps its
    owners' slices. With all owners on one CUDA device a call is ONE
    persistent ``superstep_factor`` launch: every superstep of every owner,
    each halo exchange a copy inside the kernel, counted in the group
    through ``BandGroup.record``. On the CPU, over processes, or with
    ``step=``, it is the per-superstep loop: one ``superstep_factor`` per
    superstep (in-band pivots from the band being built, the rest from
    local rows or the halo through ``piv_addr``), then, when some owner
    consumes another's rows, ONE exchange that ships each owner's (E, W)
    egress payload — the finalized rows another owner needs — to every
    owner, which scatters it into its halo through the ingress map
    (``broadcast="gather"`` is one collective, ``"ring"`` D-1 hops;
    ``"psum"`` is ``"gather"``). Every exchange is a copy of finished
    float32 rows, so it cannot change a bit, and the values equal the
    sequential oracle's.
    """
    from .top_ilu import _broadcast

    D = plan.n_devices
    if group.n_devices != D:
        raise ValueError(f"the plan has {D} band owners, the group {group.n_devices}")
    broadcast = _broadcast(broadcast)
    bound_group, dev = group, group.device
    kernel = ops.SuperstepFactor(
        *(plan_device_arrays(plan, keys=ops.SuperstepFactor.FIELDS + ("egress", "ingress"))
          .values()), plan.n_bands, plan.band_rows, plan.halo_size, dev,
        owners=group.local_owners)

    def factorize(state, step=None, group=None) -> torch.Tensor:
        """``step`` runs one superstep in place (a check may pass a function
        that also runs the plain version): the per-superstep loop, on any
        device. ``group`` is the BandGroup the exchanges go through (the
        one given at build time by default): a factorizer cached per
        structure serves every group of its owner count and device."""
        group = bound_group if group is None else group
        st = torch.as_tensor(state, dtype=torch.float32, device=dev).contiguous()
        return kernel(st, group, broadcast, step=step)[:, :plan.s_loc]

    factorize.kernel = kernel
    return factorize
