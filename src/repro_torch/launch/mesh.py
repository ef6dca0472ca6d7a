"""Production meshes as ``torch.distributed`` device meshes.

The port's counterpart of ``repro.launch.mesh``:

* ``make_production_mesh()`` is the single pod, 16x16 = 256 chips over
  ``("data", "model")``; ``multi_pod=True`` adds a leading ``pod`` axis
  (2x16x16 = 512 chips) that carries pure data parallelism;
* ``make_host_mesh(data, model)`` is a small ``("data", "model")`` mesh
  (tests, examples);
* ``mesh_axis_sizes``, ``dp_size`` and ``tp_size`` read a mesh's axes.

A ``DeviceMesh`` needs a default process group of the mesh's size. Where
one exists (ranks started by ``launch.dist.run_ranks`` or a launcher), the
mesh is laid over it. Where none exists, which is the dry run's case, the
mesh starts a "fake" group of that world size in this process (rank 0 of
``torch.testing``'s fake backend: collectives return at once and move no
data), and :func:`release_mesh` or the :func:`mesh_scope` context ends
it; a default group of another size is an error, never replaced. The
JAX package's ``make_band_mesh`` (the band owners' 1-D mesh) has its
counterpart in ``core/dist.py``'s ``DistBandGroup``, one band owner per
rank, and is not repeated here.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence

import torch
import torch.distributed as dist

_FAKE = {"world": None}  # the world size of the fake group this module started


def _ensure_group(world: int) -> None:
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != world:
            raise RuntimeError(f"a mesh of {world} devices needs a process group of that size; "
                               f"this process's default group has {have}")
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run's mesh needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg), which this "
                           f"torch {torch.__version__} lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    _FAKE["world"] = world


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes``, over the default
    process group (a fake one of ``prod(shape)`` ranks if there is none)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    _ensure_group(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def release_mesh() -> None:
    """End the fake group that :func:`make_mesh` started, if any; a real
    group is left as it is."""
    if _FAKE["world"] is not None and dist.is_initialized():
        dist.destroy_process_group()
    _FAKE["world"] = None


@contextlib.contextmanager
def mesh_scope(shape: Sequence[int], axes: Sequence[str]):
    """:func:`make_mesh` for the block, its fake group (if it started one)
    ended after it."""
    started = not dist.is_initialized()
    mesh = make_mesh(shape, axes)
    try:
        yield mesh
    finally:
        if started:
            release_mesh()


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*production_shape(multi_pod))


def make_host_mesh(data: int = 1, model: int = 1):
    """Small ``("data", "model")`` mesh (tests / examples)."""
    return make_mesh((data, model), ("data", "model"))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_size(mesh) -> int:
    s = mesh_axis_sizes(mesh)
    return s.get("data", 1) * s.get("pod", 1)


def tp_size(mesh) -> int:
    return mesh_axis_sizes(mesh).get("model", 1)
