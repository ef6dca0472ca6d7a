"""Atomic, asynchronous checkpoints in the JAX package's on-disk layout.

The port's copy of ``repro.checkpoint.ckpt``. A checkpoint directory::

    <dir>/step_000123/
        manifest.json       # step, time, extra, and per leaf: key, index, shape, dtype
        arrays/<index>.npy  # one file per leaf (the full logical array)

Leaves are keyed by their path in JAX's flatten order
(``convert.keyed_leaves``): ``0/embed``, ``0/layers/attn/wq`` (every layer's
tensor stacked on a leading L axis), ``1/mu/...`` and ``1/count`` for the
``(params, opt_state)`` pair the training loop saves. The trees may be the
port's (``layers`` a list of per-layer dicts, stacked by
``convert.tree_to_jax``) or already in the JAX layout, and their leaves
torch tensors (NumPy arrays in the JAX layout);
so the JAX package reads what the port writes, and the other way round.

* **atomic**: written to ``step_X.tmp`` then renamed;
* **async**: :class:`AsyncCheckpointer` copies the tensors to the host when
  called, then writes on a background thread;
* **retention**: the last ``keep`` checkpoints are kept.

bfloat16: NumPy has no such dtype here (the JAX package writes
``ml_dtypes.bfloat16``, whose ``.npy`` loads back as 2-byte voids), so the
port writes a bf16 leaf as its 16 bits in the same 2-byte void form,
records ``"dtype": "bfloat16"`` as JAX does, and reads either side's bf16
leaves through an int16 view. :func:`restore` takes ``device=`` where the
JAX version takes ``shardings=``: the re-layout onto a mesh is not ported.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.convert import keyed_leaves, map_tree, tree_to_jax, unflatten_keyed


def _host_array(leaf) -> tuple:
    """(a NumPy array of ``leaf``'s bits, bf16 as 2-byte voids; the dtype's
    name)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16).view("V2"), "bfloat16"
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic save. Returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    manifest = {"step": step, "time": time.time(), "extra": extra or {}, "leaves": []}
    for i, (key, leaf) in enumerate(keyed_leaves(tree_to_jax(tree))):
        arr, dtype = _host_array(leaf)
        np.save(os.path.join(tmp, "arrays", f"{i}.npy"), arr)
        manifest["leaves"].append(
            {"key": key, "index": i, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomicity boundary
    _retain(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Snapshot-on-call, write-on-thread. One in-flight save at a time."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()

        def snap(x):  # a host copy now, so training may go on writing x
            return x.detach().to("cpu", copy=True) if torch.is_tensor(x) else np.array(x)

        host_tree = map_tree(snap, tree)

        def _write():
            save(self.ckpt_dir, step, host_tree, extra=extra, keep=self.keep)

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: Optional[int], like: Any, device=None) -> tuple:
    """Restore into the structure of ``like`` (a tree as :func:`save` takes
    it; only its structure, shapes and dtypes are read). Every leaf comes
    back as a tensor on ``device`` (the card unless ``device="cpu"``), in
    ``like``'s dtype where ``like`` has one, else the saved dtype; a layer
    leaf of a per-layer tree comes back as rows of one stacked tensor.
    Returns (tree, manifest). Raises ``KeyError`` for a key the checkpoint
    lacks and ``ValueError`` for a leaf of another shape."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    values = []
    for key, leaf in keyed_leaves(like):
        meta = by_key[key]
        t = _load(os.path.join(d, "arrays", f"{meta['index']}.npy"), meta["dtype"])
        first = leaf[0] if isinstance(leaf, list) else leaf
        if hasattr(first, "shape"):
            want = ((len(leaf),) if isinstance(leaf, list) else ()) + tuple(first.shape)
            if tuple(t.shape) != want:
                raise ValueError(f"checkpoint leaf {key}: shape {tuple(t.shape)}, expected {want}")
        if torch.is_tensor(first) and first.dtype != t.dtype:
            t = t.to(first.dtype)
        values.append(t.to(dev))
    return unflatten_keyed(like, values), manifest


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
