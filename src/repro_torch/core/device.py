"""Device selection for the port's entry points.

The port runs on a CUDA device unless the caller asks for the CPU. The CPU
runs the plain PyTorch version of every kernel; it is what the tests use.
The ``meta`` device (shapes and dtypes, no storage) is what the dry run
builds its cells on; it is taken only when the caller names it.
"""
from __future__ import annotations

import time

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; ``"cpu"`` and ``"meta"`` are taken when
    named. Raises when CUDA is asked for (or implied) and no GPU is present:
    the port never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda', 'cpu' or 'meta', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def warm_apply(apply, n: int, device: torch.device, batch_sizes, group=None) -> dict:
    """The ``warm`` of a preconditioner apply: on a CUDA device one apply on
    zeros per batch size, which loads its kernels before a solve or a CUDA
    graph capture needs them (``group``'s exchange counts are left as they
    were); on the CPU nothing, since the plan and its bound tables are made
    with the apply. Returns {batch_size: seconds}."""
    import time

    out = {}
    for nb in batch_sizes:
        t0 = time.perf_counter()
        if device.type == "cuda":
            counts = None if group is None else group.counts()
            shape = (n,) if nb == 1 else (int(nb), n)
            apply(torch.zeros(shape, dtype=torch.float32, device=device))
            torch.cuda.synchronize(device)
            if group is not None:
                group.set_counts(counts)
        out[int(nb)] = time.perf_counter() - t0
    return out
