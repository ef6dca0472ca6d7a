"""Device selection for the port's entry points.

The port runs on a CUDA device unless the caller asks for the CPU. The CPU
runs the plain PyTorch version of every kernel; it is what the tests use.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for (or implied)
    and no GPU is present: the port never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
