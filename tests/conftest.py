"""Shared pytest config: markers + environment gating.

``pallas_compiled`` marks tests that exercise the *compiled* (non-interpret)
Pallas lowering. This container's CPU CI can only run Pallas in interpret
mode, so those tests skip cleanly unless either

* ``REPRO_PALLAS_INTERPRET=0`` — real TPU hardware, the compiled lowering
  is live (the same env toggle the kernel wrappers in
  ``repro.kernels.ops`` consume), or
* ``REPRO_PALLAS_FORCE_INTERPRET=1`` — the CI interpret leg: the marked
  tests *run*, but every ``pallas_call`` (including explicit
  ``interpret=False`` requests) is substituted with interpret mode by
  ``repro.kernels.config.resolve_interpret``. This exercises the compiled
  tests' call paths, schedules, and bitwise assertions on CPU; only the
  Mosaic lowering itself is mocked out.
"""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "pallas_compiled: requires the compiled (non-interpret) Pallas "
        "lowering; skipped unless REPRO_PALLAS_INTERPRET=0 (TPU hardware) "
        "or REPRO_PALLAS_FORCE_INTERPRET=1 (CI interpret leg).",
    )
    config.addinivalue_line(
        "markers",
        "slow: long-running test (soaks, end-to-end sweeps); always in "
        "tier-1, deselectable with -m 'not slow' for quick local loops.",
    )
    config.addinivalue_line(
        "markers",
        "cuda: runs a CUDA kernel of the PyTorch port on a GPU; skips (from "
        "inside the test) where torch.cuda.is_available() is false.",
    )
    config.addinivalue_line(
        "markers",
        "reference_fault: documents a place where the JAX reference itself "
        "leaves its arithmetic contract; the port is held to the contract.",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("REPRO_PALLAS_INTERPRET", "1") == "0":
        return  # hardware run: compiled-mode tests are live
    if os.environ.get("REPRO_PALLAS_FORCE_INTERPRET", "0") == "1":
        return  # CI interpret leg: compiled-mode tests run interpreted
    skip = pytest.mark.skip(
        reason="compiled Pallas lowering unavailable on CPU CI "
        "(set REPRO_PALLAS_INTERPRET=0 on TPU hardware, or "
        "REPRO_PALLAS_FORCE_INTERPRET=1 to run these in interpret mode)"
    )
    for item in items:
        if "pallas_compiled" in item.keywords:
            item.add_marker(skip)
