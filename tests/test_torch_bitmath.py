"""The port's bit-deterministic reductions against the JAX package's.

Same inputs (numpy, from a seed) through ``repro.core.bitmath`` (eager jnp)
and ``repro_torch.core.bitmath``; results compared as int32 views.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmath as jbm
from repro_torch.core import bitmath as tbm

SENTINEL = 2**30


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


@pytest.mark.parametrize("w", [1, 3, 16, 17, 40])
def test_masked_lane_sum_bitwise(w):
    rng = np.random.default_rng(w)
    rows, limit = 37, 50
    cols = rng.integers(0, limit, size=(rows, w)).astype(np.int32)
    cols[rng.random((rows, w)) < 0.3] = SENTINEL  # masked lanes
    vals = rng.standard_normal((rows, w)).astype(np.float32)
    gathered = rng.standard_normal((rows, w)).astype(np.float32)
    gathered[cols >= limit] = np.inf  # masked lanes must not leak into the sum
    want = jbm.masked_lane_sum(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(gathered), limit)
    got = tbm.masked_lane_sum(torch.from_numpy(cols), torch.from_numpy(vals),
                              torch.from_numpy(gathered), limit)
    _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 31, 100, 1000])
def test_pairwise_sum_bitwise(n):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32) * 1e3
    _bits_equal(tbm.pairwise_sum(torch.from_numpy(x)).numpy(),
                jbm.pairwise_sum(jnp.asarray(x)))


@pytest.mark.parametrize("n", [30, 257, 4096])
def test_bitdot_and_bitnorm_bitwise(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _bits_equal(tbm.bitdot(tx, ty).numpy(), jbm.bitdot(jnp.asarray(x), jnp.asarray(y)))
    _bits_equal(tbm.bitnorm(tx).numpy(), jbm.bitnorm(jnp.asarray(x)))


def test_barred_is_identity():
    x = torch.randn(5)
    assert tbm.barred(x) is x


def test_bitsqrt_is_correctly_rounded():
    """PyTorch's float32 ``sqrt`` on the CPU can be 1 ulp off (the GPU's is
    correctly rounded), so the port's roots go through ``bitsqrt``, which
    must equal the correctly rounded root (numpy's) on every input."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    x = np.abs(rng.standard_normal(n) * np.exp(rng.uniform(-40, 40, n))).astype(np.float32)
    x[:4] = [0.0, 1.0, np.inf, 2.0**-140]  # zero, one, infinity, a subnormal
    _bits_equal(tbm.bitsqrt(torch.from_numpy(x)).numpy(), np.sqrt(x))
    assert tbm.bitsqrt(torch.from_numpy(x)).dtype == torch.float32
