"""PyTorch + CUDA port of the bit-compatible ILU(k) system in ``repro``.

``repro_torch.core`` holds the host planning (NumPy copies of the JAX
package's planners) and the device path; ``repro_torch.kernels`` holds the
hand-written CUDA kernels for Hopper, their plain PyTorch versions and
their wrappers. The package imports neither ``jax`` nor ``repro``.
"""
