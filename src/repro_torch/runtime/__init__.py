"""Fault tolerance and straggler mitigation (a copy of the JAX package's
``repro.runtime``, which imports no JAX)."""
