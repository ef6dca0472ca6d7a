"""CUDA kernels for Hopper (``csrc/``), their build (``build.py``), their
plain PyTorch versions (``ref.py``) and their wrappers (``ops.py``)."""
