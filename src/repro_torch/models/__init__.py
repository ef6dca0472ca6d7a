"""The model scaffolding's serving path: dense decoders (and the vlm merge),
prefill and KV-cache decode, in plain PyTorch. See ``model`` for the
facade and ``convert`` for adopting the JAX package's parameters."""
