"""The model scaffolding: dense decoders (and the vlm merge), their
forward, loss, remat and KV-cache decode, in plain PyTorch. See ``model``
for the facade and ``convert`` for the JAX package's parameter tree, both
ways."""
