"""The model scaffolding of every config family (dense and vlm decoders,
MoE with MLA, the hybrid SSM, xLSTM, whisper's encoder-decoder): forward,
loss, remat and cache decode, in plain PyTorch. See ``model`` for the
facade and ``convert`` for the JAX package's parameter tree, both ways."""
