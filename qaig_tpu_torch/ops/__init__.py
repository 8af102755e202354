"""Tensor ops of the port: activations, positions, patches, attention
(plain PyTorch and the hand-written CUDA kernels), int8 KV quantization."""
