"""repro_torch.kernels — the hand-written CUDA kernels, their wrappers and
plain PyTorch versions, and the dense-matmul dispatch."""
