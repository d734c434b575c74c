"""Flash-attention forward: CUDA kernel, model entry and plain version."""
