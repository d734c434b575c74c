"""Mamba-2 SSD chunk scan: CUDA kernel, model entry and plain versions."""
