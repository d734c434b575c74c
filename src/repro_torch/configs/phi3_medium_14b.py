"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab=100352, act="swiglu", norm="rms",
    rope_theta=10_000.0,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="phi3-medium-14b-smoke", n_layers=3, d_model=60,
        n_heads=5, n_kv_heads=5, head_dim=12, d_ff=128, vocab=128)
