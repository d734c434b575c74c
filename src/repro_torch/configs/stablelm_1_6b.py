"""stablelm-1.6b [dense] — MHA (kv=32) [hf:stabilityai/stablelm-2-1_6b]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352, act="swiglu", norm="ln",
    rope_theta=10_000.0,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="stablelm-1.6b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=128)
