"""deepseek-67b [dense] — llama-arch GQA [arXiv:2401.02954; hf]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=102400, act="swiglu", norm="rms",
    rope_theta=10_000.0,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="deepseek-67b-smoke", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=128)
