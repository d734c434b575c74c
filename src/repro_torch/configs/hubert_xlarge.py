"""hubert-xlarge [audio] — encoder-only; precomputed frame-embedding stub
frontend [arXiv:2106.07447]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, act="gelu", norm="ln", causal=False,
    frontend="audio", frontend_dim=512,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="hubert-xlarge-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=64,
        frontend_dim=32)
