"""internvl2-26b [vlm] — InternLM2-20B backbone, ViT patch-embedding stub
(256 precomputed vision tokens) [arXiv:2404.16821; hf]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553, act="swiglu", norm="rms",
    frontend="vision", n_vision_tokens=256, rope_theta=10_000.0,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="internvl2-26b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
        n_vision_tokens=4)
