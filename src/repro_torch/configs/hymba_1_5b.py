"""hymba-1.5b [hybrid] — parallel attn+mamba heads, SWA except 3 global
layers, ssm_state=16 [arXiv:2411.13676; hf]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, act="swiglu", norm="rms",
    window=1024, attn_pattern="global3",
    ssm_state=16, ssm_headdim=64, ssm_expand=2, conv_kernel=4,
    rope_theta=10_000.0,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="hymba-1.5b-smoke", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
        window=8, ssm_state=8, ssm_headdim=16, ssm_chunk=8)
