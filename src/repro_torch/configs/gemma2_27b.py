"""gemma2-27b [dense] — local+global alternating, logit softcaps
[arXiv:2408.00118; hf]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000, act="gelu", norm="rms",
    attn_softcap=50.0, final_softcap=30.0, window=4096, attn_pattern="alt",
    tie_embeddings=True, rope_theta=10_000.0,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="gemma2-27b-smoke", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=128, window=8)
