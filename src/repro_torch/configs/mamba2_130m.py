"""mamba2-130m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280, norm="rms", tie_embeddings=True,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, conv_kernel=4,
    ssm_chunk=256,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="mamba2-130m-smoke", n_layers=2, d_model=64,
        vocab=128, ssm_state=16, ssm_headdim=16, ssm_chunk=8)
