"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072, act="gelu", norm="rms",
    n_experts=8, top_k=2, expert_d_ff=32768,
    attn_softcap=30.0, final_softcap=30.0, rope_theta=10_000.0,
    # group-wise dispatch is a win here too; capacity-row sharding is NOT
    # (EXPERIMENTS.md §Perf cell D: confirmed flops fix, net wire loss) —
    # moe_cap_shard stays False pending a shard_map manual-a2a dispatch.
    moe_groups=32,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="grok-1-314b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
        n_experts=4, top_k=2, expert_d_ff=64)
