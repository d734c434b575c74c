"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6,
layer-0 dense [arXiv:2405.04434; hf]."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab=102400, act="swiglu", norm="rms",
    n_experts=160, n_shared_experts=2, top_k=6, expert_d_ff=1536,
    first_dense_d_ff=12288,
    use_mla=True, q_lora=1536, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, rope_theta=10_000.0,
    # tuned defaults from EXPERIMENTS.md §Perf cell B (baseline = moe_groups
    # 1 / capacity 1.25, preserved in runs/dryrun): 4.6x less collective wire
    moe_groups=32, moe_capacity=1.0,
)


def smoke_config():
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-236b-smoke", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32, vocab=128,
        n_experts=8, n_shared_experts=1, top_k=2, expert_d_ff=32,
        first_dense_d_ff=96, q_lora=48, kv_lora=32, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16)
