"""Model configuration covering all assigned architecture families.

A copy of ``repro.models.config.ModelConfig``, kept field for field so a
config means the same model in both packages.  The port ignores
``attn_impl``: it picks a kernel or its plain version from the device of
the tensors.  Configs live in ``repro_torch/configs/<arch>.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    vocab: int
    # attention (H=0 for attention-free archs)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    # mlp
    d_ff: int = 0
    act: Literal["swiglu", "gelu"] = "swiglu"
    norm: Literal["rms", "ln"] = "rms"
    rope_theta: float = 10_000.0
    # gemma2-style extras
    attn_softcap: float = 0.0          # 0 = off
    final_softcap: float = 0.0
    window: int = 0                    # sliding-window size; 0 = full attention
    # per-layer attention pattern: "full", "alt" (local/global alternating),
    # "global3" (global at first/middle/last, SWA elsewhere)
    attn_pattern: str = "full"
    causal: bool = True                # False => encoder-only (hubert)
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    moe_capacity: float = 1.25
    first_dense_d_ff: int = 0          # deepseek-v2: layer 0 is dense
    # MLA (deepseek-v2)
    use_mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    # modality frontends (stubs per assignment)
    frontend: Literal["none", "audio", "vision"] = "none"
    frontend_dim: int = 0              # audio: raw frame feature dim
    n_vision_tokens: int = 0           # vlm: precomputed patch embeddings
    # numerics / perf knobs
    dtype: str = "bfloat16"
    remat: str = "block"               # none | block | full
    attn_impl: str = "xla"             # xla | pallas | pallas_interpret
    scan_layers: bool = True
    attn_probs_bf16: bool = False      # bf16 P·V accumulate (perf knob)
    moe_groups: int = 1                # group-wise dispatch (shard-local
    #                                    capacity/cumsum, GShard-style)
    moe_cap_shard: bool = False        # tensor-mode MoE: shard capacity
    #                                    rows over DP (saves 9x flops, costs
    #                                    a2a wire — §Perf cell D trade)
    # optimizer-relevant size helpers ------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Megatron-style vocab padding to a shardable multiple of 256."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def has_attn(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if decode cost per token is o(S) in context length S for all
        (or all but O(1)) layers — gate for the long_500k shape."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True  # SWA + 3 global layers (documented in DESIGN.md)
        return False

    def layer_windows(self) -> list[int]:
        """Per-layer attention window (0 = full/global)."""
        if not self.has_attn:
            return [0] * self.n_layers
        if self.attn_pattern == "alt":
            return [self.window if i % 2 == 0 else 0
                    for i in range(self.n_layers)]
        if self.attn_pattern == "global3":
            g = {0, self.n_layers // 2, self.n_layers - 1}
            return [0 if i in g else self.window
                    for i in range(self.n_layers)]
        return [self.window] * self.n_layers

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameters (analytic; embeddings included once if tied)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        n = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.has_attn:
            if self.use_mla:
                qd = self.qk_nope_dim + self.qk_rope_dim
                per_layer += d * self.q_lora + self.q_lora * self.n_heads * qd
                per_layer += d * (self.kv_lora + self.qk_rope_dim)
                per_layer += self.kv_lora * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                per_layer += self.n_heads * self.v_head_dim * d
            else:
                hd = self.head_dim
                per_layer += d * self.n_heads * hd          # q
                per_layer += 2 * d * self.n_kv_heads * hd   # k, v
                per_layer += self.n_heads * hd * d          # o
        if self.has_ssm:
            di, g, N = self.d_inner, 1, self.ssm_state
            conv_dim = di + 2 * g * N
            per_layer += d * (2 * di + 2 * g * N + self.n_ssm_heads)
            per_layer += self.conv_kernel * conv_dim
            per_layer += 3 * self.n_ssm_heads               # A, D, dt_bias
            per_layer += di * d
        if self.n_experts:
            e_ff = self.expert_d_ff
            per_layer += self.n_experts * 3 * d * e_ff      # routed (swiglu)
            per_layer += self.n_shared_experts * 3 * d * e_ff
            per_layer += d * self.n_experts                 # router
        elif self.d_ff:
            mult = 3 if self.act == "swiglu" else 2
            per_layer += mult * d * self.d_ff
        per_layer += 2 * d                                  # norms
        n += L * per_layer
        if self.first_dense_d_ff:  # deepseek-v2 layer-0 dense replaces MoE
            e_ff = self.expert_d_ff
            moe_l0 = (self.n_experts + self.n_shared_experts) * 3 * d * e_ff \
                + d * self.n_experts
            n += 3 * d * self.first_dense_d_ff - moe_l0
        if self.frontend == "audio":
            n += self.frontend_dim * d
        return int(n)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        inactive_per_layer = (self.n_experts - self.top_k) * 3 * d * \
            self.expert_d_ff
        n_inactive = self.n_layers * inactive_per_layer
        if self.first_dense_d_ff:
            n_inactive -= inactive_per_layer
        return int(self.param_count() - n_inactive)
