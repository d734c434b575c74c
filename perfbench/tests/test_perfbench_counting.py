"""The yardstick's counts against the bounds PERF.md's kernel table gives
(NVIDIA H100 SXM peaks: 3.35 TB/s, 989 TFLOP/s bf16)."""
import pytest

from perfbench.harness import counting as c

HYMBA = dict(n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
             head_dim=64, d_ff=5504, vocab=32001, window=1024,
             attn_pattern="global3", ssm_state=16, ssm_headdim=64,
             ssm_expand=2, ssm_chunk=128)


@pytest.mark.parametrize("S,window", [(1, 0), (5, 2), (300, 64), (2048, 1024),
                                      (100, 1000)])
def test_attn_pairs_closed_form(S, window):
    loop = sum(min(q + 1, window) for q in range(S)) if window > 0 \
        else S * (S + 1) // 2
    assert c.attn_pairs(S, True, window) == loop


@pytest.mark.parametrize("shape,want,by", [
    ((1, 256, 25, 5, 64, 1024), 0.000587, "bytes"),      # S=256 w1024
    ((2, 2048, 25, 5, 64, 1024), 0.0204, "operations"),  # training shape
    ((2, 2048, 25, 5, 64, 0), 0.0272, "operations"),     # global window
])
def test_flash_bounds(shape, want, by):
    ms, got_by = c.bound(*c.flash_call(*shape), "bfloat16")
    assert got_by == by and ms == pytest.approx(want, rel=5e-3)


@pytest.mark.parametrize("B,S,want", [(1, 256, 0.00106), (1, 2048, 0.0080),
                                      (2, 2048, 0.0161)])
def test_ssd_bounds(B, S, want):
    ms, by = c.bound(*c.ssd_call(B, S, 50, 64, 16, 128), "bfloat16")
    assert by == "bytes" and ms == pytest.approx(want, rel=1e-2)


def test_model_flops():
    n = c.matmul_params(HYMBA)
    assert n == pytest.approx(1.589e9, rel=2e-3)
    f = c.train_flops(HYMBA, 4, 2048)
    assert 6 * n * 4 * 2048 < f < 1.1 * 6 * n * 4 * 2048
    # a prefill costs what its tokens' decodes would, within attention
    S = 512
    pre = c.prefill_flops(HYMBA, S)
    dec = sum(c.decode_flops(HYMBA, k) for k in range(1, S + 1))
    assert pre == pytest.approx(dec - 2 * HYMBA["d_model"] *
                                HYMBA["vocab"] * (S - 1), rel=0.02)
