"""The bf16 kernels' launchers on the CPU: what TMA is handed, the flash
kernel's grid by shape, and the route of a tensor on the card.

The kernels themselves build and run only on a machine with a card
(``chip_smoke.py`` holds them there against the plain versions, and holds
the C launcher's plan to :func:`kernel.plan`); these tests pin the Python
side: an operand TMA cannot read is copied into one it can, never routed
elsewhere; the flash kernel's grid follows ``plan``; and a tensor on the
card goes to the kernel, never to the plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _tma
from repro_torch.kernels.flash_attention import autograd as fa_autograd
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import autograd as ssd_autograd
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops

BF = torch.bfloat16


def test_contiguous_and_fused_views_are_tma_ready():
    """A contiguous [B,S,H,hd] tensor and the q, k, v views of one fused
    projection (the model's) are read in place."""
    assert _tma.ready(torch.zeros((2, 64, 4, 64), dtype=BF))
    B, S, H, KV, hd = 2, 48, 25, 5, 64
    qkv = torch.zeros((B, S, (H + 2 * KV) * hd), dtype=BF)
    views = (qkv[..., :H * hd].view(B, S, H, hd),
             qkv[..., H * hd:(H + KV) * hd].view(B, S, KV, hd),
             qkv[..., (H + KV) * hd:].view(B, S, KV, hd))
    for t in views:
        assert _tma.ready(t)
        assert _tma.operand(t) is t


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((1, 8, 4, 65), dtype=BF)[..., 1:],       # base +2 B
    lambda: torch.zeros((1, 8, 4, 72), dtype=BF)[..., :64],      # ok
    lambda: torch.zeros((1, 8, 5, 12), dtype=BF)[..., :8],       # stride 12
    lambda: torch.zeros((2, 8, 4, 16), dtype=BF).transpose(1, 2),
    lambda: torch.zeros((8, 16), dtype=BF).t(),                  # last dim
])
def test_operand_hands_tma_what_it_reads(make):
    """Whatever the view, ``operand`` returns a tensor TMA can read with
    the same values, copying (and counting the copy) only when it must."""
    t = make()
    before = _tma.copies
    out = _tma.operand(t)
    assert _tma.ready(out) and torch.equal(out, t)
    assert (_tma.copies - before) == (0 if _tma.ready(t) else 1)
    assert (out is t) == _tma.ready(t)


def test_size_one_dims_do_not_count_and_odd_widths_pad():
    """A size-1 dim's stride is never stepped; a width that is not a whole
    number of 16 bytes is zero-padded to one (``last``)."""
    t = torch.zeros((1, 3, 1, 8), dtype=BF).as_strided((1, 3, 1, 8),
                                                        (999, 8, 3, 1))
    assert _tma.ready(t)
    x = torch.randn((2, 5, 3, 5)).to(BF)
    assert not _tma.ready(x)
    p = _tma.operand(x, _tma.round_up(5))
    assert p.shape == (2, 5, 3, 8) and _tma.ready(p)
    assert torch.equal(p[..., :5], x) and not p[..., 5:].any()
    assert [_tma.round_up(n) for n in (1, 7, 8, 9, 64)] == [8, 8, 8, 16, 64]


@pytest.mark.parametrize("shape,want", [
    # hymba's prompt: 55 blocks of 128 rows would leave SMs idle -> split
    ((1, 256, 25, 5), dict(split=True, heads=5, positions=12, blocks=110)),
    ((1, 200, 25, 5), dict(split=True, heads=5, positions=12, blocks=85)),
    # the training shape: 820 blocks of 25 positions x 5 heads
    ((2, 2048, 25, 5), dict(split=False, heads=5, positions=25,
                            blocks=820)),
    ((1, 1536, 25, 5), dict(split=False, heads=5, positions=25,
                            blocks=310)),
    # hubert (no GQA), gemma2 (groups of 2), grok (6), 25 to a KV head
    ((2, 500, 16, 16), dict(split=True, heads=1, positions=64, blocks=256)),
    ((1, 384, 32, 16), dict(split=True, heads=2, positions=32, blocks=192)),
    ((1, 384, 48, 8), dict(split=False, heads=6, positions=21, blocks=152)),
    ((4, 4096, 25, 1), dict(split=False, heads=5, positions=25,
                            blocks=4 * 5 * 164)),
])
def test_flash_plan_by_shape(shape, want):
    assert fa_kernel.plan(*shape, sms=132) == want


def test_flash_plan_rules():
    """Over many shapes: a block's heads divide the group, its rows fit,
    every position of every head is covered once, and it splits exactly
    when the unsplit blocks are fewer than the SMs."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        B, KV = int(rng.integers(1, 4)), int(rng.integers(1, 9))
        H, Sq = KV * int(rng.integers(1, 33)), int(rng.integers(1, 3000))
        sms = int(rng.integers(16, 140))
        p = fa_kernel.plan(B, Sq, H, KV, sms)
        G = H // KV
        assert G % p["heads"] == 0 and p["heads"] <= fa_kernel.MAX_PACKED
        rows = fa_kernel.BLOCK_ROWS // (2 if p["split"] else 1)
        assert p["positions"] == rows // p["heads"]
        assert p["blocks"] == B * KV * (G // p["heads"]) * \
            -(-Sq // p["positions"])
        whole = B * KV * (G // p["heads"]) * \
            -(-Sq // (fa_kernel.BLOCK_ROWS // p["heads"]))
        assert p["split"] == (whole < sms)
    for bad in ((0, 8, 4, 2), (1, 0, 4, 2), (1, 8, 5, 2), (1, 8, 4, 0)):
        with pytest.raises(ValueError):
            fa_kernel.plan(*bad, sms=132)


def test_card_tensors_route_to_the_kernels_never_the_plain_versions(
        monkeypatch):
    """With ``on_card`` true, the model-side entries call the kernel
    launchers and never the plain versions, with and without a gradient
    (bf16 under a gradient: the forward that saves the log-sum-exp)."""
    calls = []

    def kernel_fa(q, k, v, **kw):
        calls.append("flash")
        return torch.zeros_like(q)

    def kernel_fa_lse(q, k, v, **kw):
        calls.append("flash")
        return torch.zeros_like(q), torch.zeros(q.shape[0], q.shape[2],
                                                q.shape[1])

    def kernel_ssd(xs, dt, A, B_, C_, chunk=128):
        calls.append("ssd")
        return (torch.zeros_like(xs),
                torch.zeros(xs.shape[0], xs.shape[2], xs.shape[3],
                            B_.shape[-1]))

    def plain(*a, **kw):
        raise AssertionError("a card tensor reached the plain version")

    monkeypatch.setattr(fa_autograd, "on_card", lambda t: True)
    monkeypatch.setattr(ssd_autograd, "on_card", lambda t: True)
    monkeypatch.setattr(fa_kernel, "flash_attention", kernel_fa)
    monkeypatch.setattr(fa_kernel, "flash_attention_lse", kernel_fa_lse)
    monkeypatch.setattr(ssd_kernel, "ssd", kernel_ssd)
    monkeypatch.setattr(fa_ops, "flash_attention_ref", plain)
    monkeypatch.setattr(fa_autograd, "flash_attention_ref", plain)
    monkeypatch.setattr(ssd_ops, "ssd_chunked", plain)
    monkeypatch.setattr(ssd_autograd, "ssd_chunked", plain)
    q = torch.randn((1, 16, 4, 16)).to(BF)
    k = torch.randn((1, 16, 2, 16)).to(BF)
    pos = torch.arange(16).expand(1, 16)
    args = (torch.randn((1, 16, 2, 16)).to(BF), torch.rand((1, 16, 2)),
            -torch.rand(2), torch.randn((1, 16, 8)).to(BF),
            torch.randn((1, 16, 8)).to(BF))
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            qq = q.clone().requires_grad_(grad)
            fa_ops.flash_attention(qq, k, k, pos, pos)
            xs = args[0].clone().requires_grad_(grad)
            ssd_ops.ssd(xs, *args[1:], 8)
    assert calls == ["flash", "ssd", "flash", "ssd"]


def test_kernels_refuse_the_cpu_and_meta():
    """The launchers themselves take the card only: a CPU or meta tensor
    raises before anything is built or launched."""
    for dev in ("cpu", "meta"):
        q = torch.zeros((1, 8, 2, 16), dtype=BF, device=dev)
        before = fa_kernel.launches
        with pytest.raises(ValueError, match="CUDA"):
            fa_kernel.flash_attention(q, q, q)
        xs = torch.zeros((1, 8, 2, 16), dtype=BF, device=dev)
        dt = torch.zeros((1, 8, 2), device=dev)
        A = torch.zeros(2, device=dev)
        Bm = torch.zeros((1, 8, 8), dtype=BF, device=dev)
        with pytest.raises(ValueError, match="CUDA"):
            ssd_kernel.ssd(xs, dt, A, Bm, Bm, chunk=8)
        assert fa_kernel.launches == before
