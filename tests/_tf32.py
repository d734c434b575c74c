"""The f32 kernels' three-pass TF32 products, emulated in PyTorch on the
CPU for the kernel tests (``test_torch_flash_attention.py``,
``test_torch_ssd.py``)."""
import torch


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it (10 explicit
    mantissa bits, nearest, ties away from zero): bit operations on an
    int32 view."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm_tf32(a, b, passes):
    """a @ b as the f32 kernels' mma.sync m16n8k8 issues it: k in steps of
    8, each operand split into big = tf32(x) and small = tf32(x - big), and
    small_a.big_b, big_a.small_b, big_a.big_b added in that order to an f32
    accumulator (``passes`` = 3), or big_a.big_b alone (1)."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ab, bb = tf32(ak), tf32(bk)
        if passes == 3:
            out = out + tf32(ak - ab) @ bb
            out = out + ab @ tf32(bk - bb)
        out = out + ab @ bb
    return out
