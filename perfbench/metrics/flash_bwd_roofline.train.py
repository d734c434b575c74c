"""The flash-attention backward kernel's share of its roofline in the
traced training steps: the least time the attention backwards of those
steps need (bytes or operations, whichever bounds, at the card's bf16
peaks) over the device time of the launches whose name holds
``fa_tc_bwd``, in percent.

The bound of one backward is a frozen rule, written here and not in
``counting.py``: 10 operations a kept (q, k) pair, head dim and query
head (Q.K^T again, then dV, dP, dK and dQ); bytes of q, the output, its
gradient and dq (B S H hd each) and of k, v, dk and dv (B S KV hd each),
each once at 2 bytes, and the log-sum-exp at 4 bytes a row (4 B H S).
Summed over the layers' windows, once a step, with the steps from
``trace_info``.  Each step's backward runs whole passes over the layers,
the same number of launches in each layer; any other count is left
unread, and said so on standard error."""

KERNELS = ("fa_tc_bwd",)
A_BYTES = 2


def backward_call(B, S, H, KV, hd, window, attn_pairs):
    """(bytes, ops) of one causal self-attention backward in bf16."""
    nbytes = (4 * B * S * H * hd + 4 * B * S * KV * hd) * A_BYTES \
        + 4 * B * H * S
    return nbytes, 10 * B * H * hd * attn_pairs(S, True, window)


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    c, m, n = ctx.config, ctx.mix, ctx.count
    us = ctx.trace.kernel_us(*KERNELS)
    if not us:
        return None
    wins = n.layer_windows(c)
    steps = ctx.trace_info["steps"]
    if len(us) % (len(wins) * steps):
        ctx.log(f"flash_bwd_roofline.train not read: {len(us)} launches of "
                f"{KERNELS} in {steps} steps, not whole passes over "
                f"{len(wins)} layers")
        return None
    need = sum(n.bound(*backward_call(
        m["batch"], m["seq"], c["n_heads"], c["n_kv_heads"], c["head_dim"],
        w, n.attn_pairs), "bfloat16")[0] for w in wins)
    return 100 * need * steps / (sum(us) / 1e3)
