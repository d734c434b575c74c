"""The flash-attention forward kernels' share of their roofline in the
traced training steps: the least time the attention forwards they ran
need (bytes or operations, whichever bounds, at the card's peaks; counted
from the shapes) over the device time of those launches, in percent.
Each pass over the layers launches the kernel once a layer (the forward,
and again in the recompute of a rematerialised layer); any other count
is left unread, and said so on standard error."""

KERNELS = ("fa_tc_fwd", "fa_fwd")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    c, m = ctx.config, ctx.mix
    us = ctx.trace.kernel_us(*KERNELS)
    L = c["n_layers"]
    if not us:
        return None
    if len(us) % L:
        ctx.log(f"flash_roofline.train not read: {len(us)} launches of "
                f"{KERNELS}, not whole passes over {L} layers")
        return None
    need = sum(ctx.count.bound(*ctx.count.flash_call(
        m["batch"], m["seq"], c["n_heads"], c["n_kv_heads"], c["head_dim"], w),
        "bfloat16")[0] for w in ctx.count.layer_windows(c))
    return 100 * need * (len(us) // L) / (sum(us) / 1e3)
