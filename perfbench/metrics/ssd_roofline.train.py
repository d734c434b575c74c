"""The SSD forward kernels' share of their roofline in the traced
training steps: the least time the SSD forwards they ran need (bytes or
operations, whichever bounds, at the card's peaks; counted from the
shapes) over the device time of those launches, in percent.  Each pass
over the layers launches the kernel once a layer; any other count is
left unread, and said so on standard error."""

KERNELS = ("ssd_tc_fwd", "ssd_fwd")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    c, m = ctx.config, ctx.mix
    s = ctx.count.ssm_dims(c)
    us = ctx.trace.kernel_us(*KERNELS)
    L = c["n_layers"]
    if s is None or not us:
        return None
    if len(us) % L:
        ctx.log(f"ssd_roofline.train not read: {len(us)} launches of "
                f"{KERNELS}, not whole passes over {L} layers")
        return None
    Hs, P, N, _ = s
    need = ctx.count.bound(*ctx.count.ssd_call(
        m["batch"], m["seq"], Hs, P, N, c.get("ssm_chunk", 128)),
        "bfloat16")[0] * L
    return 100 * need * (len(us) // L) / (sum(us) / 1e3)
