"""The flash-attention kernels' share of their roofline in the traced
engine steps: the least time the attention those steps sent to the
kernel needs (bytes or operations, whichever bounds, at the card's
peaks; counted from the shapes) over the device time of the kernel's
launches, in percent.

A prefill launches the kernel once a layer.  Decode attends in plain
PyTorch today and launches none; where it launches the kernel, once a
layer a step for every slot or once a layer a slot, its work is counted
too: a decoded token's query over the keys and values of its context.
Decode is bound by bytes, so one launch over all slots needs what its
slots need one by one.  Any other count of launches is left unread, and
said so on standard error."""

KERNELS = ("fa_tc_fwd", "fa_fwd")


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    c, n = ctx.config, ctx.count
    us = ctx.trace.kernel_us(*KERNELS)
    if not us:
        return None
    heads = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    wins = n.layer_windows(c)
    L = len(wins)
    lens = ctx.trace_info["prefill_lens"]
    steps = [s for s in ctx.trace_info["decode_ctx"] if s]
    toks = [k for s in steps for k in s]
    need = sum(n.bound(*n.flash_call(1, S, *heads, w), "bfloat16")[0]
               for S in lens for w in wins)
    dec = sum(n.bound(*n.decode_attn(k, *heads, w), "bfloat16")[0]
              for k in toks for w in wins)
    layouts = {L * len(lens): 0.0}
    if toks:
        layouts.setdefault(L * (len(lens) + len(steps)), dec)
        layouts.setdefault(L * (len(lens) + len(toks)), dec)
    if len(us) not in layouts:
        ctx.log(f"flash_roofline.serve not read: {len(us)} launches of "
                f"{KERNELS}, where {len(lens)} prefills and {len(toks)} "
                f"decoded tokens in {len(steps)} steps over {L} layers "
                f"give {sorted(layouts)}")
        return None
    return 100 * (need + layouts[len(us)]) / (sum(us) / 1e3)
