"""Model FLOPs of the window's training steps (3x the forward: matmul
weights, attention by each layer's window, SSD; the recompute of
rematerialised layers not counted) over the window's seconds at the
card's bf16 peak, in percent."""


def read(ctx):
    if ctx.kind != "train":
        return None
    w = ctx.window
    return 100 * w["flops"] / (w["seconds"] * ctx.count.PEAK_OPS_PER_S["bfloat16"])
