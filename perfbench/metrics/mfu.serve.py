"""Model FLOPs of the tokens the window's engine steps produced (each
prefill's projections, MLP and causal attention and its last position's
output head; each decoded token's weights and attention over its context)
over the window's seconds at the card's bf16 peak, in percent."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    w = ctx.window
    return 100 * w["flops"] / (w["seconds"] * ctx.count.PEAK_OPS_PER_S["bfloat16"])
