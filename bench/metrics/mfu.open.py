"""mfu.open (model step): the benchmark's flops of the window's engine
iterations (2 a multiply-add: every real token through the layers'
products, the head on every row whose logits are read, attention over
each token's causal context) over their summed wall time, as a share of
the card's bf16 peak."""
from benchlib.flops import serve_flops


def read(ctx):
    if ctx.serve is None or not ctx.serve.iterations:
        return None
    its = ctx.serve.iterations
    work = sum(serve_flops(ctx.sizes, it.forward()) for it in its)
    secs = sum(it.t1 - it.t0 for it in its)
    return 100.0 * work / secs / ctx.peaks["bf16_flops"]
