"""attn_roofline.open (kernels: B2 paged decode and B3 paged prefill
attention): the traced iterations' attention least time (each sequence's
keys and values read once, queries read and outputs written; products
over the causal context) over the device time of the attention
kernels."""
from benchlib.flops import attn_least_s

PATTERNS = ("decode_split_kernel", "decode_combine_kernel",
            "prefill_wgmma_kernel", "prefill_combine_kernel",
            "prefill_simt_kernel")


def read(ctx):
    t = ctx.trace
    if ctx.serve is None or t is None:
        return None
    least = sum(attn_least_s(ctx.sizes, it.forward(), ctx.peaks)
                for it in ctx.serve.all_iterations
                if it.t0 >= t.wall[0] and it.t1 <= t.wall[1])
    busy = t.group_s(PATTERNS)
    if least <= 0 or busy <= 0:
        return None
    return 100.0 * least / busy
