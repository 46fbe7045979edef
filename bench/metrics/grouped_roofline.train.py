"""grouped_roofline.train (kernels: B1's grouped route in
``models/moe.py``): the routed experts' least time for the traced steps'
tokens (tokens x top_k assignments through gate, up and down, forward
and both gradients) over the device time of the grouped kernels."""
from benchlib.flops import expert_least_s

PATTERNS = ("matmul_bf16_wgmma_kernel<false, true>",
            "matmul_bf16_wgmma_kernel<true, true>",
            "matmul_bf16_grouped_short_kernel",
            "matmul_f32_simt_kernel<true,")


def read(ctx):
    t, r = ctx.trace, ctx.train
    if r is None or t is None or not ctx.sizes.experts:
        return None
    ends = r.all_step_ends
    starts = [r.t_open] + ends[:-1]
    steps = sum(1 for s, e in zip(starts, ends)
                if s >= t.wall[0] and e <= t.wall[1])
    busy = t.group_s(PATTERNS)
    if not steps or busy <= 0:
        return None
    return 100.0 * steps * expert_least_s(ctx.sizes, r.tokens_per_step,
                                          ctx.peaks) / busy
