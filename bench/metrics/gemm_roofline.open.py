"""gemm_roofline.open (kernels: B1 through ``kernels/dispatch.py``): the
dense products' least time at the shapes the traced iterations ran (each
layer's q, k, v, o, gate, up and down on the real token rows, the head on
the rows whose logits are read) over the device time of B1's kernels."""
from benchlib.flops import serve_gemm_least_s

PATTERNS = ("matmul_bf16_wgmma_kernel", "matmul_f32_simt_kernel",
            "matmul_splitk_reduce_kernel")


def read(ctx):
    t = ctx.trace
    if ctx.serve is None or t is None:
        return None
    calls = []
    for it in ctx.serve.all_iterations:
        if it.t0 < t.wall[0] or it.t1 > t.wall[1]:
            continue
        if it.chunks:
            calls.append((sum(n for _, n in it.chunks), len(it.chunks)))
        if it.decode:
            calls.append((len(it.decode), len(it.decode)))
    busy = t.group_s(PATTERNS)
    if not calls or busy <= 0:
        return None
    return 100.0 * serve_gemm_least_s(ctx.sizes, calls, ctx.peaks) / busy
