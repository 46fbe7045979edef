"""decode_ms_per_step.open (step execution): the program's
``StepExecutor.t_decode / PagedScheduler.decode_steps`` over the window,
host wall time that ends in the argmax read."""


def read(ctx):
    if ctx.serve is None or not ctx.serve.counters["decode_steps"]:
        return None
    c = ctx.serve.counters
    return 1e3 * c["t_decode"] / c["decode_steps"]
