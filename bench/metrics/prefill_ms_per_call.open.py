"""prefill_ms_per_call.open (step execution): the program's
``StepExecutor.t_prefill / prefill_calls`` over the window, host wall
time that ends in the argmax read."""


def read(ctx):
    if ctx.serve is None or not ctx.serve.counters["prefill_calls"]:
        return None
    c = ctx.serve.counters
    return 1e3 * c["t_prefill"] / c["prefill_calls"]
