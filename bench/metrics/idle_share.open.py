"""idle_share.open (device): the share of the traced stretch in which no
kernel ran."""


def read(ctx):
    t = ctx.trace
    if ctx.serve is None or t is None:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
