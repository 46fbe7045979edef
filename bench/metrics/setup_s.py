"""setup_s: process start to the opening of the window (the build on a
checkout's first run, weights, warm-up, lead-in traffic or checked
steps), on the host clock."""


def read(ctx):
    return ctx.setup_s
