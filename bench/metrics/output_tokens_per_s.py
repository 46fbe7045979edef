"""output_tokens_per_s: output tokens emitted in the window over the
window's seconds."""
from benchlib.window import tokens_in


def read(ctx):
    if ctx.serve is None:
        return None
    r = ctx.serve
    return tokens_in(r.lines, r.t_open, r.t_close) / (r.t_close - r.t_open)
