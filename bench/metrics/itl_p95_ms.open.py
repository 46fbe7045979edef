"""itl_p95_ms.open (engine): the 95th percentile of the gaps between
consecutive output tokens that end in the window, across all requests,
with each decoding request's gap still open at the close."""
from benchlib.window import percentile, token_gaps


def read(ctx):
    if ctx.serve is None:
        return None
    r = ctx.serve
    p = percentile(token_gaps(r.lines, r.t_open, r.t_close), 95)
    return None if p is None else p * 1e3
