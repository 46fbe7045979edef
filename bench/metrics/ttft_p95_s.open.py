"""ttft_p95_s.open (engine: the request path of ``launch/engine.py``):
the 95th percentile, over every request due in the window, of its first
token's wall time minus the time it was due; a request with no first
token at the close counts the wait it has had so far."""
from benchlib.window import percentile, ttfts


def read(ctx):
    if ctx.serve is None:
        return None
    r = ctx.serve
    return percentile(ttfts(r.lines, r.t_open, r.t_close), 95)
