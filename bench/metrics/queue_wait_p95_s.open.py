"""queue_wait_p95_s.open (admission: the engine's ``_admit`` and the
scheduler's ``reserve``): the 95th percentile, over requests due in the
window, of the wall time from due to admission into a slot."""
from benchlib.window import percentile, queue_waits


def read(ctx):
    if ctx.serve is None:
        return None
    r = ctx.serve
    return percentile(queue_waits(r.lines, r.t_open, r.t_close), 95)
