"""score.host_wait_ms: the main thread's wait for the next batch's host
step, ms a batch, from the program's span ``score.host_wait``
(``GLOBAL_METRICS``: host clock around the future's result), its growth
over the traced window divided by the batches run there.  Near 0 while the
device sets the pace; it grows as the host takes the pace over."""

SPAN = "seconds:score.host_wait"


def read(ctx):
    seconds, batches = ctx.program.get(SPAN), ctx.work.get("batches")
    if not seconds or not batches:
        return None
    return 1e3 * seconds / batches
