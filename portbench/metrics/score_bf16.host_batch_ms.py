"""score_bf16.host_batch_ms: the scorer's host batch step, ms a batch, from
the program's span ``score.host_batch`` (``GLOBAL_METRICS``: host clock on
the background thread, padding a batch and writing its bytes into pinned
memory), its growth over the traced window divided by the batches run
there."""

SPAN = "seconds:score.host_batch"


def read(ctx):
    seconds, batches = ctx.program.get(SPAN), ctx.work.get("batches")
    if not seconds or not batches:
        return None
    return 1e3 * seconds / batches
