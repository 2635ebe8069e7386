"""score_bf16.dispatch_ms: the main thread's dispatch of a batch, ms a
batch, from the program's span ``score.dispatch`` (``GLOBAL_METRICS``: host
clock over the copy to the card, K1 and the forward's launches, and any wait
for the card among them), its growth over the traced window divided by the
batches run there."""

SPAN = "seconds:score.dispatch"


def read(ctx):
    seconds, batches = ctx.program.get(SPAN), ctx.work.get("batches")
    if not seconds or not batches:
        return None
    return 1e3 * seconds / batches
