"""pipeline.graph_s: seconds a sample in step 4.3, the junction graph built
from the BAM (the native ``palace_native graph``, else ``graph/builder.py``),
from the program's stage record ``stage:graph`` (``GLOBAL_METRICS``: host
clock), its growth over the traced window divided by the samples run
there."""

SPAN = "seconds:stage:graph"


def read(ctx):
    seconds, samples = ctx.program.get(SPAN), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
