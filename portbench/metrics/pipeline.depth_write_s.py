"""pipeline.depth_write_s: seconds a sample in step 4.2, the depth file
written from the BAM (the native ``palace_native depth``, else the Python
pass), from the program's stage record ``stage:depth`` (``GLOBAL_METRICS``:
host clock), its growth over the traced window divided by the samples run
there."""

SPAN = "seconds:stage:depth"


def read(ctx):
    seconds, samples = ctx.program.get(SPAN), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
