"""eref.downsample_s: seconds a sample in the down-sampling ratio's whole
pass over the first FASTQ file, from the program's span
``eref.downsample_ratio`` (``GLOBAL_METRICS``: host clock), its growth
over the traced window divided by the samples run there."""

SPAN = "seconds:eref.downsample_ratio"


def read(ctx):
    seconds, samples = ctx.program.get(SPAN), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
