"""eref.phase_a_s: Phase A's seconds a sample, from the program's own
stage record ``eref.count_reads`` (``GLOBAL_METRICS``: host clock from the
first read to a synchronize after the last update), its growth over the
traced window divided by the samples run there."""

STAGE = "seconds:eref.count_reads"


def read(ctx):
    seconds, samples = ctx.program.get(STAGE), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
