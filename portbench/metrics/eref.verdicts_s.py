"""eref.verdicts_s: seconds a sample in Phase B's verdicts on the host (each
chunk's ``unpack_good`` and ``hit_from_good`` over its rows), from the
program's span ``eref.verdicts`` (``GLOBAL_METRICS``: host clock), its
growth over the traced window divided by the samples run there."""

SPAN = "seconds:eref.verdicts"


def read(ctx):
    seconds, samples = ctx.program.get(SPAN), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
