"""eref.reader_s: seconds a sample in Phase A's reader (each batch from the
native loader or the Python reader), from the program's span ``eref.read``
(``GLOBAL_METRICS``: host clock), its growth over the traced window
divided by the samples run there."""

SPAN = "seconds:eref.read"


def read(ctx):
    seconds, samples = ctx.program.get(SPAN), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
