"""eref.pack_s: seconds a sample in Phase A's packing on the host (a short
batch padded, then ``pack_codes_mask``), from the program's span
``eref.pack`` (``GLOBAL_METRICS``: host clock), its growth over the traced
window divided by the samples run there."""

SPAN = "seconds:eref.pack"


def read(ctx):
    seconds, samples = ctx.program.get(SPAN), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
