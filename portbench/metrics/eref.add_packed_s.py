"""eref.add_packed_s: seconds a sample in Phase A's ``add_packed`` calls
(uploads, the unpack and hash launches, and ``torch.unique``'s wait for
its size), from the program's span ``eref.add_packed``
(``GLOBAL_METRICS``: host clock), its growth over the traced window
divided by the samples run there."""

SPAN = "seconds:eref.add_packed"


def read(ctx):
    seconds, samples = ctx.program.get(SPAN), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
