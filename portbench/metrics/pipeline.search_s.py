"""pipeline.search_s: seconds a sample in step 3 (the protein hits staged,
the GCN scorer and eref on the card, the references extracted), from the
program's span ``step3.search`` (``GLOBAL_METRICS``: host clock), its
growth over the traced window divided by the samples run there."""

SPAN = "seconds:step3.search"


def read(ctx):
    seconds, samples = ctx.program.get(SPAN), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
