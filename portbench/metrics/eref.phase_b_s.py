"""eref.phase_b_s: Phase B's seconds a sample, from the program's own
stage record ``eref.scan_refs`` (``GLOBAL_METRICS``: host clock over
``search_references``, launches, fetches and verdicts), its growth over
the traced window divided by the samples run there."""

STAGE = "seconds:eref.scan_refs"


def read(ctx):
    seconds, samples = ctx.program.get(STAGE), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
