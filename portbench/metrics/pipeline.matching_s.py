"""pipeline.matching_s: seconds a sample in step 4.5, the matching solver
over the filtered graph (``solve_graph_file``) and its result files, from
the program's stage record ``stage:matching`` (``GLOBAL_METRICS``: host
clock), its growth over the traced window divided by the samples run
there."""

SPAN = "seconds:stage:matching"


def read(ctx):
    seconds, samples = ctx.program.get(SPAN), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
