"""pipeline.depth_read_s: seconds a sample in ``DepthStore.read_text``, the
depth file read back line by line for steps 4-6, on the host clock of the
benchmark's own timer around each call (the driver's ``depth_read_s``,
counted from the window's start), divided by the samples run there."""

KEY = "depth_read_s"


def read(ctx):
    seconds, samples = ctx.work.get(KEY), ctx.work.get("samples")
    if not seconds or not samples:
        return None
    return seconds / samples
