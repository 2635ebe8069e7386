"""score.k2_roofline: K2 (the two SAGE rounds, ``sage_rounds``) at its
least time over its device time, in %.

The least time of one call on a batch is the larger of its FLOPs (the
products that reach its output, counted once: round 0's on both sides,
round 1's on the p-nodes) at the dtype's peak and its bytes (the lifted
p- and f-nodes and the weights read once, the (B, 4096, 128) p-nodes
written once) at the memory rate.  Its device time is that of the
kernels named below.
"""

KERNELS = ("sage_tf32_kernel", "sage_mma_kernel")
ITEM = {"float32": 4, "bfloat16": 2, "float16": 2}


def flops(batch: int, f: int, d3: int, gd: int) -> float:
    """The rounds on a batch of f f-nodes and f*f p-nodes of d3 features,
    to gd."""
    pn = f * f
    per = (2 * f * d3 * gd + 2 * pn * d3 * gd + 2 * f * gd * gd + 2 * f * d3 * gd
           + 2 * f * gd * gd + 2 * pn * gd * gd)
    return float(batch * per)


def nbytes(batch: int, f: int, d3: int, gd: int, item: int) -> float:
    pn = f * f
    x_in = batch * (pn + f) * d3
    weights = d3 * gd * 3 + gd * gd * 3 + 5 * gd   # the rounds' weights, biases, LayerNorm
    return float((x_in + weights + batch * pn * gd) * item)


def least_s(gcn: dict, batch: int, dtype: str, peaks: dict) -> float:
    shape = (batch, gcn["fnode_num"], gcn["hidden_dim"], gcn["gcn_dim"])
    return max(flops(*shape) / peaks["flops_per_s"][dtype],
               nbytes(*shape, ITEM[dtype]) / peaks["hbm_bytes_per_s"])


def read(ctx):
    device_s = ctx.trace.kernel_s(KERNELS)
    if device_s is None or not ctx.work.get("batches"):
        return None
    dtype = ctx.config["score"]["dtype"]
    return 100.0 * ctx.work["batches"] * least_s(ctx.config["gcn"], ctx.work["batch_rows"],
                                                 dtype, ctx.peaks) / device_s
