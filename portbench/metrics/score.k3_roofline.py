"""score.k3_roofline: K3 (the conv head, ``conv_head``) at its least time
over its device time, in %.

The least time of one call on a batch is the larger of its FLOPs (the
three convs' products, counted once) at the dtype's peak and its bytes
(the input activations, weights and biases read once, the last conv's
output written once) at the memory rate.  Its device time is that of the
kernels named below in the trace: the float32 route's weight split and
tensor-core kernel, the bfloat16 one's.
"""

KERNELS = ("conv_tf32_kernel", "conv_mma_kernel", "split_weights_kernel")
ITEM = {"float32": 4, "bfloat16": 2, "float16": 2}


def flops(batch: int, channels: int, length: int, cout: int, kw: int) -> float:
    """The head on (batch, channels, length): three valid convs of width
    ``kw`` to ``cout`` channels."""
    total = 0
    for cin in (channels, cout, cout):
        length -= kw - 1
        total += 2 * batch * length * cout * cin * kw
    return float(total)


def nbytes(batch: int, channels: int, length: int, cout: int, kw: int, item: int) -> float:
    params = cout * channels * kw + 2 * cout * cout * kw + 3 * cout
    out = batch * cout * (length - 3 * (kw - 1))
    return float((batch * channels * length + params + out) * item)


def least_s(gcn: dict, batch: int, dtype: str, peaks: dict) -> float:
    shape = (batch, gcn["gcn_dim"], gcn["fnode_num"] ** 2, gcn["cnn_dim"], gcn["conv_kernel"])
    return max(flops(*shape) / peaks["flops_per_s"][dtype],
               nbytes(*shape, ITEM[dtype]) / peaks["hbm_bytes_per_s"])


def read(ctx):
    device_s = ctx.trace.kernel_s(KERNELS)
    if device_s is None or not ctx.work.get("batches"):
        return None
    dtype = ctx.config["score"]["dtype"]
    return 100.0 * ctx.work["batches"] * least_s(ctx.config["gcn"], ctx.work["batch_rows"],
                                                 dtype, ctx.peaks) / device_s
