"""eref.k4_roofline: K4 (Phase B's fused scan, ``scan_chunk``) at its
least time over its device time, in %.

K4 is bound by bytes (its work is integer hashing, for which the data
sheet gives no rate).  Its bytes a Phase B, each counted once: 0.375 B a
reference position of 2-bit codes and invalid bits in, 0.125 B of good
flags out, 24 B of offsets a reference, and one table byte for each of
the three hashes of every k-mer of ACGT.  Positions are the references'
own, not the padding of the program's length buckets.
"""

KERNELS = ("scan_chunk_kernel",)


def nbytes(positions: float, refs: float, kmers: float) -> float:
    return positions * 3 / 8 + positions / 8 + 24 * refs + 3 * kmers


def read(ctx):
    device_s = ctx.trace.kernel_s(KERNELS)
    w = ctx.work
    if device_s is None or not w.get("positions"):
        return None
    least = nbytes(w["positions"], w["refs"], w["kmers"]) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least / device_s
