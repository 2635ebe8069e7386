"""score.mfu: the scorer's model FLOPs over the traced window, as a share
of the card's peak in the configuration's dtype.

A contig's FLOPs are its products (two a multiply-add) counted once from
the configuration's widths: the two lifts, the SAGE products that reach
the output, the three convs and the two dense layers.  The contigs are
those the sample scored, not the rows a last batch is padded with.
"""


def flops_per_contig(gcn: dict) -> float:
    d3, f, gd = gcn["hidden_dim"], gcn["fnode_num"], gcn["gcn_dim"]
    cnn, fc, kw = gcn["cnn_dim"], gcn["fc_dim"], gcn["conv_kernel"]
    pn = f * f
    lifts = 2 * (pn * d3) ** 2 + 2 * f * f * d3
    # round 0: both sides; round 1: the p-node side (its f-node side reaches no output)
    sage = (2 * f * d3 * gd + 2 * pn * d3 * gd + 2 * f * gd * gd + 2 * f * d3 * gd
            + 2 * f * gd * gd + 2 * pn * gd * gd)
    convs, length = 0, pn
    for cin in (gd, cnn, cnn):
        length -= kw - 1
        convs += 2 * length * cnn * cin * kw
    dense = 2 * length * cnn * fc + 2 * fc * 2
    return float(lifts + sage + convs + dense)


def read(ctx):
    contigs = ctx.work.get("contigs")
    if not contigs or ctx.window_s <= 0:
        return None
    peak = ctx.peaks["flops_per_s"][ctx.config["score"]["dtype"]]
    return 100.0 * flops_per_contig(ctx.config["gcn"]) * contigs / ctx.window_s / peak
