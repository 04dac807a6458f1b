"""The whole step's share of the card's peak: model FLOPs of a row (both
members' products, the scan's and attention's algorithmic ops, the head
on the last position; ``work.pair_flops_per_row``) times the rows a
second completed in the traced window, over the TF32 tensor-core peak."""


def read(ctx):
    if ctx.trace is None or not ctx.rows_per_s:
        return None
    flops = ctx.work.pair_flops_per_row(ctx.cfg) * ctx.rows_per_s
    return 100.0 * flops / ctx.work.PEAK_TF32_FLOPS
