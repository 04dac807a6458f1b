"""The whole step's share of the card's peak, as ``mfu.bulk`` reads it:
model FLOPs of a row (``work.pair_flops_per_row``, the family module's
``layer_flops``: the router over every expert, the held experts' expected
work and the shared expert) times the rows a second completed in the
traced window, over the TF32 tensor-core peak."""


def read(ctx):
    if ctx.trace is None or not ctx.rows_per_s:
        return None
    flops = ctx.work.pair_flops_per_row(ctx.cfg) * ctx.rows_per_s
    return 100.0 * flops / ctx.work.PEAK_TF32_FLOPS
