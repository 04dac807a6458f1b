"""Rows a second served in the window (host clock): each answered request's
rows, in the share of its time from due to answer that lies inside the
window, over the window's length (``stats.completion_rate``)."""


def read(ctx):
    return ctx.rows_per_s
