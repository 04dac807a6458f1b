"""Rows of requests over rows dispatched to the device, padding included
(the batcher's ``rows_valid`` / ``rows_dispatched`` over the run's window
and its drain)."""


def read(ctx):
    disp = ctx.counters.get("rows_dispatched", 0)
    return 100.0 * ctx.counters.get("rows_valid", 0) / disp if disp else None
