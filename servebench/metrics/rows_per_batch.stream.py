"""Rows of requests per batch dispatched (the batcher's ``rows_valid`` /
``batches``), over every member's batches."""


def read(ctx):
    b = ctx.counters.get("batches", 0)
    return ctx.counters.get("rows_valid", 0) / b if b else None
