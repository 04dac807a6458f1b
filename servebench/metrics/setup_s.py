"""Seconds from the process's start to the window's: imports, weights made
on the card, the system built and its workers warmed, the kernel library
built where the checkout has none yet, and the mix's warm-up requests."""


def read(ctx):
    return ctx.setup_s
