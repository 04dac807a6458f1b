"""Median latency of every request due in the window, each timed from when
it was due to its answer (host clock); a request that failed counts as the
slowest."""


def read(ctx):
    lat = [r.latency_s for r in ctx.requests if ctx.t0 <= r.due < ctx.t1]
    return 1e3 * ctx.stats.percentile(lat, 50) if lat else None
