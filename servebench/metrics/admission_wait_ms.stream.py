"""Mean wall ms from ``predict_async``'s entry to the request's last
descriptor queued (``admission_wait``): brownout planning, the admission
budget, the in-flight window, the submit lock and the striping.  Read
only from a traced run in which the card worked.  The harness reads the
stages once the traffic has drained, after the profiler stopped; every
request is admitted before then, so the stop stretches no sample."""


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    st = ctx.stages.get("admission_wait")
    if not st or not st["count"]:
        return None
    return 1e3 * st["total_s"] / st["count"]
