"""Mean wall ms a chunk of normal priority waited in the predictor's
dispatch queue (``dispatch_wait.normal``), over the chunks dispatched."""


def read(ctx):
    st = ctx.stages.get("dispatch_wait.normal")
    if not st or not st["count"]:
        return None
    return 1e3 * st["total_s"] / st["count"]
