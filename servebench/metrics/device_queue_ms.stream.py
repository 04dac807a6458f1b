"""Mean wall ms from the start of a chunk's enqueue to the start of its
forward on the device: its wait behind earlier work on the one compute
stream (``device_queue.m<member>``, every member's chunks pooled;
recorded while tracing is on, on the card only).  Read only from a traced
run in which the card worked.  The harness reads the stages once the
traffic has drained, after the profiler stopped; a sample ends at a
device timestamp, so a stall of the host after the chunk's start event
is recorded does not stretch it."""


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    total = count = 0
    for name, st in ctx.stages.items():
        if name.startswith("device_queue.m"):
            total += st["total_s"]
            count += st["count"]
    return 1e3 * total / count if count else None
