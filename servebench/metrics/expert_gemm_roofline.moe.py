"""The grouped expert GEMM's share of its roofline: the least time a launch
could take (its bytes at HBM bandwidth or its products at a third of the
TF32 peak, the 3xTF32 rate, whichever is longer) over the mean device time
of a ``gemm_tf32x3_grouped_kernel`` launch in the traced window.

A dropless MoE layer call launches the kernel three times (gate and up
over K = d, down over K = d_ff_expert).  The rows of a call are the
program's device counters, per member: ``moe_assignments.m<i>`` over
``moe_calls.m<i>``.  Work per launch comes from the counters and time per
launch from the trace, so the ratio does not depend on where either
starts or stops."""
import re

_KERNEL = re.compile(r"\bgemm_tf32x3_grouped_kernel\b")
LAUNCHES_PER_CALL = 3


def grouped_call(rows: float, k: int, n: int, experts: int):
    """(bytes, ops) of one launch over ``rows`` grouped rows of ``experts``
    experts: each expert's (k, n) weights, the rows' inputs read once and
    their outputs written once; 2 ops a multiply-add."""
    nbytes = 4 * (experts * k * n + rows * k + rows * n)
    return nbytes, 2 * rows * k * n


def call_bound_s(work, cfg: dict, rows: float) -> float:
    """The least time of one MoE layer call's three launches."""
    d, m = cfg["d_model"], cfg["moe"]
    f, held = m["d_ff_expert"], m.get("experts_held") or m["num_experts"]
    total = 0.0
    for k, n in ((d, f), (d, f), (f, d)):
        nbytes, ops = grouped_call(rows, k, n, held)
        total += max(nbytes / work.HBM_BYTES_PER_S,
                     3 * ops / work.PEAK_TF32_FLOPS)
    return total


def read(ctx):
    if ctx.trace is None:
        return None
    secs, launches = ctx.devtrace.seconds_where(
        ctx.trace, lambda k: bool(_KERNEL.search(k)))
    calls = bound = 0.0
    for i in range(len(ctx.cfg["members"])):
        c = ctx.counters.get(f"moe_calls.m{i}", 0.0)
        if c > 0:
            rows = ctx.counters.get(f"moe_assignments.m{i}", 0.0) / c
            calls += c
            bound += c * call_bound_s(ctx.work, ctx.cfg, rows)
    if not launches or secs <= 0 or not calls:
        return None
    return 100.0 * (bound / (LAUNCHES_PER_CALL * calls)) / (secs / launches)
