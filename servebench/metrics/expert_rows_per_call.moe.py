"""Rows a held expert computes in a dropless MoE layer call: the
assignments computed on this card over the calls times the experts held,
from the program's device counters (``moe_assignments.m<i>``,
``moe_calls.m<i>``) summed over the members."""


def read(ctx):
    m = ctx.cfg.get("moe") or {}
    held = m.get("experts_held") or m.get("num_experts")
    n = len(ctx.cfg["members"])
    calls = sum(ctx.counters.get(f"moe_calls.m{i}", 0.0) for i in range(n))
    rows = sum(ctx.counters.get(f"moe_assignments.m{i}", 0.0)
               for i in range(n))
    if not calls or not held:
        return None
    return rows / (calls * held)
