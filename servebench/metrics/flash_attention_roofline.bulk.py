"""The flash attention kernel's share of its roofline: the least time its
calls could take (bytes at HBM bandwidth or the attended pairs' ops at
the TF32 peak, whichever is longer: ``work.flash_call``) over
``flash_kernel``'s device time in the traced window.  The rows the
launches cover follow from their count, as for the scan (every row visits
every member once; every batch full).  Nothing is read when a batch was
padded."""
import re

_CALL = re.compile(r"\bflash_kernel\b")
KINDS = ("attn", "swa", "hybrid")


def read(ctx):
    if ctx.trace is None or ctx.counters.get("padding_efficiency", 0) < 1:
        return None
    d, w, cfg = ctx.devtrace, ctx.work, ctx.cfg
    secs, calls = d.seconds_where(ctx.trace, lambda k: bool(_CALL.search(k)))
    if not calls or secs <= 0:
        return None
    rows = w.rows_from_launches(cfg, calls, KINDS)
    hd = cfg["head_dim"] or cfg["d_model"] // cfg["num_heads"]
    bound = 0.0
    for m in cfg["members"]:
        for r in range(m["num_layers"]):
            kind = cfg["pattern"][r % len(cfg["pattern"])]
            if kind in KINDS:
                window = cfg["sliding_window"] if kind != "attn" else 0
                bound += w.bound_s(*w.flash_call(
                    1, cfg["max_seq"], cfg["num_heads"], cfg["num_kv_heads"],
                    hd, window))
    return 100.0 * rows * bound / secs
