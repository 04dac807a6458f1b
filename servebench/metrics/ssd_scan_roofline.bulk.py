"""The SSD scan kernel's share of its roofline: the least time its calls
could take (each call's bytes at HBM bandwidth or its ops at the TF32
peak, whichever is longer: ``work.ssd_call``) over the scan kernels'
device time in the traced window.

A call is one launch of ``ssd_kernel`` (tensor-core route, after its
scores pass) or ``ssd_core_kernel`` (CUDA-core route).  Every row visits
every member once, and in these cells every batch is full, so a member of
batch b and L scan layers makes L/b launches a row, each over its batch:
the rows a launch covers follow from the launch count.  Nothing is read
when a batch was padded (padding efficiency under 1)."""
import re

_CALL = re.compile(r"\bssd_(core_)?kernel\b")
_ANY = re.compile(r"\bssd_\w*kernel\b")


def read(ctx):
    if ctx.trace is None or ctx.counters.get("padding_efficiency", 0) < 1:
        return None
    d, w, cfg = ctx.devtrace, ctx.work, ctx.cfg
    _, calls = d.seconds_where(ctx.trace, lambda k: bool(_CALL.search(k)))
    secs, _ = d.seconds_where(ctx.trace, lambda k: bool(_ANY.search(k)))
    if not calls or secs <= 0:
        return None
    rows = w.rows_from_launches(cfg, calls, ("ssm", "hybrid"))
    di, n, p, h, _ = w.ssm_dims(cfg)
    nbytes, ops = w.ssd_call(1, cfg["max_seq"], h, p, n, cfg["ssm"]["chunk"])
    layers_rows = rows * sum(w.kernel_layers(cfg, m["num_layers"],
                                             ("ssm", "hybrid"))
                             for m in cfg["members"])
    return 100.0 * layers_rows * w.bound_s(nbytes, ops) / secs
