"""Device ms of everything that is neither a matrix product, nor one of the
program's own kernels, nor a copy between host and device (norms,
elementwise ops, the int8 member's dequantize and quantize, device copies,
the conv) in the traced window, per row served in it."""


def read(ctx):
    if ctx.trace is None or not ctx.rows_per_s:
        return None
    d = ctx.devtrace
    s, n = d.seconds_where(ctx.trace, lambda k: not (
        d.is_matmul(k) or d.is_port_kernel(k) or d.is_transfer(k)))
    if not n:
        return None
    return 1e3 * s / (ctx.rows_per_s * ctx.trace["window_s"])
