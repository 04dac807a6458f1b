"""Device ms of the members' matrix products (cuBLAS GEMM and GEMV
kernels) in the traced window, per row served in it."""


def read(ctx):
    if ctx.trace is None or not ctx.rows_per_s:
        return None
    s, n = ctx.devtrace.seconds_where(ctx.trace, ctx.devtrace.is_matmul)
    if not n:
        return None
    return 1e3 * s / (ctx.rows_per_s * ctx.trace["window_s"])
