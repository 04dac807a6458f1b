#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, one JSON line each; any failed phase exits non-zero:

1. environment: the card's name and power limit, TF32 off for matmuls and
   convolutions (the references are full f32);
2. build: the Hopper kernels from ``src/repro_torch/kernels/csrc``;
3. one phase per kernel: the kernel against its plain PyTorch version on the
   card over the JAX test suite's cases and the serving path's shapes, with
   the stated tolerance, and its time beside the plain version's, the
   library call's (a yardstick only, the port never calls it) and its bound;
4. end to end at full width: ``InferenceSystem`` on one card, ``combine=
   "pallas"``, ``use_kernel=True``, serving qwen3-1.7b (28 layers, fp32) and
   the same widths at 14 layers as an int8 member, with random weights from
   ``--seed``.  Four concurrent requests of 40 rows; ``Y`` is held against
   each member's plain forward on the card combined in numpy, and the launch
   counts must show that every kernel ran and no plain version did.

The line before the last holds the card's name and power limit; before it,
the per-kernel summary line.  The last line is ``{"ok": true, "device":
...}``.  Without a CUDA card, or without the package beside this file, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12              # f32 on the CUDA cores (all three kernels'
                               # arithmetic is f32)

FLASH_CASES = [                # (b, s, h, kv, hd, window, dtype) — JAX suite
    (2, 64, 4, 2, 32, 0, "float32"),
    (1, 128, 4, 4, 64, 0, "float32"),
    (2, 96, 8, 2, 80, 32, "float32"),
    (1, 256, 4, 1, 128, 64, "float32"),
    (1, 200, 2, 2, 48, 0, "float32"),
    (2, 64, 4, 2, 64, 0, "bfloat16"),
    (16, 256, 16, 8, 128, 0, "float32"),   # serving path, member 0 chunk
    (8, 256, 16, 8, 128, 0, "float32"),    # serving path, member 1 chunk
]
COMBINE_CASES = [(4, 128, 100), (12, 44, 91), (3, 128, 1000), (1, 7, 13),
                 (2, 32, 151936), (1, 32, 151936), (1, 8, 151936)]
QUANT_CASES = [(1, 8, 512), (3, 40, 512), (2, 128, 640), (1, 32, 151936),
               (1, 8, 151936)]
MAIN_FLASH = (16, 256, 16, 8, 128)
MAIN_SEG, MAIN_C = 32, 151936
MAX_FLIP_SHARE = 0.01          # int8 code flips allowed in the served Y


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(torch, got, want, tol: float) -> float:
    """Max |got - want|; fails unless |got-want| <= tol + tol*|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        fail("non-finite kernel output")
    if (err > tol + tol * want.abs()).any():
        fail(f"max abs error {err.max().item():.3g} over tolerance {tol}")
    return err.max().item()


# ---------------------------------------------------------------------------
def phase_flash(torch, gen, dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    cases = []
    main = None
    for b, s, h, kv, hd, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
        scale = float(torch.tensor(hd ** -0.5, dtype=dtype))
        qs = (q * scale).contiguous()
        out = fa.flash_attention(qs, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(qs, k, v, causal=True, window=window,
                                       scale=1.0)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        err = close(torch, out, want, tol)
        case = {"shape": [b, s, h, kv, hd], "window": window, "dtype": dt,
                "max_abs_err": err, "tol": tol}
        if (b, s, h, kv, hd) == MAIN_FLASH:
            main = (qs, k, v, err)
        cases.append(case)
    qs, k, v, err = main
    b, s, h, kv, hd = MAIN_FLASH
    ms = time_ms(torch, lambda: fa.flash_attention(qs, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
        qs, k, v, causal=True, scale=1.0))
    # library yardstick: one SDPA call on the same inputs (never used by the
    # port); it wants (B, H, S, hd) with the kv heads expanded
    import torch.nn.functional as F
    qt = qs.transpose(1, 2)
    kt, vt = (t.repeat_interleave(h // kv, dim=2).transpose(1, 2)
              for t in (k, v))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=1.0))
    pairs = b * h * s * (s + 1) // 2              # causal (q, k) pairs
    nbytes = 4 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    bound_ms, bound_by = bound(nbytes, 4.0 * pairs * hd, F32_FLOPS)
    emit({"phase": "kernel:flash_attention", "cases": cases, "ok": True,
          "main_shape": list(MAIN_FLASH), "ms": ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by})
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:95",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def phase_combine(torch, gen, dev):
    from repro_torch.kernels import ensemble_combine as ec
    from repro_torch.kernels import ref
    cases = []
    main = None
    for m, seg, c in COMBINE_CASES:
        p = torch.randn((m, seg, c), generator=gen, device=dev)
        w = torch.softmax(torch.randn((m,), generator=gen, device=dev), 0)
        part = torch.randn((seg, c), generator=gen, device=dev)
        fresh = ec.ensemble_combine(p, w)
        err_f = close(torch, fresh, ref.ensemble_combine_ref(p, w), 1e-5)
        want = ref.ensemble_accumulate_ref(part, p, w)
        acc = ec.ensemble_combine(p, w, part)
        err_a = close(torch, acc, want, 1e-5)
        inplace = part.clone()                   # the combiner's usage
        ec.ensemble_combine(p, w, inplace, out=inplace)
        err_i = close(torch, inplace, want, 1e-5)
        torch.cuda.synchronize()
        cases.append({"shape": [m, seg, c], "fresh_err": err_f,
                      "accumulate_err": err_a, "in_place_err": err_i,
                      "tol": 1e-5})
        if (m, seg, c) == (1, MAIN_SEG, MAIN_C):
            main = (p, w, part, max(err_a, err_i))
    p, w, part, err = main
    out = torch.empty_like(part)
    ms = time_ms(torch, lambda: ec.ensemble_combine(p, w, part, out=out))
    plain_ms = time_ms(torch, lambda: ref.ensemble_accumulate_ref(part, p, w))
    w0 = w[0].item()
    lib_ms = time_ms(torch, lambda: torch.add(part, p[0], alpha=w0, out=out))
    n = MAIN_SEG * MAIN_C
    bound_ms, bound_by = bound(4 * (3 * n + 1), 2.0 * n, F32_FLOPS)
    emit({"phase": "kernel:ensemble_combine", "cases": cases, "ok": True,
          "main_shape": [1, MAIN_SEG, MAIN_C], "ms": ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by})
    return {"name": "ensemble_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ensemble_combine.cu",
            "replaces": "src/repro/kernels/ensemble_combine.py:143",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def phase_quant(torch, gen, dev):
    from repro_torch.kernels import ensemble_combine as ec
    from repro_torch.kernels import quant as kq
    from repro_torch.kernels import ref
    cases = []
    main = None
    for qdt in ("int8", "fp8"):
        for m, seg, c in QUANT_CASES:
            logits = torch.randn((m, seg, c), generator=gen, device=dev) * 4.0
            part = torch.randn((seg, c), generator=gen, device=dev)
            w = 0.1 + 0.9 * torch.rand((m,), generator=gen, device=dev)
            qs = [kq.quantize_symmetric(x, axis=-1, dtype=qdt) for x in logits]
            q = torch.stack([a for a, _ in qs])
            s = torch.stack([b[:, 0] for _, b in qs])
            want = ref.ensemble_accumulate_quant_ref(part, q, s, w)
            got = ec.ensemble_combine_quant(part, q, s, w)
            err = close(torch, got, want, 1e-4)
            inplace = part.clone()
            ec.ensemble_combine_quant(inplace, q, s, w, out=inplace)
            err_i = close(torch, inplace, want, 1e-4)
            torch.cuda.synchronize()
            cases.append({"dtype": qdt, "shape": [m, seg, c],
                          "max_abs_err": err, "in_place_err": err_i,
                          "tol": 1e-4})
            if qdt == "int8" and (m, seg, c) == (1, MAIN_SEG, MAIN_C):
                main = (part, q, s, w, max(err, err_i))
    part, q, s, w, err = main
    out = torch.empty_like(part)
    ms = time_ms(torch, lambda: ec.ensemble_combine_quant(part, q, s, w,
                                                          out=out))
    plain_ms = time_ms(torch, lambda: ref.ensemble_accumulate_quant_ref(
        part, q, s, w))
    n = MAIN_SEG * MAIN_C
    nbytes = n * 1 + 4 * MAIN_SEG + 4 * 2 * n + 4
    bound_ms, bound_by = bound(nbytes, 3.0 * n, F32_FLOPS)
    emit({"phase": "kernel:ensemble_combine_quant", "cases": cases,
          "ok": True, "main_shape": [1, MAIN_SEG, MAIN_C], "ms": ms,
          "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
          "bound_by": bound_by})
    return {"name": "ensemble_combine_quant", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ensemble_combine.cu",
            "replaces": "src/repro/kernels/ensemble_combine.py:108",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------------------------------------
def tree_bytes(tree) -> int:
    from repro_torch.kernels.quant import tree_map
    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
        return t
    tree_map(add, tree)
    return total[0]


def serve(system, X, n_req: int, rows: int):
    """Send ``n_req`` concurrent requests of ``rows`` rows; returns (Y,
    wall seconds, per-request latency in ms).  Completion times are the
    accumulator's own (``latency_s``, taken as it finishes a request)."""
    import numpy as np
    t0 = time.perf_counter()
    handles = [system.predict_async(X[i * rows:(i + 1) * rows])
               for i in range(n_req)]
    try:
        Y = np.concatenate([h.result(600.0) for h in handles])
    except TimeoutError:
        fail("requests did not complete within 600 s")
    done_at = [h.req.t_submit + h.latency_s for h in handles]
    return Y, max(done_at) - t0, [1e3 * h.latency_s for h in handles]


def profile_served(torch, system, X, n_req: int, rows: int) -> None:
    """The same requests again under torch.profiler: device time by kernel
    and the device's busy share of the window (one stream, so kernel times
    add up without overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(system, X, n_req, rows)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    emit({"phase": "profile", "window_s": window,
          "device_busy_s": busy_us * 1e-6,
          "device_busy_share": busy_us * 1e-6 / window,
          "top": [{"name": e.key[:90], "device_ms": dev_us(e) * 1e-3,
                   "calls": e.count} for e in top]})


def phase_end_to_end(torch, seed: int, smi: str, profile: bool = False):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as kq
    from repro_torch.models import init_params
    from repro_torch.models.transformer import hidden, logits_from_hidden
    from repro_torch.serving import InferenceSystem

    dev = torch.device("cuda", 0)
    cfg0 = get_config("qwen3-1.7b")
    cfg1 = dataclasses.replace(cfg0, name="qwen3-1.7b-l14", num_layers=14)
    cfgs = [cfg0, cfg1]
    t0 = time.perf_counter()
    params = [init_params(cfg0, seed, dev), init_params(cfg1, seed + 1, dev)]
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    alloc = AllocationMatrix(cuda_devices()[:1], [c.name for c in cfgs],
                             np.array([[16, 8]]))
    max_seq, seg, n_req, rows = 256, 32, 4, 40
    t0 = time.perf_counter()
    system = InferenceSystem(cfgs, params, alloc, combine="pallas",
                             use_kernel=True, max_seq=max_seq,
                             segment_size=seg,
                             member_dtypes=["fp32", "int8"])
    del params
    t_build = time.perf_counter() - t0
    try:
        member_bytes = [tree_bytes(w.params) for w in system.workers]
        rng = np.random.default_rng(seed)
        X = rng.integers(0, cfg0.vocab_size, (n_req * rows, max_seq)
                         ).astype(np.int32)
        torch.cuda.synchronize()
        ops.reset_counts()                   # counts cover the served run
        Y, wall, lat_ms = serve(system, X, n_req, rows)
        launches = ops.kernel_launches()
        plain = ops.plain_calls()
        counters = system.serving_counters()
        stages = {k: v["total_s"] for k, v in system.stage_timings().items()}
        if profile:
            profile_served(torch, system, X, n_req, rows)
        weights = [float(x) for x in system.accumulator.weights]
        workers = system.workers
        # plain reference on the card: each member's plain forward on the
        # worker's own parameters (the int8 member's wrapped tree, the same
        # dequantized weights), int8 logit quantization for member 1
        ref_logits, scales = [], None
        with torch.no_grad():
            tok = torch.from_numpy(X).to(dev)
            for i, (cfg, w) in enumerate(zip(cfgs, workers)):
                parts = []
                for lo in range(0, len(X), 16):
                    x = hidden(w.params, cfg, tok[lo:lo + 16],
                               use_kernel=False)
                    lg = logits_from_hidden(w.params, cfg, x[:, -1])
                    parts.append(lg[:, :cfg.vocab_size].float())
                lg = torch.cat(parts)
                if i == 1:
                    q, s = kq.quantize_symmetric(lg, axis=-1)
                    lg = kq.dequantize(q, s)
                    scales = s[:, 0].cpu().numpy()
                ref_logits.append(lg.cpu().numpy())
    finally:
        system.shutdown()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    Y_ref = weights[0] * ref_logits[0] + weights[1] * ref_logits[1]
    if Y.shape != (n_req * rows, cfg0.vocab_size):
        fail(f"Y shape {Y.shape}")
    if not np.isfinite(Y).all():
        fail("non-finite Y")
    atol = 1e-4 * max(1.0, float(np.abs(Y_ref).max()))
    # A logit of the int8 member on a rounding edge may flip its code by one
    # between the two paths, which moves that element of Y by exactly one
    # step, w1*s_row.  So every element must lie within atol of Y_ref + k*step
    # with k in {-1, 0, 1}, and at most MAX_FLIP_SHARE of them with k != 0:
    # any other fault (a wrong weight, a lower-precision forward) leaves
    # errors that are not whole steps.
    diff = Y - Y_ref
    step = (weights[1] * scales)[:, None]
    k = np.rint(diff / step)
    resid = np.abs(diff - k * step)
    flips = int((k != 0).sum())
    bad = (resid > atol) | (np.abs(k) > 1)
    if bad.any():
        fail(f"Y vs plain reference: {int(bad.sum())} elements off by more "
             f"than atol {atol:.3g} from a whole int8 step, max residual "
             f"{resid.max():.3g}")
    if flips > MAX_FLIP_SHARE * Y.size:
        fail(f"Y vs plain reference: {flips} int8 code flips, over "
             f"{MAX_FLIP_SHARE:.0%} of {Y.size} elements")
    if any(plain.values()):
        fail(f"plain versions ran on the served path: {plain}")
    # every dispatched chunk runs one flash launch per layer of its member
    min_flash = cfg0.num_layers * math.ceil(n_req * rows / 16) + \
        cfg1.num_layers * math.ceil(n_req * rows / 8)
    if launches["flash_attention"] < min_flash:
        fail(f"flash_attention launched {launches['flash_attention']} < "
             f"{min_flash} times")
    for name in ("ensemble_combine", "ensemble_combine_quant"):
        if launches[name] < 1:
            fail(f"{name} never launched on the served path")
    emit({"phase": "end_to_end", "ok": True, "card": smi,
          "members": [c.name for c in cfgs], "member_dtypes": ["fp32", "int8"],
          "allocation": [[16, 8]], "requests": n_req, "rows_per_request": rows,
          "max_seq": max_seq, "segment_size": seg,
          "rows_per_s": n_req * rows / wall, "wall_s": wall,
          "latency_ms": lat_ms, "p50_ms": float(np.percentile(lat_ms, 50)),
          "p99_ms": float(np.percentile(lat_ms, 99)),
          "member_param_gb": [b / 1e9 for b in member_bytes],
          "peak_device_gb": peak_gb, "init_s": t_init, "system_build_s": t_build,
          "max_abs_err": float(np.abs(diff).max()), "atol": atol,
          "max_residual": float(resid.max()), "int8_step_max": float(
              step.max()), "int8_flips": flips, "elements": int(Y.size),
          "launches": launches, "plain_calls": plain,
          "batches": counters.get("batches"), "stage_total_s": stages,
          "padding_efficiency": counters.get("padding_efficiency")})
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="serve the requests a second time under "
                         "torch.profiler and print device time by kernel")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "environment", "card": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.BUILD_DIR.relative_to(ROOT))})

    # 3. kernels
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    kernels = [phase_flash(torch, gen, dev), phase_combine(torch, gen, dev),
               phase_quant(torch, gen, dev)]

    # 4. end to end
    launches = phase_end_to_end(torch, args.seed, smi, args.profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
