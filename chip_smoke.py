#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, one JSON line each; any failed phase exits non-zero:

1. environment: the card's name and power limit, TF32 off for matmuls and
   convolutions (the references are full f32);
2. build: the Hopper kernels from ``src/repro_torch/kernels/csrc``;
3. one phase per kernel: the kernel against its plain PyTorch version on the
   card over the JAX test suite's cases and the main path's shapes, with
   the stated tolerance, and its time beside the plain version's, the
   library call's (a yardstick only, the port never calls it) and its bound.
   ``ms`` and ``library_ms`` are device times: 20 calls captured in a CUDA
   graph and replayed between two events, kernel and library call in turns
   (kernel, library, library, kernel), so the host's speed does not enter.
   ``enqueued_ms`` is the older reading, 20 calls launched from Python
   between two events: what a host-driven caller sees, and no lower than
   the wrapper's own cost, ``host_us`` (a host clock around 1,000 calls
   with no synchronise inside, over 1,000).  ``plain_ms`` is enqueued.
   ``ensemble_combine`` is timed in the form the combiner calls, a fold in
   place into the partial, against ``torch.add`` in place, each call on the
   next of four sets of operands so that none is read from L2.  Flash, the
   scan and decode are timed at qwen3's and hymba's served shapes; flash
   and the scan also give their error against float64 beside the plain
   version's and one TF32 pass's;
4. end to end at full width, one phase per member pair: ``InferenceSystem``
   on one card, ``combine="pallas"``, ``use_kernel=True``, an fp32 member
   and the same widths at half the layers as an int8 member, with random
   weights from ``--seed``: qwen3-1.7b (28 + 14 layers), mamba2-1.3b (48 +
   24, SSM layers), hymba-1.5b (32 + 16, hybrid attention + SSM layers),
   granite-moe-3b-a800m (32 + 16, MoE with the capacity dispatch) and
   llama-3.2-vision-11b at full width cut to 10 + 5 layers (two and one
   units of 4 self + 1 cross-attention layer), fed one seeded frontend row
   repeated.  Four concurrent requests of 40 rows each; every row of ``Y``
   is held against each member's plain forward on the card, 16 rows at a
   time, combined in numpy, and the launch counts must show that each
   attention or hybrid layer ran the flash kernel and each SSM or hybrid
   layer the scan kernel once per chunk, that the combine kernels ran, and
   that no plain version did.  The capacity dispatch makes a row's answer
   depend on the other row of its 512-token group and jump where a near
   tie of the router flips between the flash kernel and the plain
   attention, so for granite the plain forward runs on the workers' own
   batches with the served run's expert choices replayed layer by layer;
   a second plain run with its own choices reports the rows rerouted and
   the router's margin where they part.  Each system is shut down and its
   memory freed before the next pair;
5. generation at full width, one phase per model: ``prefill`` of a random
   prompt and 64 greedy ``decode_step``s with ``use_kernel=True``, batch
   16, fp32, random weights from ``--seed``: qwen3-1.7b (1024-token prompt,
   2048 slots), hymba-1.5b (992 tokens, 2048 slots: the 1024-slot window
   ring wraps), mamba2-1.3b (512 tokens, 1024 slots) and hymba-1.5b again
   with an int8 KV cache, teacher-forced on the fp32 run's tokens, then
   granite-moe-3b-a800m (512 tokens, 1024 slots) and llama-3.2-vision-11b
   at 10 layers (512 tokens, 1024 slots, with the frontend).  The logits are
   held against the plain forward of prompt + generated tokens (not for
   granite: its capacity dispatch groups the tokens of a prefill and of a
   decode step otherwise than a full forward does) and against the plain
   decode path, the int8 run's against the fp32 run's; the launch counts
   must show one decode-attention launch per self-attention or hybrid
   layer per step (none with the int8 cache; a cross-attention layer
   decodes densely, as in the JAX package), one scan per SSM or hybrid
   layer of the prefill, and no plain version;
6. ``alloc:ENS4``: the paper's allocation procedure on this card for the
   four members of ENS4: worst-fit-decreasing on ``cuda_devices()``, then
   the bounded greedy scoring each matrix with ``MeasuredBench`` (the
   torch system in Benchmark Mode, with its defaults: no kernels, the
   "mean" combine) under ``MemoBench``.  It prints both matrices, their
   rows/s, the matrices evaluated and the greedy's speedup over its start.
7. ``control:qwen3``: qwen3-1.7b at full width in fp32 and the same
   widths at 14 layers in int8, trees built on the host, on two cells of
   this card (``cuda_cells(2)``, allocation [[16, 8], [16, 0]]: member 0
   has an instance on each cell), ``combine="pallas"``, ``use_kernel=True``,
   supervised.  Four concurrent requests of 8 rows through
   ``serve(system, port=0)`` and an ``EnsembleClient`` over HTTP (with the
   JSON encode and decode of one answer timed on the host) beside the same
   rows in process; a burst of the pair phase's traffic at rest; the same
   burst while ``ReconfigController.apply`` rebatches member 0 on cell 1
   to 8 (a new generation is spawned and the old instance drained: the
   device GB before, after the spawn and after the drain, which must
   return at least member 0's tree); the same burst again while the new
   instance's sender is killed on its next chunk (one quarantine, its
   units replayed on the sibling, no request failed); then the
   ``LiveBench`` snapshot.  Every row of every answer is held to the
   members' plain forwards on the card as in the pair phase, and the
   launch counts must show flash per attention layer per chunk, both
   combine kernels and no plain version;
8. ``brownout:qwen3``: a second system on the same host trees, one cell,
   ``combine="weighted"``, member 0 slowed by a repeating ``slow`` fault,
   an admission budget of one burst's bytes and a ``LiveBench`` attached
   (``set_profiler``), warmed by one burst.  With the next burst in
   flight an HTTP request is refused with 429 and a ``Retry-After`` from
   ``retry_after_s``; with the ``BrownoutController`` running the burst
   after it is demoted in flight: those requests complete with quality
   under 1, their forgiven rows held to the int8 member's plain forward
   alone and the others to the full combine;
9. ``launch:ENS4``: ``python -m repro_torch.launch.serve --ensemble ENS4
   --cells 2 --bench analytic --port 0 --duration 20 --reconfig
   --brownout`` as a subprocess on this card: one request answered with
   finite Y of the right shape, ``GET /metrics`` with the health gauges
   and the controller and brownout sections, and rc 0.

The line before the last holds the card's name and power limit; before it,
the per-kernel summary line.  The last line is ``{"ok": true, "device":
...}``.  Without a CUDA card, or without the package beside this file, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12              # f32 on the CUDA cores
TF32_FLOPS = 495e12            # TF32 on the tensor cores, dense; flash and
                               # the scan run every product three times
                               # (3xTF32)

FLASH_CASES = [                # (b, s, h, kv, hd, window, dtype) — JAX suite
    (2, 64, 4, 2, 32, 0, "float32"),
    (1, 128, 4, 4, 64, 0, "float32"),
    (2, 96, 8, 2, 80, 32, "float32"),
    (1, 256, 4, 1, 128, 64, "float32"),
    (1, 200, 2, 2, 48, 0, "float32"),
    (2, 64, 4, 2, 64, 0, "bfloat16"),
    (16, 256, 16, 8, 128, 0, "float32"),   # serving path, qwen3 chunks
    (8, 256, 16, 8, 128, 0, "float32"),
    (16, 256, 25, 5, 64, 1024, "float32"),  # serving path, hymba chunks
    (8, 256, 25, 5, 64, 1024, "float32"),
    (2, 65, 4, 2, 128, 0, "float32"),       # S past whole q and kv tiles
    (1, 200, 25, 5, 64, 16, "float32"),     # window inside one kv tile
    (1, 70, 4, 1, 256, 16, "float32"),
    (2, 33, 2, 1, 50, 0, "float32"),        # hd 50: padded to 64, element loads
    (2, 130, 16, 8, 128, 0, "bfloat16"),
    (16, 256, 24, 8, 64, 0, "float32"),     # serving path, granite chunks
    (8, 256, 24, 8, 64, 0, "float32"),
    (16, 256, 32, 8, 128, 0, "float32"),    # llama-3.2-vision's self layers
]
# served class counts: qwen3 151936, mamba2 50280, hymba 32001, granite
# 49155 and llama-3.2-vision 128256 (rows of 32001 and 49155 not 16-byte
# aligned)
COMBINE_CASES = [(4, 128, 100), (12, 44, 91), (3, 128, 1000), (1, 7, 13),
                 (2, 32, 151936), (1, 32, 151936), (1, 8, 151936),
                 (1, 32, 50280), (1, 8, 50280), (1, 32, 32001), (1, 8, 32001),
                 (1, 32, 49155), (1, 8, 49155), (1, 32, 128256),
                 (1, 8, 128256)]
QUANT_CASES = [(1, 8, 512), (3, 40, 512), (2, 128, 640), (1, 32, 151936),
               (1, 8, 151936), (1, 32, 50280), (1, 8, 50280), (1, 32, 32001),
               (1, 8, 32001), (1, 32, 49155), (1, 8, 49155), (1, 32, 128256),
               (1, 8, 128256)]
SSD_CASES = [                  # (b, s, h, p, n, chunk) — JAX suite
    (2, 64, 4, 32, 16, 16),
    (1, 128, 8, 64, 32, 32),
    (2, 100, 4, 32, 16, 16),   # ragged S
    (1, 64, 2, 64, 128, 64),
    (2, 200, 8, 64, 128, 64),  # ragged S with the mamba2 state
    (2, 40, 3, 32, 16, 64),    # S shorter than one chunk
    (1, 96, 2, 96, 32, 32),    # P 96: two blocks a head
    (16, 256, 64, 64, 128, 64),  # serving path, mamba2 member-0 chunk
    (16, 256, 50, 64, 16, 64),   # serving path, hymba member-0 chunk
    # layouts over 227 KB at the caller's chunk, and a state over 256: the
    # kernel runs at the largest chunk that fits
    (2, 300, 4, 64, 128, 128),
    (2, 300, 4, 64, 16, 256),
    (2, 150, 3, 64, 512, 64),
]
DECODE_CASES = [              # (b, L, h, kv, hd, dtype, valid slots)
    (2, 64, 4, 2, 32, "float32", "tail"),       # JAX suite: L-7 valid
    (1, 300, 8, 2, 80, "float32", "tail"),
    (3, 1024, 4, 1, 128, "float32", "tail"),
    (2, 128, 4, 4, 64, "bfloat16", "tail"),
    (16, 2048, 16, 8, 128, "float32", "prefix"),  # qwen3's last step: 0..1087
    (16, 2048, 16, 8, 128, "bfloat16", "prefix"),
    (16, 1024, 25, 5, 64, "float32", "all"),      # hymba's full ring
    (16, 1024, 4, 1, 256, "float32", "all"),      # gemma3's hd 256
    (4, 2048, 16, 8, 128, "float32", "leading"),  # first 600 slots invalid
    (4, 2048, 16, 8, 128, "float32", "random"),
    (16, 2048, 16, 8, 128, "float32", "one"),
    (16, 1024, 25, 5, 64, "bfloat16", "wrap"),
    (16, 1024, 24, 8, 64, "float32", "gen"),      # granite's last step
    (16, 1024, 32, 8, 128, "float32", "gen"),     # llama-3.2-vision's
]
MAIN_DECODE = (16, 2048, 16, 8, 128)
MAIN_DECODE_VALID = 1088
HYMBA_DECODE = (16, 1024, 25, 5, 64)          # the window ring, all valid
GRANITE_DECODE = (16, 1024, 24, 8, 64)        # group 3, 576 slots valid
GEN_VALID = 576                               # 512 prompt + 64 steps
DECODE_TIMED = ((MAIN_DECODE, "prefix"), (HYMBA_DECODE, "all"),
                (GRANITE_DECODE, "gen"))
MAIN_FLASH = (16, 256, 16, 8, 128)
HYMBA_FLASH = (16, 256, 25, 5, 64)
GRANITE_FLASH = (16, 256, 24, 8, 64)
MAIN_SEG, MAIN_C = 32, 151936
COMBINE_SETS = 4               # (preds, partial) sets that the timed folds
                               # rotate over: 4 x 39 MB, so that no fold
                               # finds its operands in the 50 MB L2
MAIN_SSD = (16, 256, 64, 64, 128, 64)
HYMBA_SSD = (16, 256, 50, 64, 16, 64)
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
    """Mean enqueued time of ``fn``: ``iters`` calls launched from Python
    between two events after a warm-up.  For a kernel of some microseconds
    this reads the host's launch rate, not the device."""
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


def device_ms(torch, fn, iters: int = 20, reps: int = 3) -> float:
    """Mean device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between two events.  The
    warm-up runs first on a side stream, so that builds, allocations and
    once-per-kernel attribute calls stay out of the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def host_us(torch, fn, calls: int = 1000) -> float:
    """The host's time per call of ``fn`` in µs: a host clock around
    ``calls`` calls with no synchronise inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def timings(torch, kernel, plain, library=None,
            plain_iters: int = 20) -> dict:
    """The kernel's and the library call's device ms, in turns (kernel,
    library, library, kernel), the kernel's enqueued ms, the kernel
    wrapper's host µs per call and the plain version's enqueued ms (its
    calls are many kernels each, and device-bound at the timed shapes)."""
    turns = [device_ms(torch, kernel)]
    lib_turns = []
    if library is not None:
        lib_turns = [device_ms(torch, library), device_ms(torch, library)]
    turns.append(device_ms(torch, kernel))
    return {"ms": sum(turns) / len(turns),
            "library_ms": sum(lib_turns) / 2 if lib_turns else None,
            "enqueued_ms": time_ms(torch, kernel),
            "host_us": host_us(torch, kernel),
            "plain_ms": time_ms(torch, plain, iters=plain_iters)}


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(torch, got, want, tol: float, rtol=None) -> float:
    """Max |got - want|; fails unless |got-want| <= tol + rtol*|want|
    (rtol defaults to tol)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rtol = tol if rtol is None else rtol
    if not torch.isfinite(got).all():
        fail("non-finite kernel output")
    if (err > tol + rtol * want.abs()).any():
        fail(f"max abs error {err.max().item():.3g} over tolerance {tol}")
    return err.max().item()


# ---------------------------------------------------------------------------
def attn_pairs(s: int, window: int) -> int:
    """(query, key) pairs that the causal mask, and the window if any,
    keep in a sequence of ``s``."""
    return sum(min(i + 1, window) if window > 0 else i + 1 for i in range(s))


def attention_f64(q, k, v, window: int):
    """Causal attention in float64 (q pre-scaled): the yardstick of the
    f32 kernel's and of one TF32 pass's error."""
    import torch
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    kk, vv = (t.double().repeat_interleave(g, dim=2) for t in (k, v))
    logits = torch.einsum("bqhd,bshd->bhqs", q.double(), kk)
    pos = torch.arange(s, device=q.device)
    ok = pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= pos[None, :] > pos[:, None] - window
    logits = logits.masked_fill(~ok, float("-inf"))
    return torch.einsum("bhqs,bshd->bqhd", torch.softmax(logits, -1), vv)


def flash_inputs(torch, gen, dev, b, s, h, kv, hd, dtype):
    """Random q, k and v of one flash case, q pre-scaled by hd^-0.5 in its
    own dtype as the model does."""
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
    scale = float(torch.tensor(hd ** -0.5, dtype=dtype))
    return (q * scale).contiguous(), k, v


def time_flash(torch, fa, ref, qs, k, v, window: int) -> dict:
    """Times, bounds and errors against float64 of the flash kernel at one
    serving shape, beside SDPA's and the plain version's."""
    import torch.nn.functional as F
    b, s, h, hd = qs.shape
    kv = k.shape[2]
    # library yardstick: one SDPA call on the same inputs (never used by the
    # port); it wants (B, H, S, hd) with the kv heads expanded, and the
    # window as a mask (none at S <= window)
    qt = qs.transpose(1, 2)
    kt, vt = (t.repeat_interleave(h // kv, dim=2).transpose(1, 2)
              for t in (k, v))
    if 0 < window < s:
        pos = torch.arange(s, device=qs.device)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  scale=1.0)
    else:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  scale=1.0)
    out = timings(
        torch, lambda: fa.flash_attention(qs, k, v, causal=True,
                                          window=window),
        lambda: ref.flash_attention_ref(qs, k, v, causal=True, window=window,
                                        scale=1.0), library)
    ops = 4.0 * b * h * attn_pairs(s, window) * hd
    nbytes = 4 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    out["bound_ms"], out["bound_by"] = bound(nbytes, 3 * ops, TF32_FLOPS)
    out["bound_rate"] = "3 x operations / 495 TFLOP/s (3xTF32, tensor cores)"
    out["cuda_core_bound_ms"] = bound(nbytes, ops, F32_FLOPS)[0]
    out["flops"] = ops
    # errors against float64: the kernel (3xTF32), the plain version in f32
    # and the plain version with TF32 matmuls (one TF32 pass)
    want = attention_f64(qs, k, v, window)
    got = fa.flash_attention(qs, k, v, causal=True, window=window)
    plain = ref.flash_attention_ref(qs, k, v, causal=True, window=window,
                                    scale=1.0)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = ref.flash_attention_ref(qs, k, v, causal=True,
                                           window=window, scale=1.0)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for name, x in (("kernel", got), ("plain_f32", plain),
                    ("plain_tf32_one_pass", one_pass)):
        e = (x.double() - want).abs()
        errs[name] = {"max_abs_err": e.max().item(),
                      "over_2e-5": int((e > 2e-5 + 2e-5 * want.abs()).sum())}
    out["err_vs_f64"] = errs
    return out


def phase_flash(torch, gen, dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    cases = []
    served = {}
    for b, s, h, kv, hd, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        qs, k, v = flash_inputs(torch, gen, dev, b, s, h, kv, hd, dtype)
        out = fa.flash_attention(qs, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(qs, k, v, causal=True, window=window,
                                       scale=1.0)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        err = close(torch, out, want, tol)
        cases.append({"shape": [b, s, h, kv, hd], "window": window,
                      "dtype": dt, "max_abs_err": err, "tol": tol})
        if (b, s, h, kv, hd) in (MAIN_FLASH, HYMBA_FLASH, GRANITE_FLASH):
            served[(b, s, h, kv, hd)] = (qs, k, v, window, err)
    timed = []
    for shape in (MAIN_FLASH, HYMBA_FLASH, GRANITE_FLASH):
        qs, k, v, window, err = served[shape]
        timed.append({"shape": list(shape), "window": window,
                      "max_abs_err": err,
                      **time_flash(torch, fa, ref, qs, k, v, window)})
    main = timed[0]
    emit({"phase": "kernel:flash_attention", "cases": cases, "ok": True,
          "main_shape": list(MAIN_FLASH), "timed": timed,
          **{key: main[key] for key in SUMMARY_TIMES}})
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:95",
            "max_abs_err": main["max_abs_err"],
            **{key: main[key] for key in SUMMARY_TIMES},
            "bound_rate": main["bound_rate"],
            "cuda_core_bound_ms": main["cuda_core_bound_ms"]}


# the timing keys of each kernel's phase and of the summary line
SUMMARY_TIMES = ("ms", "enqueued_ms", "host_us", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")


def combine_sets(torch, gen, dev, n: int = COMBINE_SETS) -> list:
    """``n`` random (preds, weights, partial) sets at qwen3's segment (one
    member, M 1), one weight vector shared."""
    w = torch.softmax(torch.randn((1,), generator=gen, device=dev), 0)
    return [(torch.randn((1, MAIN_SEG, MAIN_C), generator=gen, device=dev), w,
             torch.randn((MAIN_SEG, MAIN_C), generator=gen, device=dev))
            for _ in range(n)]


def rotating(fn, sets):
    """A call that runs ``fn(*set)`` on the next of ``sets`` each time."""
    turn = itertools.count()
    return lambda: fn(*sets[next(turn) % len(sets)])


def time_combine(torch, ec, ref, sets) -> dict:
    """Times of the combiner's own call, a fold of one member into the
    partial in place, beside ``torch.add`` in place.  Consecutive calls
    take consecutive ``sets``, so each reads its operands from HBM."""
    w0 = sets[0][1][0].item()
    t = timings(
        torch,
        rotating(lambda p, w, part: ec.ensemble_combine(p, w, part, out=part),
                 sets),
        rotating(lambda p, w, part: ref.ensemble_accumulate_ref(part, p, w),
                 sets),
        rotating(lambda p, w, part: torch.add(part, p[0], alpha=w0,
                                              out=part), sets))
    n = MAIN_SEG * MAIN_C
    t["bound_ms"], t["bound_by"] = bound(4 * (3 * n + 1), 2.0 * n, F32_FLOPS)
    return t


def phase_combine(torch, gen, dev):
    from repro_torch.kernels import ensemble_combine as ec
    from repro_torch.kernels import ref
    cases = []
    err = None
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
        # the same fold into rows 1.. of a larger partial (a span that does
        # not start at row 0; 16-byte aligned only when C % 4 == 0)
        big = torch.zeros((seg + 1, c), device=dev)
        big[1:] = part
        view = big[1:]
        ec.ensemble_combine(p, w, view, out=view)
        err_v = close(torch, view, want, 1e-5)
        torch.cuda.synchronize()
        cases.append({"shape": [m, seg, c], "fresh_err": err_f,
                      "accumulate_err": err_a, "in_place_err": err_i,
                      "row_offset_err": err_v, "tol": 1e-5})
        if (m, seg, c) == (1, MAIN_SEG, MAIN_C):
            err = max(err_a, err_i)
    t = time_combine(torch, ec, ref, combine_sets(torch, gen, dev))
    emit({"phase": "kernel:ensemble_combine", "cases": cases, "ok": True,
          "main_shape": [1, MAIN_SEG, MAIN_C], **t})
    return {"name": "ensemble_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ensemble_combine.cu",
            "replaces": "src/repro/kernels/ensemble_combine.py:143",
            "max_abs_err": err, **{key: t[key] for key in SUMMARY_TIMES}}


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
            big = torch.zeros((seg + 1, c), device=dev)
            big[1:] = part
            view = big[1:]
            ec.ensemble_combine_quant(view, q, s, w, out=view)
            err_v = close(torch, view, want, 1e-4)
            torch.cuda.synchronize()
            cases.append({"dtype": qdt, "shape": [m, seg, c],
                          "max_abs_err": err, "in_place_err": err_i,
                          "row_offset_err": err_v, "tol": 1e-4})
            if qdt == "int8" and (m, seg, c) == (1, MAIN_SEG, MAIN_C):
                main = (part, q, s, w, max(err, err_i))
    part, q, s, w, err = main
    out = torch.empty_like(part)
    t = timings(torch, lambda: ec.ensemble_combine_quant(part, q, s, w,
                                                         out=out),
                lambda: ref.ensemble_accumulate_quant_ref(part, q, s, w))
    n = MAIN_SEG * MAIN_C
    nbytes = n * 1 + 4 * MAIN_SEG + 4 * 2 * n + 4
    t["bound_ms"], t["bound_by"] = bound(nbytes, 3.0 * n, F32_FLOPS)
    emit({"phase": "kernel:ensemble_combine_quant", "cases": cases,
          "ok": True, "main_shape": [1, MAIN_SEG, MAIN_C], **t})
    return {"name": "ensemble_combine_quant", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ensemble_combine.cu",
            "replaces": "src/repro/kernels/ensemble_combine.py:108",
            "max_abs_err": err, **{key: t[key] for key in SUMMARY_TIMES}}


def decode_valid(torch, kind: str, L: int, gen, dev):
    pos = torch.arange(L, device=dev)
    if kind == "tail":
        return pos < L - 7
    if kind == "prefix":
        return pos < MAIN_DECODE_VALID
    if kind == "gen":
        return pos < GEN_VALID
    if kind == "leading":
        return pos >= 600
    if kind == "random":
        return torch.rand((L,), generator=gen, device=dev) < 0.5
    if kind == "one":                 # a single valid slot, mid-tile
        return pos == L // 2 + 5
    if kind == "wrap":                # a window ring that has wrapped
        return (pos < 37) | (pos >= L - 100)
    return torch.ones((L,), dtype=torch.bool, device=dev)


def decode_inputs(torch, gen, dev, b, L, h, kv, hd, dtype):
    """Random q (pre-scaled by hd^-0.5 in its own dtype, as the model
    does), k and v of one decode case."""
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, L, kv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, L, kv, hd), generator=gen, device=dev).to(dtype)
    scale = float(torch.tensor(hd ** -0.5, dtype=dtype))
    return (q * scale).contiguous(), k, v


def time_decode(torch, da, ref, qs, k, v, valid) -> dict:
    """Times and bound of the decode kernel at one shape, beside SDPA's and
    the plain version's."""
    import torch.nn.functional as F
    b, _, h, hd = qs.shape
    kv = k.shape[2]
    # library yardstick: one SDPA call on the same inputs with the kv heads
    # expanded and the mask as attn_mask (never used by the port)
    qt = qs.transpose(1, 2)
    kt, vt = (t.repeat_interleave(h // kv, dim=2).transpose(1, 2)
              for t in (k, v))
    t = timings(torch, lambda: da.decode_attention(qs, k, v, valid),
                lambda: ref.decode_attention_ref(qs, k, v, valid, scale=1.0),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=valid[None, None, None, :],
                    scale=1.0))
    n_valid = int(valid.sum().item())
    size = qs.element_size()
    nbytes = size * (2 * b * n_valid * kv * hd + 2 * b * h * hd) + \
        valid.numel()
    t["bound_ms"], t["bound_by"] = bound(nbytes, 4.0 * b * h * n_valid * hd,
                                         F32_FLOPS)
    t["bytes"], t["n_valid"] = nbytes, n_valid
    return t


def phase_decode(torch, gen, dev):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    cases = []
    served = {}
    for b, L, h, kv, hd, dt, kind in DECODE_CASES:
        dtype = getattr(torch, dt)
        qs, k, v = decode_inputs(torch, gen, dev, b, L, h, kv, hd, dtype)
        valid = decode_valid(torch, kind, L, gen, dev)
        out = da.decode_attention(qs, k, v, valid)
        want = ref.decode_attention_ref(qs, k, v, valid, scale=1.0)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        err = close(torch, out, want, tol)
        cases.append({"shape": [b, L, h, kv, hd], "dtype": dt, "valid": kind,
                      "n_valid": int(valid.sum().item()),
                      "max_abs_err": err, "tol": tol})
        if ((b, L, h, kv, hd), kind) in DECODE_TIMED and \
                dtype == torch.float32:
            served[(b, L, h, kv, hd)] = (qs, k, v, valid, err)
    timed = []
    for shape, _ in DECODE_TIMED:
        qs, k, v, valid, err = served[shape]
        timed.append({"shape": list(shape), "max_abs_err": err,
                      **time_decode(torch, da, ref, qs, k, v, valid)})
    main = timed[0]
    emit({"phase": "kernel:decode_attention", "cases": cases, "ok": True,
          "main_shape": list(MAIN_DECODE), "main_valid": main["n_valid"],
          "bytes": main["bytes"], "timed": timed,
          **{key: main[key] for key in SUMMARY_TIMES}})
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:76",
            "max_abs_err": main["max_abs_err"],
            **{key: main[key] for key in SUMMARY_TIMES}}


def ssd_work(b, s, h, p, n, chunk):
    """(bytes, flops) the scan must move and do at this shape: x and y once,
    dt, A, B and C once; multiply-adds of the lower-triangular scores (once
    per batch row and chunk, shared by the heads), the gated intra-chunk
    product, and the inter-chunk read and update of the state, which the
    first chunk (zero state in) and the last (no state out) do not need."""
    nc = -(-s // chunk)
    tri = chunk * (chunk + 1) // 2
    macs = b * nc * tri * n                       # C.B^T, lower triangle
    macs += b * nc * h * tri * p                  # (C.B^T o L)(dt x)
    macs += 2 * b * (nc - 1) * h * chunk * p * n  # C.h_in and h_out
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n)
    return nbytes, 2.0 * macs


def ssd_inputs(torch, gen, dev, b, s, h, p, n):
    """Random x, dt (post-softplus), A (negative), B and C of one case."""
    x = torch.randn((b, s, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    bm = torch.randn((b, s, n), generator=gen, device=dev)
    cm = torch.randn((b, s, n), generator=gen, device=dev)
    return x, dt, A, bm, cm


def time_ssd(torch, ssd, ref, x, dt, A, bm, cm, chunk: int,
             f64: bool = False) -> dict:
    """Times and bounds of the scan kernel at one shape, beside the plain
    version's; with ``f64``, also the errors against a float64 scan of the
    kernel, the plain version in f32 and the plain version with TF32
    matmuls (one TF32 pass)."""
    b, s, h, p = x.shape
    n = bm.shape[2]
    t = timings(torch, lambda: ssd.ssd_scan(x, dt, A, bm, cm, chunk=chunk),
                lambda: ref.ssd_scan_ref(x, dt, A, bm, cm, chunk=chunk),
                plain_iters=5)
    nbytes, flops = ssd_work(b, s, h, p, n, chunk)
    # the products run three times each on the tensor cores (3xTF32)
    t["bound_ms"], t["bound_by"] = bound(nbytes, 3 * flops, TF32_FLOPS)
    t["bound_rate"] = "3 x operations / 495 TFLOP/s (3xTF32, tensor cores)"
    t["cuda_core_bound_ms"] = bound(nbytes, flops, F32_FLOPS)[0]
    t["bytes"], t["flops"] = nbytes, flops
    if f64:
        want = ref.ssd_scan_ref(*(a.double() for a in (x, dt, A, bm, cm)),
                                chunk=chunk)
        got = ssd.ssd_scan(x, dt, A, bm, cm, chunk=chunk)
        plain = ref.ssd_scan_ref(x, dt, A, bm, cm, chunk=chunk)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            one_pass = ref.ssd_scan_ref(x, dt, A, bm, cm, chunk=chunk)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        atol = 1e-4 * max(1.0, want.abs().max().item())
        errs = {}
        for name, y in (("kernel", got), ("plain_f32", plain),
                        ("plain_tf32_one_pass", one_pass)):
            e = (y.double() - want).abs()
            errs[name] = {"max_abs_err": e.max().item(),
                          "over_tol": int((e > atol + 1e-4 * want.abs()).sum())}
        t["err_vs_f64"] = {"atol": atol, "rtol": 1e-4, **errs}
    return t


def phase_ssd(torch, gen, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    cases = []
    inputs = {}
    for b, s, h, p, n, chunk in SSD_CASES:
        x, dt, A, bm, cm = ssd_inputs(torch, gen, dev, b, s, h, p, n)
        got = ssd.ssd_scan(x, dt, A, bm, cm, chunk=chunk)
        want = ref.ssd_scan_ref(x, dt, A, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        err = close(torch, got, want, tol, rtol=1e-4)
        cases.append({"shape": [b, s, h, p, n, chunk], "max_abs_err": err,
                      "atol": tol, "rtol": 1e-4})
        inputs[(b, s, h, p, n, chunk)] = (x, dt, A, bm, cm, err)
    timed = {}
    for shape in (MAIN_SSD, HYMBA_SSD):          # the two served shapes
        x, dt, A, bm, cm, err = inputs[shape]
        timed[shape] = {"shape": list(shape), "max_abs_err": err,
                        **time_ssd(torch, ssd, ref, x, dt, A, bm, cm,
                                   shape[-1], f64=shape == MAIN_SSD)}
    main = timed[MAIN_SSD]
    emit({"phase": "kernel:ssd_scan", "cases": cases, "ok": True,
          "main_shape": list(MAIN_SSD), "timed": list(timed.values()),
          **{key: main[key] for key in SUMMARY_TIMES}})
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:73",
            "max_abs_err": main["max_abs_err"],
            **{key: main[key] for key in SUMMARY_TIMES},
            "bound_rate": main["bound_rate"],
            "cuda_core_bound_ms": main["cuda_core_bound_ms"]}


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


def profile_served(torch, system, X, n_req: int, rows: int,
                   pair: str) -> None:
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
    emit({"phase": f"profile:{pair}", **device_time(prof, window)})


def device_time(prof, window: float) -> dict:
    """Device busy time, its share of the profiled window and the top 15
    kernels, from the device-side events only: an aten op's own entry
    repeats the device time of the kernels it launched, so summing every
    entry would count those kernels twice."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    return {"window_s": window, "device_busy_s": busy_us * 1e-6,
            "device_busy_share": busy_us * 1e-6 / window,
            "top": [{"name": e.key[:90], "device_ms": dev_us(e) * 1e-3,
                     "calls": e.count} for e in top]}


PAIRS = [                      # (fp32 member, its layers (None: the full
    ("qwen3-1.7b", None, 14),  # config's), layers of the int8 member)
    ("mamba2-1.3b", None, 24),
    ("hymba-1.5b", None, 16),
    ("granite-moe-3b-a800m", None, 16),
    # 40 layers would be 43 GB in f32 beside the int8 member's f32 build
    ("llama-3.2-vision-11b", 10, 5),
]


def cut(cfg, layers):
    """``cfg`` at ``layers`` layers (widths unchanged), or as it is."""
    if layers is None or layers == cfg.num_layers:
        return cfg
    return dataclasses.replace(cfg, name=f"{cfg.name}-l{layers}",
                               num_layers=layers)


def frontend_for(torch, cfg, seed: int, rows: int):
    """A cross-attention member's frontend, (rows, F, fdim) on the card:
    one seeded row, repeated, so that a row's answer does not depend on
    where the batcher puts it (a zero frontend would add exactly 0).  None
    for the other members."""
    if not cfg.frontend_tokens:
        return None
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1000)
    row = torch.randn((1, cfg.frontend_tokens, cfg.fdim), generator=gen,
                      device=dev)
    return row.expand(rows, -1, -1).contiguous()


class RoutingLog:
    """While open, wraps ``models.moe._router`` and keeps each router call's
    choices ``idx`` (tokens, k) under the member that made it: the calling
    thread's, set by ``member`` (one thread serves one member).  With
    ``replay`` (member -> that member's calls' choices, in order) the
    choices are the replayed ones and the weights the router's own
    probabilities at them, renormalised: ``_router`` with its choices
    given.  With ``margins`` each call also keeps the router's margin per
    token, the least gap between neighbours among its k + 1 highest
    probabilities: two forwards choose, or rank, a token's experts
    differently only where that gap is under the difference between their
    probabilities."""

    def __init__(self, replay=None, margins: bool = False):
        self.replay = {m: list(c) for m, c in (replay or {}).items()}
        self.margins = margins
        self.idx, self.margin = {}, {}
        self._tls = threading.local()

    def member(self, m: int) -> None:
        self._tls.member = m
        self.idx.setdefault(m, [])
        self.margin.setdefault(m, [])

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._orig = orig = moe._router

        def router(x, w_router, top_k):
            weights, idx, probs = orig(x, w_router, top_k)
            m = self._tls.member
            if m in self.replay:
                idx = self.replay[m].pop(0)
                if tuple(idx.shape) != (x.shape[0], top_k):
                    fail(f"member {m}: replayed choices {tuple(idx.shape)} "
                         f"for {x.shape[0]} tokens")
                w = probs.gather(1, idx)
                weights = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
                           ).to(x.dtype)
            self.idx[m].append(idx)
            if self.margins:
                top = torch.topk(probs, top_k + 1, dim=-1).values
                self.margin[m].append((top[:, :-1] - top[:, 1:]).min(-1)
                                      .values)
            return weights, idx, probs
        moe._router = router
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._router = self._orig


def dispatch_counts(cfg, calls) -> dict:
    """The capacity dispatch of one member's router calls: its (token, k)
    assignments, how many were dropped, and the group and capacity of the
    largest call."""
    import torch.nn.functional as F
    from repro_torch.models.moe import capacity_plan, dispatch_slots
    kept = total = 0
    for idx in calls:
        t, k = idx.shape
        g, ng, cap = capacity_plan(cfg, t)
        ig = F.pad(idx, (0, 0, 0, ng * g - t)).reshape(ng, g, k)
        _, keep = dispatch_slots(ig, cfg.moe.num_experts, cap)
        kept += int(keep.reshape(-1, k)[:t].sum())
        total += t * k
    g, ng, cap = capacity_plan(cfg, max(c.shape[0] for c in calls))
    return {"group": g, "groups_per_batch": ng, "capacity": cap,
            "assignments": total, "dropped": total - kept,
            "dropped_share": (total - kept) / max(1, total),
            "dispatches": len(calls)}


def rerouting(torch, cfg, batches, served, plain, margin, row_of) -> dict:
    """Where one member's plain forward, left to route by itself on the
    served batches, departs from the served run's choices: the rows of X
    whose choices differ in some layer, and for each 512-token group that
    departs, the plain router's margin at the tokens whose choices differ
    in the first layer where any of the group's do.  Before that layer the
    group's tokens had the same choices, hence the same capacity slots, on
    both paths, so their router inputs differed by rounding alone: a margin
    of that order there is the witness that a near tie flipped."""
    from repro_torch.models.moe import capacity_plan
    layers = cfg.num_layers
    rows, firsts, i = set(), [], 0
    for tok in batches:
        b, s = tok.shape
        diff = (torch.stack(served[i:i + layers]) !=
                torch.stack(plain[i:i + layers])).any(-1)      # (layers, T)
        mg = torch.stack(margin[i:i + layers])
        i += layers
        keys = tok.cpu().numpy()
        for j in torch.nonzero(diff.reshape(layers, b, s).any(-1).any(0)
                               )[:, 0].tolist():
            if keys[j].any():
                rows.add(row_of[keys[j].tobytes()])
        g, ng, _ = capacity_plan(cfg, b * s)
        pad = ng * g - b * s
        dg = torch.nn.functional.pad(diff, (0, pad)).reshape(layers, ng, g)
        mg = torch.nn.functional.pad(mg, (0, pad)).reshape(layers, ng, g)
        for q in torch.nonzero(dg.any(-1).any(0))[:, 0].tolist():
            l = int(torch.nonzero(dg[:, q].any(-1))[0, 0])
            firsts.append({"layer": l, "tokens": int(dg[l, q].sum()),
                           "margin_max": float(mg[l, q][dg[l, q]].max())})
    every = torch.cat([m.flatten() for m in margin])
    firsts.sort(key=lambda f: -f["margin_max"])
    return {"rows": sorted(rows), "groups_departed": len(firsts),
            "first_departures_widest": firsts[:10],
            "margin_at_first_departure_max": max(
                (f["margin_max"] for f in firsts), default=None),
            "margin_median": float(every.median()),
            "margin_min": float(every.min())}


def layer_counts(cfg):
    """(attention-kernel layers, scan-kernel layers) of one forward."""
    from repro_torch.configs.base import ATTN, HYBRID, SSM, SWA
    attn = sum(k in (ATTN, SWA, HYBRID) for k in cfg.pattern) * cfg.repeats
    scan = sum(k in (SSM, HYBRID) for k in cfg.pattern) * cfg.repeats
    return attn, scan


def record_batches(worker, log: list, routing=None):
    """Wrap ``worker``'s forward so that each batch's tokens are kept in
    ``log`` (device copies, in the order served) and the router calls it
    makes are kept by ``routing`` (a ``RoutingLog``) under its member;
    returns the forward it wrapped."""
    orig = worker.predict_fn

    def predict(params, tokens, frontend=None):
        log.append(tokens.clone())
        if routing is not None:
            routing.member(worker.model_idx)
        return orig(params, tokens, frontend)
    worker.predict_fn = predict
    return orig


def combined_reference(torch, kq, cfgs, workers, fe, X, batches,
                       use_kernel: bool, routing=None):
    """Each member's forward on the worker's own parameters over
    ``batches[m]`` (token tensors whose rows are rows of ``X``, zero rows
    being padding), the int8 member's logits quantized per row as the
    server does: returns each member's logits for the rows of ``X``, in
    order, and the int8 member's row scales.  ``routing`` (an open
    ``RoutingLog``) is told which member runs."""
    from repro_torch.models.transformer import hidden, logits_from_hidden
    logits, scales = [], None
    for i, (cfg, w) in enumerate(zip(cfgs, workers)):
        if routing is not None:
            routing.member(i)
        rows = {}
        for tok in batches[i]:
            n = tok.shape[0]
            x = hidden(w.params, cfg, tok, None if fe is None else fe[:n],
                       use_kernel=use_kernel)
            lg = logits_from_hidden(w.params, cfg, x[:, -1])
            lg = lg[:, :cfg.vocab_size].float()
            for j, key in enumerate(tok.cpu().numpy()):
                if key.any():
                    rows[key.tobytes()] = lg[j]
        lg = torch.stack([rows[r.tobytes()] for r in X])
        if i == 1:
            q, s = kq.quantize_symmetric(lg, axis=-1)
            lg = kq.dequantize(q, s)
            scales = s[:, 0].cpu().numpy()
        logits.append(lg.cpu().numpy())
    return logits, scales


def held_to(Y, ref_logits, scales, weights) -> dict:
    """How ``Y`` stands against the combined reference.  A logit of the
    int8 member on a rounding edge may flip its code by one between the two
    paths, which moves that element of Y by exactly one step, w1*s_row.  So
    every element must lie within atol of Y_ref + k*step with k in {-1, 0,
    1}, and at most MAX_FLIP_SHARE of them with k != 0: any other fault (a
    wrong weight, a lower-precision forward) leaves errors that are not
    whole steps."""
    import numpy as np
    Y_ref = weights[0] * ref_logits[0] + weights[1] * ref_logits[1]
    atol = 1e-4 * max(1.0, float(np.abs(Y_ref).max()))
    diff = Y - Y_ref
    step = (weights[1] * scales)[:, None]
    k = np.rint(diff / step)
    resid = np.abs(diff - k * step)
    bad = (resid > atol) | (np.abs(k) > 1)
    off = bad.any(axis=1)
    rows_off = np.nonzero(off)[0]
    return {"max_abs_err": float(np.abs(diff).max()), "atol": atol,
            "max_residual": float(resid.max()),
            "int8_step_max": float(step.max()),
            # code flips in the rows that hold
            "int8_flips": int((k[~off] != 0).sum()),
            "bad_elements": int(bad.sum()), "rows_off": rows_off.tolist(),
            "row_residual": resid.max(axis=1)[rows_off].tolist()}


def phase_pair(torch, name: str, layers, int8_layers: int, seed: int,
               smi: str, profile: bool = False):
    """Serve one member pair end to end: ``name`` at its full widths in
    fp32 (``layers`` of them, or the full config's), and the same widths cut
    to ``int8_layers`` layers in int8."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as kq
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSystem

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg0 = cut(get_config(name), layers)
    cfg1 = cut(get_config(name), int8_layers)
    cfgs = [cfg0, cfg1]
    batches = [16, 8]
    fe = frontend_for(torch, cfg0, seed, max(batches))
    t0 = time.perf_counter()
    params = [init_params(cfg0, seed, dev), init_params(cfg1, seed + 1, dev)]
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    alloc = AllocationMatrix(cuda_devices()[:1], [c.name for c in cfgs],
                             np.array([batches]))
    max_seq, seg, n_req, rows = 256, 32, 4, 40
    t0 = time.perf_counter()
    system = InferenceSystem(cfgs, params, alloc, combine="pallas",
                             use_kernel=True, max_seq=max_seq,
                             segment_size=seg,
                             member_dtypes=["fp32", "int8"],
                             frontends=None if fe is None else {
                                 i: fe[:b] for i, b in enumerate(batches)})
    del params
    t_build = time.perf_counter() - t0
    try:
        member_bytes = [tree_bytes(w.params) for w in system.workers]
        rng = np.random.default_rng(seed)
        X = rng.integers(0, cfg0.vocab_size, (n_req * rows, max_seq)
                         ).astype(np.int32)
        # a capacity-MoE pair keeps each worker's batches and the router's
        # choices in them, for a reference on the same batches and choices
        own_batches = cfg0.moe is not None and cfg0.moe.impl == "capacity"
        served = [[] for _ in cfgs]
        served_log = RoutingLog() if own_batches else None
        unwrapped = [(w, record_batches(w, served[w.model_idx], served_log))
                     for w in system.workers] if own_batches else []
        torch.cuda.synchronize()
        ops.reset_counts()                   # counts cover the served run
        with served_log or contextlib.nullcontext():
            Y, wall, lat_ms = serve(system, X, n_req, rows)
        launches = ops.kernel_launches()
        plain = ops.plain_calls()
        for w, fn in unwrapped:
            w.predict_fn = fn
        counters = system.serving_counters()
        stages = {k: v["total_s"] for k, v in system.stage_timings().items()}
        if profile:
            profile_served(torch, system, X, n_req, rows, name)
        weights = [float(x) for x in system.accumulator.weights]
        workers = system.workers
        # plain reference on the card: each member's plain forward on the
        # worker's own parameters (the int8 member's wrapped tree, the same
        # dequantized weights), int8 logit quantization for member 1
        with torch.no_grad():
            tok = torch.from_numpy(X).to(dev)
            blocks = [tok[lo:lo + 16] for lo in range(0, len(X), 16)]
            if own_batches:
                # the capacity dispatch sends each token to its top-k
                # experts and drops what is past an expert's capacity, so a
                # row's answer jumps where a choice flips; the plain path
                # therefore replays the served run's choices, layer by layer
                # on the same batches, and every row is held to it.  Its own
                # choices, in a second plain run, show where and by what
                # margin the two paths part
                replay_log = RoutingLog(replay=served_log.idx)
                with replay_log:
                    plain_ref = combined_reference(
                        torch, kq, cfgs, workers, fe, X, served,
                        use_kernel=False, routing=replay_log)
                left = {m: len(c) for m, c in replay_log.replay.items() if c}
                if left:
                    fail(f"{name}: served router calls not replayed: {left}")
                own_log = RoutingLog(margins=True)
                with own_log:
                    own_ref = combined_reference(
                        torch, kq, cfgs, workers, fe, X, served,
                        use_kernel=False, routing=own_log)
                row_of = {r.tobytes(): i for i, r in enumerate(X)}
                departed = [rerouting(torch, c, served[m], served_log.idx[m],
                                      own_log.idx[m], own_log.margin[m],
                                      row_of) for m, c in enumerate(cfgs)]
                moe_counts = [dispatch_counts(c, served_log.idx[m])
                              for m, c in enumerate(cfgs)]
                del replay_log, own_log, served_log
            else:
                plain_ref = combined_reference(
                    torch, kq, cfgs, workers, fe, X, [blocks, blocks],
                    use_kernel=False)
    finally:
        system.shutdown()
    # free this pair's device memory before the next one is built
    del system, workers, tok, blocks, fe, served
    gc.collect()
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if Y.shape != (n_req * rows, cfg0.vocab_size):
        fail(f"{name}: Y shape {Y.shape}")
    if not np.isfinite(Y).all():
        fail(f"{name}: non-finite Y")
    gate = "plain_served_routing" if own_batches else "plain"
    checks = {gate: held_to(Y, *plain_ref, weights)}
    for what, c in checks.items():
        if c["rows_off"]:
            fail(f"{name}: Y vs {what} reference: {c['bad_elements']} "
                 f"elements in rows {c['rows_off'][:20]} off by more than "
                 f"atol {c['atol']:.3g} from a whole int8 step, max residual "
                 f"{c['max_residual']:.3g}, per row {c['row_residual'][:20]}")
        if c["int8_flips"] > MAX_FLIP_SHARE * Y.size:
            fail(f"{name}: Y vs {what} reference: {c['int8_flips']} int8 "
                 f"code flips, over {MAX_FLIP_SHARE:.0%} of {Y.size} "
                 f"elements")
    if any(plain.values()):
        fail(f"{name}: plain versions ran on the served path: {plain}")
    # every dispatched chunk runs its member's forward once: one flash launch
    # per attention or hybrid layer, one scan launch per SSM or hybrid layer
    minima = {"flash_attention": 0, "ssd_scan": 0}
    for cfg, bs in zip(cfgs, batches):
        chunks = math.ceil(n_req * rows / bs)
        attn, scan = layer_counts(cfg)
        minima["flash_attention"] += attn * chunks
        minima["ssd_scan"] += scan * chunks
    for kname, least in minima.items():
        if launches[kname] < least or (least == 0 and launches[kname]):
            fail(f"{name}: {kname} launched {launches[kname]} times, "
                 f"expected {'at least ' + str(least) if least else 'none'}")
    for kname in ("ensemble_combine", "ensemble_combine_quant"):
        if launches[kname] < 1:
            fail(f"{name}: {kname} never launched on the served path")
    extra = {}
    if own_batches:
        own = held_to(Y, *own_ref, weights)
        rows_rerouted = sorted(set().union(*(d["rows"] for d in departed)))
        extra["moe"] = {
            "impl": cfg0.moe.impl, **moe_counts[0],
            "dropped_share_int8_member": moe_counts[1]["dropped_share"],
            "note": "counted in the served run's dispatch, member 0"}
        extra["rerouting"] = {
            "note": "the plain path on the served batches with its own "
                    "choices: the rows whose choices differ from the served "
                    "run's in some layer of either member, how far Y is "
                    "from that reference, and the plain router's margin "
                    "where each group first departs",
            "rows_rerouted": rows_rerouted,
            "rerouted_share": len(rows_rerouted) / len(X),
            "rows_off_own_routing": own["rows_off"],
            "max_abs_err_own_routing": own["max_abs_err"],
            "members": [{k: v for k, v in d.items() if k != "rows"}
                        for d in departed]}
    if cfg0.frontend_tokens:
        extra["frontend"] = {"shape": [max(batches), cfg0.frontend_tokens,
                                       cfg0.fdim],
                             "rows": "one seeded row, repeated"}
    if layers is not None:
        extra["depth_cut"] = {"layers": cfg0.num_layers,
                              "full_config_layers": get_config(name).num_layers}
    emit({"phase": f"end_to_end:{name}", "ok": True, "card": smi, **extra,
          "members": [c.name for c in cfgs], "member_dtypes": ["fp32", "int8"],
          "allocation": [batches], "requests": n_req, "rows_per_request": rows,
          "max_seq": max_seq, "segment_size": seg,
          "rows_per_s": n_req * rows / wall, "wall_s": wall,
          "latency_ms": lat_ms, "p50_ms": float(np.percentile(lat_ms, 50)),
          "p99_ms": float(np.percentile(lat_ms, 99)),
          "member_param_gb": [b / 1e9 for b in member_bytes],
          "peak_device_gb": peak_gb, "init_s": t_init, "system_build_s": t_build,
          "max_abs_err": checks[gate]["max_abs_err"],
          "atol": checks[gate]["atol"], "gate": gate,
          "checks": {k: {f: v for f, v in c.items() if f != "row_residual"}
                     for k, c in checks.items()},
          "elements": int(Y.size),
          "launches": launches, "launch_minima": minima, "plain_calls": plain,
          "batches": counters.get("batches"), "stage_total_s": stages,
          "padding_efficiency": counters.get("padding_efficiency")})
    return launches


GEN_PHASES = [                 # (model, layers (None: the full config's),
    ("qwen3-1.7b", None, 1024, 2048, False),   # prompt, cache slots, int8
    ("hymba-1.5b", None, 992, 2048, False),    # KV cache)
    ("mamba2-1.3b", None, 512, 1024, False),
    ("hymba-1.5b", None, 992, 2048, True),
    ("granite-moe-3b-a800m", None, 512, 1024, False),
    ("llama-3.2-vision-11b", 10, 512, 1024, False),
]
GEN_BATCH, GEN_STEPS = 16, 64
PROFILE_STEPS = 8


def generate(torch, params, cfg, prompt, max_len: int, *, use_kernel: bool,
             int8_kv: bool = False, forced=None, frontend=None) -> dict:
    """prefill + GEN_STEPS decode steps, greedy over the real vocabulary
    unless ``forced`` (B, GEN_STEPS) gives the tokens.  Returns the logits
    of the prefill and of every step (GEN_STEPS + 1, B, V), the tokens fed,
    the prefill's seconds, each step's ms (CUDA events) and the decode
    wall time, and the cache."""
    from repro_torch.models import decode_step, prefill
    V, s0 = cfg.vocab_size, prompt.shape[1]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(params, cfg, prompt, max_len, frontend,
                            use_kernel=use_kernel, quantize_cache=int8_kv)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        logits, toks = [lg[:, :V]], []
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(GEN_STEPS + 1)]
        t0 = time.perf_counter()
        ev[0].record()
        for t in range(GEN_STEPS):
            tok = (forced[:, t:t + 1] if forced is not None else
                   logits[-1].argmax(-1, keepdim=True).int())
            toks.append(tok)
            lg, cache = decode_step(params, cfg, cache, tok, s0 + t,
                                    use_kernel=use_kernel)
            logits.append(lg[:, :V])
            ev[t + 1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"logits": torch.stack(logits), "tokens": torch.cat(toks, 1),
            "prefill_s": prefill_s, "wall_s": wall, "cache": cache,
            "step_ms": [ev[i].elapsed_time(ev[i + 1])
                        for i in range(GEN_STEPS)]}


def profile_decode(torch, params, cfg, cache, token, pos: int,
                   name: str) -> None:
    """PROFILE_STEPS more decode steps under torch.profiler: device time by
    kernel and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(PROFILE_STEPS):
            decode_step(params, cfg, cache, token, pos + t, use_kernel=True)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    emit({"phase": f"profile:generate:{name}", "steps": PROFILE_STEPS,
          **device_time(prof, window)})


def max_err(torch, got, want):
    """(max |got - want|, tolerance scale max(1, max |want|))."""
    return ((got.float() - want.float()).abs().max().item(),
            max(1.0, want.float().abs().max().item()))


def phase_generate(torch, name: str, layers, prompt_len: int, max_len: int,
                   int8_kv: bool, seed: int, smi: str, profile: bool = False,
                   fp32_run=None):
    """Generate with ``name`` at its full widths and ``layers`` layers (or
    the full config's; see the module docstring).  ``fp32_run`` (tokens,
    logits) of the same model is what an int8-KV run is teacher-forced on
    and held to.  Returns (launches, the run's tokens and logits on the
    host)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.models.transformer import hidden, logits_from_hidden

    import numpy as np
    label = name + (":int8-kv" if int8_kv else "")
    dev = torch.device("cuda", 0)
    cfg = cut(get_config(name), layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (GEN_BATCH, prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    params = init_params(cfg, seed, dev)
    fe = frontend_for(torch, cfg, seed, GEN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    forced = None if fp32_run is None else fp32_run[0].to(dev)

    ops.reset_counts()                    # counts cover the kernel run
    run = generate(torch, params, cfg, prompt, max_len, use_kernel=True,
                   int8_kv=int8_kv, forced=forced, frontend=fe)
    launches, plain = ops.kernel_launches(), ops.plain_calls()
    cache = run.pop("cache")
    cache_gb = tree_bytes(cache) / 1e9
    kv_dtypes = sorted({str(e[n].dtype) for e in cache["layers"]
                        for n in ("k", "v") if n in e})
    if profile:
        last = run["logits"][-1].argmax(-1, keepdim=True).int()
        profile_decode(torch, params, cfg, cache, last,
                       prompt_len + GEN_STEPS, label)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    logits, tokens = run.pop("logits"), run["tokens"]
    if logits.shape != (GEN_STEPS + 1, GEN_BATCH, cfg.vocab_size):
        fail(f"{label}: logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        fail(f"{label}: non-finite logits")

    errors = {}
    capacity_moe = cfg.moe is not None and cfg.moe.impl == "capacity"
    if fp32_run is None and not capacity_moe:
        # the plain forward of prompt + generated tokens, at the positions
        # whose logits the run produced
        with torch.no_grad():
            seq = torch.cat([prompt, tokens], 1)
            x = hidden(params, cfg, seq, fe, use_kernel=False)
            x = x[:, prompt_len - 1:prompt_len + GEN_STEPS]
            want = logits_from_hidden(params, cfg, x)[..., :cfg.vocab_size]
            want = want.transpose(0, 1)
            del x
        err, scale = max_err(torch, logits, want)
        errors["plain_forward"] = {"max_abs_err": err, "tol": 1e-3 * scale}
        del want
    if fp32_run is None:
        # the plain decode path on the same tokens, from a fresh prefill
        # (the same grouping of tokens as the kernel run's)
        plain_run = generate(torch, params, cfg, prompt, max_len,
                             use_kernel=False, forced=tokens, frontend=fe)
        del plain_run["cache"]
        err, scale = max_err(torch, logits, plain_run["logits"])
        errors["plain_decode"] = {"max_abs_err": err, "tol": 1e-4 * scale}
        plain_steps = plain_run["step_ms"]
        del plain_run
    else:
        err, scale = max_err(torch, logits, fp32_run[1].to(dev))
        errors["fp32_kv_run"] = {"max_abs_err": err, "tol": 0.05 * scale}
        plain_steps = None
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    host = (tokens.cpu(), logits.cpu())
    del params, logits, prompt, forced, fe
    gc.collect()
    torch.cuda.empty_cache()

    for what, e in errors.items():
        if not e["max_abs_err"] <= e["tol"]:
            fail(f"{label}: logits vs {what}: {e['max_abs_err']:.3g} over "
                 f"tolerance {e['tol']:.3g}")
    if any(plain.values()):
        fail(f"{label}: plain versions ran in the kernel run: {plain}")
    attn, scan = layer_counts(cfg)
    want_launches = {"decode_attention": 0 if int8_kv else attn * GEN_STEPS,
                     "ssd_scan": scan, "flash_attention": 0,
                     "ensemble_combine": 0, "ensemble_combine_quant": 0}
    if launches != want_launches:
        fail(f"{label}: launches {launches}, expected {want_launches}")
    if int8_kv and kv_dtypes != ["torch.int8"]:
        fail(f"{label}: the cache's k/v are {kv_dtypes} at the end, not int8")
    steps = np.array(run["step_ms"])
    out = {"phase": f"generate:{label}", "ok": True, "card": smi,
           "layers": cfg.num_layers,
           "full_config_layers": get_config(name).num_layers,
           "frontend": None if cfg.frontend_tokens == 0 else [
               GEN_BATCH, cfg.frontend_tokens, cfg.fdim],
           "batch": GEN_BATCH, "prompt": prompt_len, "max_len": max_len,
           "steps": GEN_STEPS, "use_kernel": True, "int8_kv": int8_kv,
           "prefill_s": run["prefill_s"],
           "decode_ms_p50": float(np.percentile(steps, 50)),
           "decode_ms_p90": float(np.percentile(steps, 90)),
           "decode_tokens_per_s": GEN_BATCH * GEN_STEPS / run["wall_s"],
           "decode_wall_s": run["wall_s"], "cache_gb": cache_gb,
           "kv_dtypes": kv_dtypes, "peak_device_gb": peak_gb,
           "errors": errors, "launches": launches,
           "expected_launches": want_launches, "plain_calls": plain}
    if plain_steps is not None:
        out["plain_decode_ms_p50"] = float(np.percentile(plain_steps, 50))
    emit(out)
    return launches, host


ALLOC_ROWS, ALLOC_SEQ = 256, 128     # calibration rows of the bench
ALLOC_MAX_ITER, ALLOC_MAX_NEIGHS = 2, 6


def phase_alloc(torch, seed: int, smi: str) -> dict:
    """The paper's allocation procedure for ENS4 on this card (see the
    module docstring).  Returns the kernel launches of its benchmark runs."""
    import numpy as np
    from repro_torch.configs import ensemble
    from repro_torch.core import (AllocationOptimizer, MeasuredBench,
                                  cuda_devices)
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    dev = torch.device("cuda", 0)
    cfgs = ensemble("ENS4")
    params = [init_params(c, seed + i, dev) for i, c in enumerate(cfgs)]
    X = np.random.default_rng(seed).integers(
        0, cfgs[0].vocab_size, (ALLOC_ROWS, ALLOC_SEQ)).astype(np.int32)
    bench = MeasuredBench(cfgs, params, X)
    opt = AllocationOptimizer(cfgs, cuda_devices()[:1], bench,
                              max_iter=ALLOC_MAX_ITER,
                              max_neighs=ALLOC_MAX_NEIGHS, seq=ALLOC_SEQ,
                              seed=seed)
    ops.reset_counts()
    t0 = time.perf_counter()
    res = opt.optimize()
    wall = time.perf_counter() - t0
    launches, plain = ops.kernel_launches(), ops.plain_calls()
    benchmarked, hits = bench.calls, opt.bench.hits
    del params, bench, opt
    gc.collect()
    torch.cuda.empty_cache()
    if not (res.wfd_score > 0 and res.final_score > 0):
        fail(f"alloc:ENS4: a score is not positive: WFD {res.wfd_score}, "
             f"greedy {res.final_score}")
    if res.final_score < res.wfd_score:
        fail("alloc:ENS4: the greedy returned a matrix slower than its start")
    if res.trace.scores != sorted(res.trace.scores):
        fail(f"alloc:ENS4: the greedy's scores are not monotone: "
             f"{res.trace.scores}")
    emit({"phase": "alloc:ENS4", "ok": True, "card": smi,
          "members": [c.name for c in cfgs],
          "devices": [d.name for d in res.matrix.devices],
          "bench": "MeasuredBench (Benchmark Mode of the default system: "
                   "use_kernel=False, combine='mean') under MemoBench",
          "calib_rows": ALLOC_ROWS, "seq": ALLOC_SEQ,
          "max_iter": ALLOC_MAX_ITER, "max_neighs": ALLOC_MAX_NEIGHS,
          "wfd_matrix": res.wfd_matrix.A.tolist(),
          "wfd_rows_per_s": res.wfd_score,
          "greedy_matrix": res.matrix.A.tolist(),
          "greedy_rows_per_s": res.final_score,
          "greedy_speedup": res.final_score / res.wfd_score,
          "score_trace": res.trace.scores,
          "iterations": res.trace.iterations,
          "matrices_scored": res.trace.evaluated,
          "matrices_benchmarked": benchmarked, "memo_hits": hits,
          "wall_s": wall,
          "launches": launches, "plain_calls": plain})
    return launches


CONTROL_SEQ, CONTROL_SEG = 256, 32
CONTROL_REQ, CONTROL_ROWS = 4, 40       # the pair phase's traffic
HTTP_REQ, HTTP_ROWS = 4, 8              # JSON floats: ~5 MB a row of qwen3
CONTROL_ALLOC = [[16, 8], [16, 0]]      # member 0 on both cells: a sibling
REBATCH_ALLOC = [[16, 8], [8, 0]]       # member 0 on cell 1 at batch 8
SLOW_CHUNK_S = 0.05                     # the brownout drill's slow member 0
LAUNCH_DURATION_S = 20


def latency_summary(lat_ms) -> dict:
    import numpy as np
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "max_ms": float(max(lat_ms)), "latency_ms": list(lat_ms)}


def served_checks(name: str, Y, rows, ref, what: str) -> dict:
    """Hold ``Y`` (the answers for ``X[rows]``) to the plain reference
    ``ref`` = (logits of both members, the int8 member's row scales,
    weights), as the pair phase does; fails on any row off."""
    logits, scales, weights = ref
    c = held_to(Y, [lg[rows] for lg in logits], scales[rows], weights)
    if c["rows_off"]:
        fail(f"{name}: {what}: {c['bad_elements']} elements in rows "
             f"{c['rows_off'][:20]} off by more than atol {c['atol']:.3g} "
             f"from a whole int8 step, max residual {c['max_residual']:.3g}")
    if c["int8_flips"] > MAX_FLIP_SHARE * Y.size:
        fail(f"{name}: {what}: {c['int8_flips']} int8 code flips, over "
             f"{MAX_FLIP_SHARE:.0%} of {Y.size} elements")
    return {k: v for k, v in c.items() if k != "row_residual"}


def launches_hold(name: str, cfgs, batches, rows: int, launches, plain,
                  combine_kernels: bool) -> dict:
    """The served run went through the kernels: flash once per attention
    layer per chunk at least (``rows`` rows, each member's largest batch),
    both combine kernels where the fused combine ran, no plain version."""
    if any(plain.values()):
        fail(f"{name}: plain versions ran on the served path: {plain}")
    least = sum(layer_counts(c)[0] * math.ceil(rows / b)
                for c, b in zip(cfgs, batches))
    if launches["flash_attention"] < least:
        fail(f"{name}: flash_attention launched "
             f"{launches['flash_attention']} times, expected at least "
             f"{least}")
    for kname in ("ensemble_combine", "ensemble_combine_quant"):
        if combine_kernels and launches[kname] < 1:
            fail(f"{name}: {kname} never launched on the served path")
    return {"flash_attention": least}


def http_round(torch, url: str, X, rows) -> dict:
    """``HTTP_REQ`` concurrent requests of ``HTTP_ROWS`` rows through an
    ``EnsembleClient`` over HTTP, and what one answer costs in JSON: the
    server's encode (``y.tolist()`` and ``json.dumps``, as the server
    answers) and the client's decode (``json.loads`` and ``np.asarray``,
    as the client reads it), timed on the host."""
    import numpy as np
    from repro_torch.serving.client import EnsembleClient
    client = EnsembleClient(url=url)
    t0 = time.perf_counter()
    handles = [client.predict_async(X[rows[i * HTTP_ROWS:(i + 1) * HTTP_ROWS]])
               for i in range(HTTP_REQ)]
    Y = np.concatenate([h.result(600.0) for h in handles])
    wall = time.perf_counter() - t0
    y8 = Y[:HTTP_ROWS]
    t0 = time.perf_counter()
    body = json.dumps({"predictions": y8.tolist()}).encode()
    encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = np.asarray(json.loads(body)["predictions"], np.float32)
    decode = time.perf_counter() - t0
    if not np.array_equal(back, y8):
        fail("HTTP: the JSON round trip changed a float")
    return {"Y": Y, "wall_s": wall, "body_mb": len(body) / 1e6,
            "encode_ms": 1e3 * encode, "decode_ms": 1e3 * decode,
            "metrics": client.metrics()}


def phase_control(torch, seed: int, smi: str) -> dict:
    """``control:qwen3`` then ``brownout:qwen3`` (see the module
    docstring).  Returns the kernel launches of both served runs."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import AllocationMatrix, cuda_cells, cuda_devices
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as kq
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSystem
    from repro_torch.serving.admission import AdmissionBudget
    from repro_torch.serving.control import (BrownoutController, LiveBench,
                                             ReconfigController)
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    from repro_torch.serving.segments import PredictOptions
    from repro_torch.serving.server import _header_s
    from repro_torch.serving.server import serve as http_serve

    name = "qwen3-1.7b"
    dev = torch.device("cuda", 0)
    cfg0, cfg1 = get_config(name), cut(get_config(name), PAIRS[0][2])
    cfgs, names = [cfg0, cfg1], [cfg0.name, cfg1.name]
    t0 = time.perf_counter()
    params = [init_params(cfg0, seed, "cpu"),
              init_params(cfg1, seed + 1, "cpu")]
    t_init = time.perf_counter() - t0
    X = np.random.default_rng(seed + 17).integers(
        0, cfg0.vocab_size, (CONTROL_REQ * CONTROL_ROWS, CONTROL_SEQ)
    ).astype(np.int32)
    all_rows = np.arange(len(X))
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- A. control:qwen3 ------------------------------------------------
    plan = FaultPlan()                     # armed mid-run, see below
    cells = cuda_cells(2)[:2]
    t0 = time.perf_counter()
    system = InferenceSystem(
        cfgs, params, AllocationMatrix(cells, names, np.array(CONTROL_ALLOC)),
        combine="pallas", use_kernel=True, max_seq=CONTROL_SEQ,
        segment_size=CONTROL_SEG, member_dtypes=["fp32", "int8"],
        supervise=True, fault_plan=plan)
    t_build = time.perf_counter() - t0
    ctl = ReconfigController(system, replan=False, steal=False)
    httpd, batcher = http_serve(system, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        weights = [float(x) for x in system.accumulator.weights]
        torch.cuda.synchronize()
        ops.reset_counts()                 # counts cover the served run
        # the front door: HTTP beside the same rows in process
        http_rows = all_rows[:HTTP_REQ * HTTP_ROWS]
        front = http_round(torch, url, X, http_rows)
        t0 = time.perf_counter()
        Y_inproc = np.concatenate([
            system.predict(X[http_rows[i * HTTP_ROWS:(i + 1) * HTTP_ROWS]])
            for i in range(HTTP_REQ)])
        inproc_s = time.perf_counter() - t0
        # a burst with the topology at rest, for the spawn's latency blip
        Y_base, wall_base, lat_base = serve(system, X, CONTROL_REQ,
                                            CONTROL_ROWS)
        # live reconfiguration while a burst is in flight: member 0 on
        # cell 1 is rebatched, i.e. a new generation is spawned and the
        # old instance drained
        (old,) = [w for w in system.instances(0) if w.device_idx == 1]
        old_bytes = tree_bytes(old.params)
        target = AllocationMatrix(cells, names, np.array(REBATCH_ALLOC))
        torch.cuda.synchronize()
        b_before = torch.cuda.memory_allocated(dev)
        t_burst = time.perf_counter()
        handles = [system.predict_async(
            X[i * CONTROL_ROWS:(i + 1) * CONTROL_ROWS])
            for i in range(CONTROL_REQ)]
        t0 = time.perf_counter()
        ctl.apply(target)
        apply_s = time.perf_counter() - t0
        Y_reconf = np.concatenate([h.result(600.0) for h in handles])
        wall_reconf = max(h.req.t_submit + h.latency_s
                          for h in handles) - t_burst
        lat_reconf = [1e3 * h.latency_s for h in handles]
        (new,) = [w for w in system.instances(0) if w.device_idx == 1]
        if system.alloc.A.tolist() != REBATCH_ALLOC or new is old or \
                new.generation != 1 or new.batch_size != 8:
            fail(f"control:qwen3: the rebatch did not land: "
                 f"A={system.alloc.A.tolist()}, events "
                 f"{ctl.stats()['events']}")
        torch.cuda.synchronize()
        b_spawned = torch.cuda.memory_allocated(dev)
        if old.join(120.0):
            fail("control:qwen3: the drained instance did not stop")
        del old
        gc.collect()
        torch.cuda.synchronize()
        b_drained = torch.cuda.memory_allocated(dev)
        returned = b_spawned - b_drained
        if returned < old_bytes:
            fail(f"control:qwen3: the drain returned {returned} bytes, "
                 f"less than member 0's tree, {old_bytes}")
        # supervision: the new instance's sender dies on its next chunk,
        # mid-burst; its units are replayed on the sibling on cell 0
        fault_worker = new.worker_id
        plan.add(FaultSpec(stage="sender", kind="raise", after=0,
                           worker=fault_worker))
        handles = [system.predict_async(
            X[i * CONTROL_ROWS:(i + 1) * CONTROL_ROWS])
            for i in range(CONTROL_REQ)]
        try:
            Y_fault = np.concatenate([h.result(600.0) for h in handles])
        except Exception as e:
            fail(f"control:qwen3: a request failed under the fault: {e!r}")
        quality = [h.quality for h in handles]
        launches = ops.kernel_launches()
        plain = ops.plain_calls()
        counters = system.serving_counters()
        metrics = front["metrics"]
        live = ctl.live.snapshot()
        live["segment_time_s"] = {
            k: t * math.ceil(CONTROL_SEG / int(k.rsplit("|b", 1)[1]))
            for k, t in live["latency_ewma_s"].items()}
        workers = [system.instances(0)[0], system.instances(1)[0]]
        with torch.no_grad():             # the pair phase's reference
            tok = torch.from_numpy(X).to(workers[0].device.torch_device)
            blocks = [tok[lo:lo + 16] for lo in range(0, len(X), 16)]
            ref = (*combined_reference(torch, kq, cfgs, workers, None, X,
                                       [blocks, blocks], use_kernel=False),
                   weights)
            del tok, blocks
    finally:
        httpd.shutdown()
        batcher.stop()
        system.shutdown()
    del system, ctl, workers, new, handles, httpd, batcher
    gc.collect()
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # the quarantined instance's stage threads are leaked by design, and
    # its device tree with them (the JAX package keeps its buffers alike)
    gb_after_shutdown = torch.cuda.memory_allocated(dev) / 1e9
    if plan.fired != [(fault_worker, "sender", "raise")]:
        fail(f"control:qwen3: the fault fired as {plan.fired}")
    if counters.get("quarantines") != 1 or \
            counters.get("segments_replayed", 0) < 1:
        fail(f"control:qwen3: quarantines {counters.get('quarantines')}, "
             f"segments replayed {counters.get('segments_replayed')}")
    if any(q != 1.0 for q in quality):
        fail(f"control:qwen3: the replayed requests' quality {quality}")
    if not any(k.startswith("health.") for k in metrics["gauges"]):
        fail("control:qwen3: /metrics shows no health gauges")
    checks = {"http": served_checks("control:qwen3", front["Y"], http_rows,
                                    ref, "HTTP"),
              "in_process": served_checks("control:qwen3", Y_inproc,
                                          http_rows, ref, "in process"),
              "burst_at_rest": served_checks("control:qwen3", Y_base,
                                             all_rows, ref, "burst"),
              "burst_during_rebatch": served_checks(
                  "control:qwen3", Y_reconf, all_rows, ref, "rebatch"),
              "burst_under_fault": served_checks(
                  "control:qwen3", Y_fault, all_rows, ref, "fault")}
    served_rows = len(http_rows) * 2 + 3 * len(X)
    minima = launches_hold("control:qwen3", cfgs, [16, 8], served_rows,
                           launches, plain, combine_kernels=True)
    per_http_ms = 1e3 * front["wall_s"]
    emit({"phase": "control:qwen3", "ok": True, "card": smi,
          "members": names, "member_dtypes": ["fp32", "int8"],
          "cells": [c.name for c in cells],
          "cell_memory_gb": [c.memory_bytes / 1e9 for c in cells],
          "allocation": CONTROL_ALLOC, "rebatched_to": REBATCH_ALLOC,
          "max_seq": CONTROL_SEQ, "segment_size": CONTROL_SEG,
          "host_init_s": t_init, "system_build_s": t_build,
          "front_door": {
              "requests": HTTP_REQ, "rows_per_request": HTTP_ROWS,
              "http_wall_s": front["wall_s"],
              "in_process_wall_s": inproc_s,
              "json_body_mb_per_answer": front["body_mb"],
              "server_encode_ms_per_answer": front["encode_ms"],
              "client_decode_ms_per_answer": front["decode_ms"],
              "json_share_of_http_wall": HTTP_REQ * (
                  front["encode_ms"] + front["decode_ms"]) / per_http_ms,
              "note": "requests sent together; encode and decode timed "
                      "on one 8-row answer, on the host"},
          "burst_at_rest": {"wall_s": wall_base,
                            **latency_summary(lat_base)},
          "reconfig": {"apply_s": apply_s, "spawn_note":
                       "apply() = spawn (host-to-card copy, warm-up "
                       "forward, synchronise) + drain(wait=False)",
                       "burst_wall_s": wall_reconf,
                       **latency_summary(lat_reconf),
                       "device_gb_before_spawn": b_before / 1e9,
                       "device_gb_after_spawn": b_spawned / 1e9,
                       "device_gb_after_drain": b_drained / 1e9,
                       "bytes_returned_by_drain": b_spawned - b_drained,
                       "member0_tree_bytes": old_bytes},
          "supervision": {"fault": plan.fired,
                          "quarantines": counters.get("quarantines"),
                          "segments_replayed":
                              counters.get("segments_replayed"),
                          "worker_crashes": counters.get("worker_crashes"),
                          "quality": quality},
          "livebench": live, "peak_device_gb": peak_gb,
          "device_gb_after_shutdown": gb_after_shutdown,
          "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
          "checks": checks, "launches": launches, "launch_minima": minima,
          "plain_calls": plain})
    total = dict(launches)

    # ---- B. brownout:qwen3 -------------------------------------------------
    budget = AdmissionBudget(max_bytes=len(X) * CONTROL_SEQ * 4)
    slow = FaultPlan(FaultSpec(stage="predictor", kind="slow",
                               stall_s=SLOW_CHUNK_S, worker="w0.0"))
    system = InferenceSystem(
        cfgs, params, AllocationMatrix(cuda_devices()[:1], names,
                                       np.array([[16, 8]])),
        combine="weighted", use_kernel=True, max_seq=CONTROL_SEQ,
        segment_size=CONTROL_SEG, member_dtypes=["fp32", "int8"],
        fault_plan=slow, admission_budget=budget)
    httpd, batcher = http_serve(system, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        torch.cuda.synchronize()
        ops.reset_counts()
        # a burst at the full tier warms the live bench that prices the
        # drain estimate behind Retry-After
        system.set_profiler(LiveBench(cfgs, seq=CONTROL_SEQ))
        Y_warm, _, _ = serve(system, X, CONTROL_REQ, CONTROL_ROWS)
        # the budget is one burst's bytes: with a burst in flight, an HTTP
        # request is refused with 429 and a Retry-After
        handles = [system.predict_async(
            X[i * CONTROL_ROWS:(i + 1) * CONTROL_ROWS])
            for i in range(CONTROL_REQ)]
        req = urllib.request.Request(
            url + "/v2/predict",
            data=json.dumps({"tokens": X[:HTTP_ROWS].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=600)
            fail("brownout:qwen3: the admission budget admitted a request "
                 "over it")
        except urllib.error.HTTPError as e:
            refused = {"code": e.code, "retry_after": e.headers.get(
                "Retry-After"), "body": json.loads(e.read())}
        drain_after = system.retry_after_s()
        t0 = time.perf_counter()
        Y_full = np.concatenate([h.result(600.0) for h in handles])
        drained_in = time.perf_counter() - t0
        # the brownout drill: member 0 runs slow; the controller's level
        # rises and demotes the burst in flight to the int8 member
        ctl = BrownoutController(system, depth_ref=1.0).start()
        handles = [system.predict_async(
            X[i * CONTROL_ROWS:(i + 1) * CONTROL_ROWS])
            for i in range(CONTROL_REQ)]
        Ys = [h.result(600.0) for h in handles]
        stats = ctl.stats()
        launches = ops.kernel_launches()
        plain = ops.plain_calls()
        counters = system.serving_counters()
        served = [(h.quality, list(h.req.members), h._missing_w)
                  for h in handles]
    finally:
        httpd.shutdown()
        batcher.stop()
        system.shutdown()
    del system, ctl, handles, params, httpd, batcher
    gc.collect()
    torch.cuda.empty_cache()
    ra = refused["body"].get("retry_after_s")
    if refused["code"] != 429 or ra is None or \
            refused["retry_after"] != _header_s(ra):
        fail(f"brownout:qwen3: the refusal was {refused}")
    demoted = [i for i, (q, _, _) in enumerate(served) if q < 1.0]
    if not demoted:
        fail(f"brownout:qwen3: no request was demoted ({stats})")
    logits, scales, _ = ref
    checks = {"burst_warm": served_checks("brownout:qwen3", Y_warm, all_rows,
                                          ref, "warm burst"),
              "burst_full": served_checks("brownout:qwen3", Y_full, all_rows,
                                          ref, "full burst")}
    # each row is the full combine or, where member 0 was forgiven, the
    # int8 member's alone (the accumulator renormalizes over who reported)
    full_rows, alone_rows, Y_full_rows, Y_alone = [], [], [], []
    for i, (y, (q, members, missing)) in enumerate(zip(Ys, served)):
        rows = all_rows[i * CONTROL_ROWS:(i + 1) * CONTROL_ROWS]
        alone = np.ones(len(rows), bool) if members == [1] else (
            np.zeros(len(rows), bool) if missing is None else missing > 0)
        full_rows += list(rows[~alone])
        Y_full_rows.append(y[~alone])
        alone_rows += list(rows[alone])
        Y_alone.append(y[alone])
    if full_rows:
        checks["rows_full"] = served_checks(
            "brownout:qwen3", np.concatenate(Y_full_rows),
            np.array(full_rows), ref, "full rows")
    checks["rows_int8_alone"] = served_checks(
        "brownout:qwen3", np.concatenate(Y_alone), np.array(alone_rows),
        (logits, scales, [0.0, 1.0]), "demoted rows")
    minima = launches_hold("brownout:qwen3", cfgs[1:], [8],
                           3 * len(X), launches, plain,
                           combine_kernels=False)
    emit({"phase": "brownout:qwen3", "ok": True, "card": smi,
          "members": names, "member_dtypes": ["fp32", "int8"],
          "allocation": [[16, 8]], "combine": "weighted",
          "slow_fault": {"stage": "predictor", "stall_s": SLOW_CHUNK_S,
                         "worker": "w0.0"},
          "admission_budget_bytes": budget.max_bytes,
          "refused": {"code": refused["code"],
                      "retry_after_header": refused["retry_after"],
                      "retry_after_s": ra,
                      "retry_after_s_after": drain_after,
                      "burst_done_after_s": drained_in},
          "brownout": stats,
          "requests_demoted": counters.get("requests_demoted"),
          "quality": [q for q, _, _ in served],
          "rows_full": len(full_rows), "rows_int8_alone": len(alone_rows),
          "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
          "checks": checks, "launches": launches, "launch_minima": minima,
          "plain_calls": plain})
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_launch(smi: str) -> None:
    """``launch:ENS4``: the serve launcher as a user starts it, on two
    cells of this card, with the controller and brownout on."""
    import os
    import numpy as np
    from repro_torch.serving.client import EnsembleClient
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--ensemble",
           "ENS4", "--cells", "2", "--bench", "analytic", "--port", "0",
           "--duration", str(LAUNCH_DURATION_S), "--reconfig", "--brownout"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONPATH": str(SRC)})
    try:
        url, lines = None, []
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving "):
                url = line.split(" on ", 1)[1].split()[0]
                break
        if url is None:
            fail(f"launch:ENS4: the launcher did not serve: {lines[-20:]}")
        up_s = time.perf_counter() - t0
        from repro_torch.configs import ensemble
        cfgs = ensemble("ENS4")
        X = np.random.default_rng(5).integers(
            0, cfgs[0].vocab_size, (8, 16)).astype(np.int32)
        client = EnsembleClient(url=url)
        t0 = time.perf_counter()
        Y = client.predict(X)
        request_s = time.perf_counter() - t0
        m = client.metrics()
        rest, _ = proc.communicate(timeout=LAUNCH_DURATION_S + 120)
        lines += rest.splitlines()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        fail(f"launch:ENS4: rc {proc.returncode}: {lines[-20:]}")
    if Y.shape != (len(X), cfgs[0].vocab_size) or not np.isfinite(Y).all():
        fail(f"launch:ENS4: Y {Y.shape}, finite {np.isfinite(Y).all()}")
    health = {k: v["last"] for k, v in m["gauges"].items()
              if k.startswith("health.")}
    if not health or m.get("controller") is None or \
            m.get("brownout") is None:
        fail(f"launch:ENS4: /metrics lacks health, controller or brownout: "
             f"{sorted(m)}")
    emit({"phase": "launch:ENS4", "ok": True, "card": smi, "command":
          " ".join(["python", "-m"] + cmd[2:]), "rc": proc.returncode,
          "seconds_to_serve": up_s, "request_s": request_s,
          "Y_shape": list(Y.shape), "health": health,
          "controller": {k: m["controller"][k] for k in
                         ("generation", "counters", "enabled")},
          "brownout": m["brownout"], "output": lines[:12]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="serve each pair's requests a second time, and run "
                         "a few more decode steps of each generation phase, "
                         "under torch.profiler and print device time by "
                         "kernel")
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
               phase_quant(torch, gen, dev), phase_ssd(torch, gen, dev),
               phase_decode(torch, gen, dev)]

    # 4. end to end, one member pair at a time; the launches of the main
    # paths are summed over the pairs' served runs and the generation runs
    launches = {}
    for name, layers, int8_layers in PAIRS:
        got = phase_pair(torch, name, layers, int8_layers, args.seed, smi,
                         args.profile)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    # 5. generation, one model at a time; its launches join the sums
    fp32_runs = {}
    for name, layers, prompt_len, max_len, int8_kv in GEN_PHASES:
        got, host = phase_generate(torch, name, layers, prompt_len, max_len,
                                   int8_kv, args.seed, smi, args.profile,
                                   fp32_runs.get(name) if int8_kv else None)
        if not int8_kv:
            fp32_runs[name] = host
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    # 6. the allocator, Benchmark Mode on this card
    for k, v in phase_alloc(torch, args.seed, smi).items():
        launches[k] = launches.get(k, 0) + v

    # 7-9. the front door and the control plane, then the serve launcher
    for k, v in phase_control(torch, args.seed, smi).items():
        launches[k] = launches.get(k, 0) + v
    phase_launch(smi)
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
