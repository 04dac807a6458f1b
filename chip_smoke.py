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
   version's and one TF32 pass's.  ``kernel:gemm_tf32x3`` (the SSM
   members' projections, ``ops.dense``) is held at mamba2's four served
   shapes and at ragged ones to an error against float64 within twice
   cuBLAS f32's, timed there beside cuBLAS f32 (``library_ms``) and its
   3xTF32 bound, and swept over M at both widths for ``crossover``, the
   least M from which it beats the library (``gemm_tf32x3.MIN_ROWS``).
   ``kernel:gemm_tf32x3_grouped`` (the dropless MoE's expert products,
   ``ops.grouped_dense``) is held at granite-4.0-h-small's member-0 share
   (9 of 72 experts held, one of them emptied, gate/up gathered K 4096 ->
   768 and down 768 -> 4096 scattered) and on a call with no rows to the
   same error rule, and timed beside cuBLAS f32 one expert at a time;
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
   layer the scan kernel once per chunk, each SSM or hybrid layer's
   projections the GEMM kernel where ``ops.dense``'s rule takes them
   (``gemm_share``: of the mixers' projection calls, the kernel's), that
   the combine kernels ran, and that no plain version did.
   ``h2d_staged``, the uploads that the
   predictors started on their copy streams ahead of the forward that read
   them, must be above 0 (``--profile`` adds the copies' streams beside
   the kernels' and the share of copy time that overlaps a kernel).  The
   capacity dispatch makes a row's answer depend on the other row of its
   512-token group and jump where a near tie of the router flips between
   the flash kernel and the plain attention, so for granite the plain
   forward runs on the workers' own batches with the served run's expert
   choices replayed layer by layer;
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
   layer of the prefill and its projections on the GEMM kernel where the
   rule takes them, and no plain version;
6. ``alloc:ENS4``: the paper's allocation procedure on this card for the
   four members of ENS4: worst-fit-decreasing on ``cuda_devices()``, then
   the bounded greedy scoring each matrix with ``MeasuredBench`` (the
   torch system in Benchmark Mode, with its defaults: no kernels, the
   "mean" combine) under ``MemoBench``.  It prints both matrices, their
   rows/s, the matrices evaluated and the greedy's speedup over its start.
7. ``train:qwen3``: qwen3-1.7b at full width (28 layers, vocab 151936)
   trained for 8 steps from random weights on the byte tokenizer's
   ``TextCorpus`` over a fixed text (the n-gram table would take 184.7 GB
   at this vocabulary): 4 sequences of 4096 tokens a step in 2
   microbatches, remat, no kernels (they have no backward), AdamW with 2
   warmup steps.  Loss, gradient norm, lr and seconds per step, tokens/s
   and the peak device GB; the first loss must be near its random-init
   value, every loss and norm finite and the last loss lower by a margin.
   ``train:ckpt``: the trained params through the port's checkpoint (the
   JAX package's npz layout) into a temporary directory and back into a
   fresh tree on the card, every leaf bit-equal, then a prefill of 512
   tokens and 16 decode steps from the restored tree through the kernels
   (decode attention, and flash over the prompt and what it generated),
   held to the plain decode path and the flash forward;
8. ``train:step``: qwen3 at full width and 2 layers, one step's loss and
   every gradient in f32 against the same step with float64 parameters
   and a float64 cross-entropy, the same f32 step with TF32 products as a
   control (recorded, not held), and a step at ``accum_steps=2`` against
   one at 1;
9. ``control:qwen3``: qwen3-1.7b at full width in fp32 and the same
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
   combine kernels and no plain version; ``h2d_staged`` and each worker's
   copy stream (two instances share the card's one compute stream) are
   reported;
10. ``brownout:qwen3``: a second system on the same host trees, one cell,
   ``combine="weighted"``, member 0 slowed by a repeating ``slow`` fault,
   and an admission budget of one burst's bytes; three drills on it.  In
   the first, a fresh ``LiveBench`` (``set_profiler``), warmed by one
   burst, prices the tier table, and with the next burst in flight an
   HTTP request is refused with 429 and a ``Retry-After`` from
   ``retry_after_s``; the second and third keep member 1 and member 0
   alone.  In each, with a fresh ``BrownoutController`` running, the
   burst after it is demoted in flight: those requests complete with
   quality under 1, each request keeps a tier of the controller (the
   measured costs' tier keeps the member of least cost per weight), and
   each row is held to the plain combine of the members that served it
   (planned at admission, less the member demoted where its weight was
   forgiven), renormalized as the accumulator does.  Each drill reports
   its tiers, the member costs, each request's members and forgiven
   rows, and the true max |Y - Y_ref|; a miss prints ``demotion_report``;
11. ``sim:qwen3``: a third system on the host trees, one cell, [[16, 8]],
   ``combine="pallas"``, a ``LiveBench`` attached and warmed by one burst;
   the offered trace of the next 25 bursts of 8 requests of 8 rows (200
   requests, each burst sent as the one before it completes, every
   answer held to the plain forwards) is recorded, a ``ServiceModel`` is
   fitted from the ``LiveBench`` snapshot, and the trace is replayed twice
   through the port's ``SimSystem`` on the same allocation: both replays
   identical, every request completed, and simulated req/s, p50 and p99
   beside the measured (the ratio is recorded, not held: ``LiveBench``
   prices a backlog on the card);
12. ``launch:ENS4``: ``python -m repro_torch.launch.serve --ensemble ENS4
   --cells 2 --bench analytic --port 0 --duration 20 --reconfig
   --brownout`` as a subprocess on this card: one request answered with
   finite Y of the right shape, ``GET /metrics`` with the health gauges
   and the controller and brownout sections, and rc 0.
13. ``parallel:flash_decode`` (run after ``train:step``, on a world-size-1
   ``nccl`` group and a 1 x 1 ``DeviceMesh``): ``parallel.collectives.
   flash_decode`` on DTensors at qwen3's decode shape (B16 L2048 H16 KV8
   hd128 f32, slot 1087) and at hymba's wrapped 1024-slot ring, held to
   the plain masked softmax (1e-5) and to the decode kernel's output, its
   cache write exact; then 16 ``decode_step``s of qwen3-1.7b (full width,
   prompt 1024, 2048 slots) under the variant ``cache_seqshard`` with the
   params and cache placed per ``parallel.sharding``, held to the plain
   decode path (``1e-4·max(1, max|ref|)``), with no kernel launched, and
   ms a step beside the kernel path's and the plain path's.
   ``parallel:prefill`` (same group and mesh): the sharded prefill step
   (``launch.steps.build_prefill_step``) of mamba2-1.3b and hymba-1.5b at
   full width, params placed per ``parallel.sharding``, a prompt of 4096
   tokens at batch 2 (the SSM mixer's per-part projection, its heads
   placed over "model", and the chunked attention's in-place scores):
   the last-token logits and the ``h`` cache held to the plain
   ``prefill`` (``1e-4·max(1, max|ref|)``), no kernel launched, ms
   beside the plain path's;
14. ``train:pod``: the training launcher's pod path
   (``launch.train.train_pod``) in this process on the same group,
   qwen3-1.7b at full width, a shape registered here (seq 4096, global
   batch 2), 3 steps: each loss within 1e-4 (relative) of 3 plain
   ``train_step``s on the same params and batches (the AdamW update on
   DTensors shows from the second), s a step beside the plain step's and
   ``train:qwen3``'s.  ``dryrun:pod``: the same step (f32, remat, 1 x 1
   mesh) traced under ``FakeTensorMode`` by ``launch.steps.lower_step``,
   its predicted peak (argument + temp bytes of its memory analysis) held
   within 10 % of ``train:pod``'s measured ``max_memory_allocated``.  The
   group is destroyed after them;
15. ``dryrun:qwen3``: ``python -m repro_torch.launch.dryrun --arch
   qwen3-1.7b`` (train_4k, prefill_32k, decode_32k on a fake 16 x 16
   mesh, on the host, started before ``train:qwen3`` and collected here)
   and its roofline rows: FLOPs, per-rank bytes, collective bytes by type,
   the memory analysis, the dominant term and MODEL/traced FLOPs
   (PyTorch's counts, not XLA's); it fails when a record's per-rank
   argument + temp reaches the card's 80 GB, and prints each temp beside
   the JAX dry-run's (XLA's buffer assignment on a CPU host).  Beside it,
   two more host processes trace mamba2-1.3b's and hymba-1.5b's
   ``prefill_32k``: each fails when its temp exceeds its bound over the
   JAX record's (2x mamba2's, 1.5x hymba's);
16. ``example:quickstart``: ``examples/torch_quickstart.py`` as a
   subprocess on two cells of the card, rc 0.

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
import weakref
from pathlib import Path
from typing import Optional

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
GEMM_SHAPES = [                # (M, K, N): mamba2-1.3b's projections served
    (4096, 2048, 8512),        # in_proj, a chunk of 16 rows x 256 tokens
    (2048, 2048, 8512),        # in_proj, 8 rows
    (4096, 4096, 2048),        # out_proj, 16 rows
    (2048, 4096, 2048),        # out_proj, 8 rows
]
# ragged: M, K and N off every tile, M at least gemm_tf32x3.MIN_ROWS
# (ops.dense sends no smaller M to the kernel)
GEMM_CASES = [(1030, 1604, 2044), (1000, 1212, 1004), (4099, 2052, 8516)]
GEMM_SWEEP_M = (128, 256, 512, 768, 1024, 1536, 2048)
GEMM_ERR_RATIO = 2.0           # kernel's error vs float64 over cuBLAS f32's
# granite-4.0-h-small's dropless MoE, member 0's share on one card: 32 rows
# of 256 tokens, top-10 of 72 experts, experts 0-8 held, d 4096, width 768
GROUPED_TOKENS, GROUPED_D, GROUPED_F = 32 * 256, 4096, 768
GROUPED_EXPERTS, GROUPED_TOP_K, GROUPED_HELD = 72, 10, 9
GROUPED_EMPTY = 3              # a held expert whose assignments are moved
                               # off it, so that one expert has no rows


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


def gemm_inputs(torch, gen, dev, m: int, k: int, n: int):
    """x (M, K) and w (K, N) ~ N(0, 1/K): outputs of order one."""
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    return x, w


def gemm_errors(torch, gemm, x, w) -> dict:
    """The kernel's and cuBLAS f32's largest and relative rms error against
    the float64 product; fails where the kernel's largest is over
    ``GEMM_ERR_RATIO`` times cuBLAS's."""
    want = x.double() @ w.double()
    out = {}
    for name, y in (("kernel", gemm.gemm_tf32x3(x, w)),
                    ("library_f32", x @ w)):
        e = y.double() - want
        if not torch.isfinite(y).all():
            fail(f"gemm_tf32x3: non-finite {name} output")
        out[name] = {"max_abs_err": e.abs().max().item(),
                     "rel_rms_err": (e.norm() / want.norm()).item()}
    out["ratio"] = out["kernel"]["max_abs_err"] / max(
        out["library_f32"]["max_abs_err"], 1e-30)
    if out["ratio"] > GEMM_ERR_RATIO:
        fail(f"gemm_tf32x3: {list(x.shape)} x {list(w.shape)}: error against "
             f"float64 {out['ratio']:.3g} times cuBLAS f32's: {out}")
    return out


def phase_gemm(torch, gen, dev):
    from repro_torch.kernels import gemm_tf32x3 as gemm
    cases = []
    for m, k, n in GEMM_CASES:
        x, w = gemm_inputs(torch, gen, dev, m, k, n)
        cases.append({"shape": [m, k, n], **gemm_errors(torch, gemm, x, w)})
    timed = []
    for m, k, n in GEMM_SHAPES:
        x, w = gemm_inputs(torch, gen, dev, m, k, n)
        errs = gemm_errors(torch, gemm, x, w)
        t = timings(torch, lambda: gemm.gemm_tf32x3(x, w), lambda: x @ w,
                    library=lambda: x @ w)
        flops = 2.0 * m * k * n
        nbytes = 4.0 * (m * k + k * n + m * n)
        # each product runs three times on the tensor cores (3xTF32)
        t["bound_ms"], t["bound_by"] = bound(nbytes, 3 * flops, TF32_FLOPS)
        t["bound_rate"] = "3 x operations / 495 TFLOP/s (3xTF32, tensor cores)"
        t["cuda_core_bound_ms"] = bound(nbytes, flops, F32_FLOPS)[0]
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        t["tflops"] = flops / t["ms"] / 1e9
        t["library_tflops"] = flops / t["library_ms"] / 1e9
        t["bytes"], t["flops"] = nbytes, flops
        timed.append({"shape": [m, k, n], "takes": gemm.takes(m, k, n),
                      "err_vs_f64": errs, **t})
        del x, w
    # the least M from which the kernel is faster than cuBLAS f32 at every
    # larger M of the sweep, at each served width
    sweep, crossover = [], {}
    for k, n in sorted({(k, n) for _, k, n in GEMM_SHAPES}):
        faster = []
        for m in GEMM_SWEEP_M:
            x, w = gemm_inputs(torch, gen, dev, m, k, n)
            ms = device_ms(torch, lambda: gemm.gemm_tf32x3(x, w))
            lib = device_ms(torch, lambda: x @ w)
            sweep.append({"shape": [m, k, n], "ms": ms, "library_ms": lib})
            faster.append(ms < lib)
        least = None
        for m, f in reversed(list(zip(GEMM_SWEEP_M, faster))):
            if not f:
                break
            least = m
        crossover[f"{k}x{n}"] = least
    torch.cuda.synchronize()
    main = timed[0]
    emit({"phase": "kernel:gemm_tf32x3", "ok": True, "cases": cases,
          "main_shape": main["shape"], "timed": timed, "sweep": sweep,
          "crossover": crossover, "min_rows": gemm.MIN_ROWS,
          **{key: main[key] for key in SUMMARY_TIMES}})
    return {"name": "gemm_tf32x3", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gemm_tf32x3.cu",
            "replaces": "none (the JAX package leaves products to XLA)",
            "max_abs_err": main["err_vs_f64"]["kernel"]["max_abs_err"],
            **{key: main[key] for key in SUMMARY_TIMES},
            "bound_rate": main["bound_rate"],
            "cuda_core_bound_ms": main["cuda_core_bound_ms"]}


def phase_grouped(torch, gen, dev):
    """The grouped 3xTF32 expert GEMM (``csrc/gemm_tf32x3_grouped.cu``) at
    granite4h-pair's member-0 shapes: a random top-10 of 72 router over 32
    x 256 tokens, the 9 held experts' assignments grouped on the card
    (``models.moe.held_assignments``), one held expert emptied.  The gate/up
    product (rows gathered, K 4096 -> N 768) and the down product (K 768
    -> N 4096, scattered, router-weighted, onto the tokens) are each held
    to float64 within ``GEMM_ERR_RATIO`` times the plain version's (cuBLAS
    f32) error, a 0-row call too, and each call is one launch; then timed
    as the other kernels are, beside cuBLAS f32 one expert at a time at
    offsets the host knows."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.kernels import gemm_tf32x3 as gemm
    from repro_torch.kernels import ref
    from repro_torch.models.moe import _router, held_assignments
    tokens, d, f = GROUPED_TOKENS, GROUPED_D, GROUPED_F
    held = GROUPED_HELD
    cfg = ModelConfig(
        name="granite-share", family="hybrid", num_layers=1, d_model=d,
        num_heads=32, num_kv_heads=8, d_ff=0, vocab_size=100352,
        moe=MoEConfig(num_experts=GROUPED_EXPERTS, top_k=GROUPED_TOP_K,
                      d_ff_expert=f, impl="dropless", experts_held=held))
    x = torch.randn((tokens, d), generator=gen, device=dev)
    router = torch.randn((d, GROUPED_EXPERTS), generator=gen,
                         device=dev) * 0.02
    weights, idx, _ = _router(x, router, GROUPED_TOP_K)
    idx = torch.where(idx == GROUPED_EMPTY, GROUPED_EXPERTS - 1, idx)
    offsets, rows, scale, counts = held_assignments(cfg, idx, weights)
    offs = offsets.tolist()
    a, used = rows.shape[0], offs[-1]
    if counts[GROUPED_EMPTY].item() != 0 or min(
            c for e, c in enumerate(counts.tolist())
            if e != GROUPED_EMPTY) == 0:
        fail(f"gemm_tf32x3_grouped: rows per expert {counts.tolist()}: "
             f"expected expert {GROUPED_EMPTY} alone empty")

    def check(what, got, plain, want, n_rows):
        got, plain, want = got[:n_rows], plain[:n_rows], want[:n_rows]
        if not torch.isfinite(got).all():
            fail(f"gemm_tf32x3_grouped: non-finite {what} output")
        err = (got.double() - want).abs().max().item() if n_rows else 0.0
        lib = (plain.double() - want).abs().max().item() if n_rows else 0.0
        if err > GEMM_ERR_RATIO * lib:
            fail(f"gemm_tf32x3_grouped: {what}: error against float64 "
                 f"{err:.3g}, over {GEMM_ERR_RATIO} times the plain "
                 f"version's {lib:.3g}")
        return {"max_abs_err": err, "library_f32_max_abs_err": lib,
                "ratio": err / max(lib, 1e-30)}

    def library_loop(inp, w, gather, dst=None):
        """cuBLAS f32, one product an expert, the offsets known here."""
        def run():
            y = dst if dst is not None else inp.new_empty((a, w.shape[2]))
            for e in range(held):
                lo, hi = offs[e], offs[e + 1]
                if hi <= lo:
                    continue
                xe = inp[rows[lo:hi].long()] if gather else inp[lo:hi]
                if dst is None:
                    y[lo:hi] = xe @ w[e]
                else:
                    y.index_add_(0, rows[lo:hi].long(),
                                 scale[lo:hi, None] * (xe @ w[e]))
            return y
        return run

    def launched(fn):
        """``fn()``, which has to launch the kernel exactly once."""
        before = gemm.launches.snapshot()["gemm_tf32x3_grouped"]
        y = fn()
        torch.cuda.synchronize()
        n = gemm.launches.snapshot()["gemm_tf32x3_grouped"] - before
        if n != 1:
            fail(f"gemm_tf32x3_grouped: {n} launches for one call")
        return y

    timed, errors = [], {}
    for name, k, n in (("gate_up", d, f), ("down", f, d)):
        w = torch.randn((held, k, n), generator=gen, device=dev) * k ** -0.5
        if name == "gate_up":
            inp, dst = x, None
            kernel = lambda: gemm.gemm_tf32x3_grouped(inp, w, offsets,
                                                      rows=rows)
            plain = lambda: ref.gemm_tf32x3_grouped_ref(inp, w, offsets,
                                                        rows=rows)
            got = launched(kernel)
            want = ref.gemm_tf32x3_grouped_ref(inp.double(), w.double(),
                                               offsets, rows=rows)
            errors[name] = check(name, got, plain(), want, used)
            lib = library_loop(inp, w, True)
        else:
            inp = torch.randn((a, k), generator=gen, device=dev)
            start = torch.randn((tokens, n), generator=gen, device=dev)
            dst = start.clone()
            got = launched(lambda: gemm.gemm_tf32x3_grouped(
                inp, w, offsets, out=dst, scatter=rows, scale=scale))
            want = ref.gemm_tf32x3_grouped_ref(
                inp.double(), w.double(), offsets, out=start.double(),
                scatter=rows, scale=scale.double())
            errors[name] = check(name, got, ref.gemm_tf32x3_grouped_ref(
                inp, w, offsets, out=start.clone(), scatter=rows,
                scale=scale), want, tokens)
            kernel = lambda: gemm.gemm_tf32x3_grouped(
                inp, w, offsets, out=dst, scatter=rows, scale=scale)
            plain = lambda: ref.gemm_tf32x3_grouped_ref(
                inp, w, offsets, out=dst, scatter=rows, scale=scale)
            lib = library_loop(inp, w, False, dst)
        t = timings(torch, kernel, plain, library=lib)
        flops = 2.0 * used * k * n
        nbytes = 4.0 * (held * k * n + used * k + used * n)
        # each product runs three times on the tensor cores (3xTF32)
        t["bound_ms"], t["bound_by"] = bound(nbytes, 3 * flops, TF32_FLOPS)
        t["bound_rate"] = "3 x operations / 495 TFLOP/s (3xTF32, tensor cores)"
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        t["tflops"] = flops / t["ms"] / 1e9
        t["library_tflops"] = flops / t["library_ms"] / 1e9
        t["bytes"], t["flops"] = nbytes, flops
        timed.append({"product": name, "shape": [used, k, n],
                      "experts": held, "err_vs_f64": errors[name], **t})
        del w, inp, dst, got, want
    # a call with no rows at all: one launch, nothing written
    empty = torch.zeros(held + 1, dtype=torch.int32, device=dev)
    w = torch.randn((held, f, d), generator=gen, device=dev)
    dst = torch.randn((16, d), generator=gen, device=dev)
    start = dst.clone()
    launched(lambda: gemm.gemm_tf32x3_grouped(
        torch.randn((16, f), generator=gen, device=dev), w, empty, out=dst,
        scatter=torch.zeros(16, dtype=torch.int32, device=dev),
        scale=torch.ones(16, device=dev)))
    if not torch.equal(dst, start):
        fail("gemm_tf32x3_grouped: a call with no rows wrote its output")
    del w, dst, start, x
    torch.cuda.synchronize()
    main = timed[0]
    emit({"phase": "kernel:gemm_tf32x3_grouped", "ok": True,
          "tokens": tokens, "held_rows": used, "rows_bound": a,
          "rows_per_expert": counts.tolist(), "empty_expert": GROUPED_EMPTY,
          "main_product": main["product"], "timed": timed,
          **{key: main[key] for key in SUMMARY_TIMES}})
    return {"name": "gemm_tf32x3_grouped", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gemm_tf32x3_grouped.cu",
            "replaces": "none (the JAX package's MoE layers are einsums)",
            "max_abs_err": main["err_vs_f64"]["max_abs_err"],
            **{key: main[key] for key in SUMMARY_TIMES},
            "bound_rate": main["bound_rate"]}


def dense_launches(cfg, rows: int) -> int:
    """GEMM kernel launches of one ``ssm_mixer`` pass over every SSM or
    hybrid layer of ``cfg`` at ``rows`` rows (batch x tokens): its in_proj
    and out_proj where ``gemm_tf32x3.takes`` them."""
    from repro_torch.kernels import gemm_tf32x3 as gemm
    if cfg.ssm is None:
        return 0
    di, n = cfg.d_inner, cfg.ssm.d_state
    per = (int(gemm.takes(rows, cfg.d_model, 2 * di + 2 * n + cfg.ssm_heads))
           + int(gemm.takes(rows, di, cfg.d_model)))
    return per * layer_counts(cfg)[1]


def gemm_share(launches, library) -> Optional[float]:
    """The GEMM kernel's share of the SSM mixers' projection calls."""
    total = launches.get("gemm_tf32x3", 0) + library.get("dense", 0)
    return launches.get("gemm_tf32x3", 0) / total if total else None


# ---------------------------------------------------------------------------
def tree_bytes(tree) -> int:
    from repro_torch.kernels.quant import tree_map
    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
        return t
    tree_map(add, tree)
    return total[0]


def serve(system, X, n_req: int, rows: int, t0=None):
    """Send ``n_req`` concurrent requests of ``rows`` rows; returns (Y,
    wall seconds from ``t0`` (default: now) to the last completion,
    per-request latency in ms).  Completion times are the accumulator's
    own (``latency_s``, taken as it finishes a request)."""
    import numpy as np
    t0 = time.perf_counter() if t0 is None else t0
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
    emit({"phase": f"profile:{pair}", **device_time(prof, window),
          "h2d": copy_overlap(prof)})


def copy_overlap(prof) -> dict:
    """The host-to-device copies of a profiled window beside its kernels:
    for each stream that ran copies, their count, time and the share of
    that time during which some kernel ran; the kernels' streams with
    their counts.  The staged uploads run on the workers' copy streams;
    the compute stream's copies wait for its kernels."""
    import bisect
    from torch.autograd import DeviceType

    def span(e):
        if hasattr(e, "start_ns"):
            return e.start_ns(), e.start_ns() + e.duration_ns()
        return 1e3 * e.start_us(), 1e3 * (e.start_us() + e.duration_us())
    copies, kernels = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        if "HtoD" in name:
            copies.setdefault(e.device_resource_id(), []).append(span(e))
        elif not name.startswith(("Memcpy", "Memset")):
            kernels.setdefault(e.device_resource_id(), []).append(span(e))
    busy = []                                # kernel time, merged
    for lo, hi in sorted(x for v in kernels.values() for x in v):
        if busy and lo <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], hi)
        else:
            busy.append([lo, hi])
    starts = [lo for lo, _ in busy]
    out = {}
    for stream, spans in sorted(copies.items()):
        copy_ns = overlap_ns = 0.0
        for lo, hi in spans:
            copy_ns += hi - lo
            i = max(0, bisect.bisect_right(starts, lo) - 1)
            while i < len(busy) and busy[i][0] < hi:
                overlap_ns += max(0.0, min(hi, busy[i][1]) -
                                  max(lo, busy[i][0]))
                i += 1
        out[str(stream)] = {
            "copies": len(spans), "copy_ms": copy_ns * 1e-6,
            "share_overlapping_a_kernel":
                overlap_ns / copy_ns if copy_ns else None}
    return {"copy_streams": out,
            "kernel_streams": {str(k): len(v)
                               for k, v in sorted(kernels.items())}}


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
                       use_kernel: bool, routing=None, unquantized=None):
    """Each member's forward on the worker's own parameters over
    ``batches[m]`` (token tensors whose rows are rows of ``X``, zero rows
    being padding), the int8 member's logits quantized per row as the
    server does: returns each member's logits for the rows of ``X``, in
    order, and the int8 member's row scales.  ``routing`` (an open
    ``RoutingLog``) is told which member runs; a list ``unquantized``
    receives the int8 member's logits before that quantization."""
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
            if unquantized is not None:
                unquantized.append(lg.cpu().numpy())
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
    # no int8 member in the combine: no step to flip by
    k = np.rint(diff / step) if weights[1] else np.zeros_like(diff)
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
    from repro_torch.serving.worker import MIN_BUCKET

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
        library = ops.library_calls()
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
    staged = counters.get("h2d_staged", 0)
    if not staged:
        fail(f"{name}: no staged upload was used ({counters})")
    # every dispatched chunk runs its member's forward once: one flash launch
    # per attention or hybrid layer, one scan launch per SSM or hybrid layer,
    # and a GEMM launch for each of its projections that ops.dense's rule
    # takes at the least chunk (the least bucket of max_seq tokens)
    # (no pair here has a dropless MoE layer, so the grouped GEMM has to
    # stay unlaunched)
    minima = {"flash_attention": 0, "ssd_scan": 0, "gemm_tf32x3": 0,
              "gemm_tf32x3_grouped": 0}
    for cfg, bs in zip(cfgs, batches):
        chunks = math.ceil(n_req * rows / bs)
        attn, scan = layer_counts(cfg)
        minima["flash_attention"] += attn * chunks
        minima["ssd_scan"] += scan * chunks
        minima["gemm_tf32x3"] += dense_launches(cfg, MIN_BUCKET * max_seq) \
            * chunks
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
          "library_calls": library,
          "gemm_share": gemm_share(launches, library),
          "batches": counters.get("batches"), "h2d_staged": staged,
          "stage_total_s": stages,
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
             int8_kv: bool = False, forced=None, frontend=None,
             steps: int = GEN_STEPS) -> dict:
    """prefill + ``steps`` decode steps, greedy over the real vocabulary
    unless ``forced`` (B, steps) gives the tokens.  Returns the logits of
    the prefill and of every step (steps + 1, B, V), the tokens fed, the
    prefill's seconds, each step's ms (CUDA events) and the decode wall
    time, and the cache."""
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
              for _ in range(steps + 1)]
        t0 = time.perf_counter()
        ev[0].record()
        for t in range(steps):
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
                        for i in range(steps)]}


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
    library = ops.library_calls()
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
                     "ensemble_combine": 0, "ensemble_combine_quant": 0,
                     "gemm_tf32x3": dense_launches(cfg,
                                                   GEN_BATCH * prompt_len),
                     "gemm_tf32x3_grouped": 0}
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
           "expected_launches": want_launches, "plain_calls": plain,
           "library_calls": library,
           "gemm_share": gemm_share(launches, library)}
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


TRAIN_MODEL = "qwen3-1.7b"
TRAIN_SEQ = 4096                 # train_4k's sequence length
TRAIN_BATCH, TRAIN_ACCUM = 4, 2  # microbatch 2: 16384 tokens a step
TRAIN_STEPS = 8
TRAIN_FIRST_LOSS_TOL = 0.5       # the first loss within this of its
                                 # expected value at random init
TRAIN_MIN_DROP = 2.0             # the last loss below the first by this
TRAIN_TEXT = (                   # the byte tokenizer's corpus: the n-gram
    "the quick brown fox jumps over the lazy dog. "     # table would need
    "pack my box with five dozen liquor jugs. "          # 184.7 GB at
    "how vexingly quick daft zebras jump! "              # 151936 classes
    "sphinx of black quartz, judge my vow. ") * 64
CKPT_PROMPT, CKPT_STEPS = 512, 16
STEP_LAYERS, STEP_BATCH, STEP_SEQ = 2, 2, 512
STEP_LOSS_TOL = 1e-4             # |loss f32 - loss f64|
STEP_GRAD_TOL = 1e-4             # per leaf, x max |g| of the f64 step
ACCUM_TOL = 1e-4                 # tests/test_training.py's accum bounds


def train_corpus(cfg, seq: int, seed: int):
    from repro_torch.data.tokenizer import TextCorpus
    return TextCorpus(TRAIN_TEXT, seq, seed=seed, vocab_size=cfg.vocab_size)


def phase_train(torch, seed: int, smi: str, profile: bool):
    """``train:qwen3``, then ``train:ckpt`` on its trained params (see the
    module docstring).  Returns the kernel launches of the checkpoint's
    generation (training launches none) and the median seconds a step."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.models.transformer import _INIT_SCALE
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step

    dev = torch.device("cuda", 0)
    cfg = get_config(TRAIN_MODEL)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, seed, dev)
    corpus = train_corpus(cfg, TRAIN_SEQ, seed)
    ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, ocfg, use_kernel=False, remat=True,
                           accum_steps=TRAIN_ACCUM)
    state = opt.init(params)
    ops.reset_counts()
    history = []
    for i in range(TRAIN_STEPS):
        batch = corpus.batch(TRAIN_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        m = {k: float(v) for k, v in m.items()}     # waits for the step
        torch.cuda.synchronize()
        m["s"] = time.perf_counter() - t0
        history.append(m)
    launches, plain = ops.kernel_launches(), ops.plain_calls()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        batch = corpus.batch(TRAIN_BATCH)
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        emit({"phase": f"profile:train:{TRAIN_MODEL}",
              **device_time(prof, window)})
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    losses = [m["loss"] for m in history]
    # random init: the tied head's logits are normal with variance
    # INIT_SCALE² · d over a unit-rms hidden state, so the expected first
    # loss is ln(V) + σ²/2 (12.34 at qwen3's d 2048), not ln(V) (11.93)
    sigma2 = _INIT_SCALE ** 2 * cfg.d_model
    first_want = math.log(cfg.vocab_size) + sigma2 / 2
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in history):
        fail(f"train:qwen3: a loss or gradient norm is not finite: "
             f"{history}")
    if abs(losses[0] - first_want) > TRAIN_FIRST_LOSS_TOL:
        fail(f"train:qwen3: first loss {losses[0]:.4f}, not within "
             f"{TRAIN_FIRST_LOSS_TOL} of ln({cfg.vocab_size}) + "
             f"{sigma2 / 2:.4f} = {first_want:.4f}")
    if not losses[-1] < losses[0] - TRAIN_MIN_DROP:
        fail(f"train:qwen3: the loss fell from {losses[0]:.4f} to "
             f"{losses[-1]:.4f}, less than {TRAIN_MIN_DROP}")
    if any(launches.values()) or plain.get("flash_attention") or \
            plain.get("ssd_scan"):
        fail(f"train:qwen3: kernel launches {launches} or plain kernel "
             f"calls {plain} in training (use_kernel=False)")
    step_s = float(np.median([m["s"] for m in history[1:]]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit({"phase": f"train:{TRAIN_MODEL}", "ok": True, "card": smi,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "params": cfg.param_count(),
          "params_gb": tree_bytes(params) / 1e9, "data": "TextCorpus",
          "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
          "accum_steps": TRAIN_ACCUM, "tokens_per_step": tokens,
          "remat": True, "use_kernel": False, "steps": TRAIN_STEPS,
          "loss": losses, "grad_norm": [m["grad_norm"] for m in history],
          "lr": [m["lr"] for m in history],
          "step_s": [m["s"] for m in history], "step_s_median": step_s,
          "first_step_s": history[0]["s"], "tokens_per_s": tokens / step_s,
          "peak_device_gb": peak_gb,
          "first_loss_expected": first_want,
          "first_loss_minus_ln_vocab": losses[0] - math.log(cfg.vocab_size),
          "loss_drop": losses[0] - losses[-1],
          "min_drop_held": TRAIN_MIN_DROP, "launches": launches})
    try:
        return phase_ckpt(torch, cfg, params, corpus, seed, smi), step_s
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()


def phase_ckpt(torch, cfg, params, corpus, seed: int, smi: str) -> dict:
    """``train:ckpt``: the trained params through the port's checkpoint
    and back into a fresh tree on the card, then generation from the
    restored tree through the kernels, held to the plain paths."""
    import os
    import shutil
    import tempfile
    from repro_torch.data import tokenizer as tok
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.models.transformer import hidden, logits_from_hidden
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import tree as T

    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save(tmp, TRAIN_STEPS, params)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
        fresh = init_params(cfg, seed + 1, dev)
        t0 = time.perf_counter()
        restored = ckpt.restore(tmp, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    unequal = [k for (k, a), b in zip(T.flatten_with_paths(params),
                                      T.leaves(restored))
               if not (a.dtype == b.dtype and a.device == b.device
                       and torch.equal(a, b))]
    if unequal:
        fail(f"train:ckpt: leaves not bit-equal after the round trip: "
             f"{unequal}")
    keys = [k for k, _ in T.flatten_with_paths(restored)]

    prompt = torch.from_numpy(
        corpus.batch(GEN_BATCH)["tokens"][:, :CKPT_PROMPT]).to(dev)
    max_len = CKPT_PROMPT + CKPT_STEPS
    ops.reset_counts()
    run = generate(torch, restored, cfg, prompt, max_len, use_kernel=True,
                   steps=CKPT_STEPS)
    del run["cache"]
    tokens = run["tokens"]
    with torch.no_grad():      # flash over the prompt and what it generated
        x = hidden(restored, cfg, torch.cat([prompt, tokens], 1),
                   use_kernel=True)[:, CKPT_PROMPT - 1:max_len]
        want = logits_from_hidden(restored, cfg, x)[..., :cfg.vocab_size]
        want = want.transpose(0, 1)
        del x
    launches, plain = ops.kernel_launches(), ops.plain_calls()
    plain_run = generate(torch, restored, cfg, prompt, max_len,
                         use_kernel=False, forced=tokens, steps=CKPT_STEPS)
    del plain_run["cache"]
    logits = run["logits"]
    errors = {}
    err, scale = max_err(torch, logits, plain_run["logits"])
    errors["plain_decode"] = {"max_abs_err": err, "tol": 1e-4 * scale}
    err, scale = max_err(torch, logits, want)
    errors["flash_forward"] = {"max_abs_err": err, "tol": 1e-3 * scale}
    sample = tok.decode(tokens[0].tolist())
    del restored, logits, want, plain_run, run, prompt
    gc.collect()
    torch.cuda.empty_cache()
    for what, e in errors.items():
        if not e["max_abs_err"] <= e["tol"]:
            fail(f"train:ckpt: logits vs {what}: {e['max_abs_err']:.3g} "
                 f"over tolerance {e['tol']:.3g}")
    attn, _ = layer_counts(cfg)
    want_launches = {"decode_attention": attn * CKPT_STEPS,
                     "flash_attention": attn, "ssd_scan": 0,
                     "ensemble_combine": 0, "ensemble_combine_quant": 0,
                     "gemm_tf32x3": 0, "gemm_tf32x3_grouped": 0}
    if launches != want_launches or any(plain.values()):
        fail(f"train:ckpt: launches {launches} (expected {want_launches}), "
             f"plain calls {plain}")
    emit({"phase": "train:ckpt", "ok": True, "card": smi,
          "leaves": len(keys), "keys_head": keys[:4],
          "bytes_written": nbytes, "save_s": save_s,
          "restore_s": restore_s, "bit_equal": True,
          "generate": {"batch": GEN_BATCH, "prompt": CKPT_PROMPT,
                       "steps": CKPT_STEPS, "use_kernel": True,
                       "sample_row0": sample},
          "errors": errors, "launches": launches,
          "expected_launches": want_launches, "plain_calls": plain})
    return launches


def loss_and_grads_f64(torch, params, cfg, batch):
    """The reference of ``train:step``: ``loss_fn``'s loss (vocab padding
    and label -100 masked) with the cross-entropy in float64, and its
    gradient with respect to every leaf of the float64 ``params``."""
    import numpy as np
    from repro_torch.models import forward
    from repro_torch.training import tree as T
    leaves = T.leaves(params)
    dev = leaves[0].device
    tokens = torch.from_numpy(np.asarray(batch["tokens"])).to(dev)
    labels = torch.from_numpy(np.asarray(batch["labels"])).to(dev)
    for p in leaves:
        p.requires_grad_(True)
    try:
        logits, aux = forward(params, cfg, tokens, remat=True)
        logp = torch.log_softmax(logits[..., :cfg.vocab_size].double(), -1)
        mask = labels >= 0
        nll = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])
        ce = (nll[..., 0] * mask).sum() / mask.sum().clamp(min=1)
        loss = ce + aux.double()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(loss.detach()), list(grads)


def phase_train_step(torch, seed: int, smi: str) -> None:
    """``train:step``: qwen3 at full width and STEP_LAYERS layers, one
    step's loss and gradients in f32 against the same step with float64
    params and a float64 cross-entropy (f64 matrix products; the
    forward's own f32 casts in the norms, RoPE and attention stay), then
    accum_steps=2 against 1.  A control: the same f32 step with TF32
    matrix products, recorded beside the tolerance, not held."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree as T
    from repro_torch.training.train_loop import (loss_and_grads,
                                                 make_train_step)

    dev = torch.device("cuda", 0)
    cfg = cut(get_config(TRAIN_MODEL), STEP_LAYERS)
    p32 = init_params(cfg, seed, dev)
    p64 = T.unflatten(p32, [t.double() for t in T.leaves(p32)])
    batch = train_corpus(cfg, STEP_SEQ, seed).batch(STEP_BATCH)
    l64, g64 = loss_and_grads_f64(torch, p64, cfg, batch)
    del p64

    def held(loss, g):
        errs = {}
        for (k, a), b in zip(T.flatten_with_paths(g), g64):
            errs[k] = {"max_abs_err": (a.double() - b).abs().max().item(),
                       "tol": STEP_GRAD_TOL * b.abs().max().item()}
        return abs(float(loss) - l64), errs

    l32, _, g32 = loss_and_grads(p32, cfg, batch, remat=True)
    loss_err, grads = held(l32, g32)
    del g32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ltf, _, gtf = loss_and_grads(p32, cfg, batch, remat=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_loss_err, tf32 = held(ltf, gtf)
    del gtf, g64
    # accumulation over 2 microbatches against one batch, one step each
    ocfg = opt.AdamWConfig()
    runs = {}
    for accum in (1, 2):
        p = T.unflatten(p32, [t.clone() for t in T.leaves(p32)])
        p, _, m = make_train_step(cfg, ocfg, remat=True, accum_steps=accum)(
            p, opt.init(p), batch)
        runs[accum] = (p, float(m["ce"]))
    accum_ce = abs(runs[1][1] - runs[2][1])
    accum_params = max((a - b).abs().max().item() for a, b in
                       zip(T.leaves(runs[1][0]), T.leaves(runs[2][0])))
    del runs, p32, p
    gc.collect()
    torch.cuda.empty_cache()
    bad = {k: g for k, g in grads.items()
           if not g["max_abs_err"] <= g["tol"]}
    if loss_err > STEP_LOSS_TOL or bad:
        fail(f"train:step: f32 vs f64 loss error {loss_err:.3g} (tol "
             f"{STEP_LOSS_TOL}), gradient leaves over tolerance: {bad}")
    if not (accum_ce < ACCUM_TOL and accum_params < ACCUM_TOL):
        fail(f"train:step: accum_steps=2 vs 1: ce {accum_ce:.3g}, params "
             f"{accum_params:.3g} (bound {ACCUM_TOL})")

    def worst(errs):
        return max(g["max_abs_err"] / g["tol"] for g in errs.values())

    emit({"phase": "train:step", "ok": True, "card": smi,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "batch": STEP_BATCH, "seq": STEP_SEQ,
          "loss_f32": float(l32), "loss_f64": l64,
          "loss_err": loss_err, "loss_tol": STEP_LOSS_TOL,
          "grad_tol": f"{STEP_GRAD_TOL} x max|g| of the leaf (f64)",
          "grads": grads, "worst_err_over_tol": worst(grads),
          "tf32_control": {
              "loss_err": tf32_loss_err,
              "worst_err_over_tol": worst(tf32),
              "leaves_over_tol": sorted(
                  k for k, g in tf32.items()
                  if not g["max_abs_err"] <= g["tol"]),
              "leaves": len(tf32)},
          "accum": {"ce_err": accum_ce, "max_param_delta": accum_params,
                    "bound": ACCUM_TOL}})


CONTROL_SEQ, CONTROL_SEG = 256, 32
CONTROL_REQ, CONTROL_ROWS = 4, 40       # the pair phase's traffic
HTTP_REQ, HTTP_ROWS = 4, 8              # JSON floats: ~5 MB a row of qwen3
CONTROL_ALLOC = [[16, 8], [16, 0]]      # member 0 on both cells: a sibling
REBATCH_ALLOC = [[16, 8], [8, 0]]       # member 0 on cell 1 at batch 8
SLOW_CHUNK_S = 0.05                     # the brownout drill's slow member 0
LAUNCH_DURATION_S = 20
FD_RING_POS = 1500                      # hymba's 1024-slot ring, wrapped
FD_TOL = 1e-5                           # flash_decode vs the plain path
FD_KERNEL_TOL = 2e-5                    # ... vs the decode kernel (its own
                                        # tolerance in kernel:decode_attention)
FD_MODEL = "qwen3-1.7b"
FD_PROMPT, FD_MAX_LEN, FD_STEPS = 1024, 2048, 16
FD_STEP_TOL = 1e-4                      # x max(1, max |ref|), PERF.md §2
POD_SHAPE = "pod_smoke"                 # registered by train:pod
POD_SEQ, POD_BATCH, POD_STEPS = 4096, 2, 3
POD_LOSS_RTOL = 1e-4
POD_PEAK_RTOL = 0.10                    # dryrun:pod's predicted peak
DRYRUN_ARCH = "qwen3-1.7b"              # train_4k, prefill_32k, decode_32k
DRYRUN_TIMEOUT_S = 600
# a record's per-rank argument + temp must stay under the card's 80 GB
DRYRUN_RANK_BYTES = 80e9
# the JAX package's records of the same three steps (``python -m
# repro.launch.dryrun --arch qwen3-1.7b`` on a CPU host): XLA's buffer
# assignment for the host CPU, printed beside the port's, not the card's
JAX_CPU_TEMP = {"train_4k": 25804510296, "prefill_32k": 2336571504,
                "decode_32k": 5541482864}
# the SSM members' sharded prefill_32k: the JAX records' temp (same
# command, same host kind) and the port's bound over it
DRYRUN_SSM = {"mamba2-1.3b": (1815483248, 2.0),
              "hymba-1.5b": (7799956880, 1.5)}
SP_MODELS = ("mamba2-1.3b", "hymba-1.5b")   # parallel:prefill
SP_BATCH, SP_PROMPT = 2, 4096
SP_TOL = 1e-4                           # x max(1, max |ref|)
QUICKSTART_TIMEOUT_S = 600
SIM_BURSTS, SIM_REQ, SIM_ROWS = 25, 8, 8  # sim:qwen3's recorded trace: 200
                                        # requests, each burst sent as the
                                        # one before it completes


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
    miss = served_miss(c, Y.size, f"{name}: {what}")
    if miss is not None:
        fail(miss)
    return {k: v for k, v in c.items() if k != "row_residual"}


def served_miss(c, size: int, what: str):
    """``served_checks``' verdict on ``held_to``'s result ``c`` for
    ``size`` elements: None, or what missed."""
    if c["rows_off"]:
        return (f"{what}: {c['bad_elements']} elements in rows "
                f"{c['rows_off'][:20]} off by more than atol "
                f"{c['atol']:.3g} from a whole int8 step, max residual "
                f"{c['max_residual']:.3g}")
    if c["int8_flips"] > MAX_FLIP_SHARE * size:
        return (f"{what}: {c['int8_flips']} int8 code flips, over "
                f"{MAX_FLIP_SHARE:.0%} of {size} elements")
    return None


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


def supervision_report(torch, system, workers, dev) -> dict:
    """What supervision saw, for a served burst that failed: its counters,
    each worker's health, stage heartbeats (state, seconds since the
    stamp) and crash, and the card's memory.  ``workers`` may be a
    ``WeakSet``: a quarantined worker lives on in its leaked threads."""
    import traceback
    now = time.perf_counter()
    counters = system.serving_counters()
    return {
        "counters": {k: counters.get(k) for k in (
            "worker_crashes", "stalls_detected", "quarantines",
            "segments_replayed")},
        "workers": {w.worker_id: {
            "health": w.health(system.watchdog_s),
            "stages": {s: [st, now - t] for s, (st, t) in w._hb.items()},
            "crash": None if w.crash_cause is None else "".join(
                traceback.format_exception(w.crash_cause))[-1500:]}
            for w in workers},
        "device_gb_allocated": torch.cuda.memory_allocated(dev) / 1e9,
        "device_gb_reserved": torch.cuda.memory_reserved(dev) / 1e9}


def control_inputs(seed: int):
    """``control:qwen3``'s pair and traffic: qwen3-1.7b at full width
    (fp32) and at ``PAIRS[0]``'s int8 layers, trees made on the host, and
    the token rows of one burst.  Returns (cfgs, params, X)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    name = "qwen3-1.7b"
    cfgs = [get_config(name), cut(get_config(name), PAIRS[0][2])]
    params = [init_params(cfgs[0], seed, "cpu"),
              init_params(cfgs[1], seed + 1, "cpu")]
    X = np.random.default_rng(seed + 17).integers(
        0, cfgs[0].vocab_size, (CONTROL_REQ * CONTROL_ROWS, CONTROL_SEQ)
    ).astype(np.int32)
    return cfgs, params, X


def control_reference(torch, cfgs, workers, X, weights):
    """The pair phase's plain reference for the rows of ``X`` on the
    served workers' own trees (``combined_reference`` in blocks of 16, no
    kernel): returns ((logits, the int8 member's row scales, weights),
    the int8 member's logits before the output quantization)."""
    from repro_torch.kernels import quant as kq
    raw1 = []
    with torch.no_grad():
        tok = torch.from_numpy(X).to(workers[0].device.torch_device)
        blocks = [tok[lo:lo + 16] for lo in range(0, len(X), 16)]
        ref = (*combined_reference(torch, kq, cfgs, workers, None, X,
                                   [blocks, blocks], use_kernel=False,
                                   unquantized=raw1), weights)
    return ref, raw1[0]


def phase_control(torch, seed: int, smi: str) -> dict:
    """``control:qwen3`` then ``brownout:qwen3`` (see the module
    docstring).  Returns the kernel launches of both served runs."""
    import numpy as np
    from repro_torch.core import AllocationMatrix, cuda_cells
    from repro_torch.kernels import ops
    from repro_torch.serving import InferenceSystem
    from repro_torch.serving.control import ReconfigController
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    from repro_torch.serving.server import serve as http_serve

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cfgs, params, X = control_inputs(seed)
    t_init = time.perf_counter() - t0
    names = [c.name for c in cfgs]
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
        # weakly: the drained instance must be free to go (see below)
        seen = weakref.WeakSet(system.workers)
        t0 = time.perf_counter()
        ctl.apply(target)
        apply_s = time.perf_counter() - t0
        seen.update(system.workers)
        try:
            Y_reconf = np.concatenate([h.result(600.0) for h in handles])
        except Exception as e:
            fail(f"control:qwen3: a request failed during the rebatch "
                 f"(apply {apply_s:.3f} s): {e!r}; "
                 f"{supervision_report(torch, system, seen, dev)}")
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
            fail(f"control:qwen3: a request failed under the fault: {e!r}; "
                 f"{supervision_report(torch, system, seen, dev)}")
        quality = [h.quality for h in handles]
        launches = ops.kernel_launches()
        plain = ops.plain_calls()
        counters = system.serving_counters()
        copy_streams = {w.worker_id: w._copy.stream_id
                        for w in system.workers}
        if len(set(copy_streams.values())) != len(copy_streams):
            fail(f"control:qwen3: workers share a copy stream: "
                 f"{copy_streams}")
        metrics = front["metrics"]
        live = ctl.live.snapshot()
        live["segment_time_s"] = {
            k: t * math.ceil(CONTROL_SEG / int(k.rsplit("|b", 1)[1]))
            for k, t in live["latency_ewma_s"].items()}
        workers = [system.instances(0)[0], system.instances(1)[0]]
        ref, raw1 = control_reference(torch, cfgs, workers, X, weights)
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
          "h2d_staged": counters.get("h2d_staged", 0),
          "copy_streams": copy_streams,
          "device_gb_after_shutdown": gb_after_shutdown,
          "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
          "checks": checks, "launches": launches, "launch_minima": minima,
          "plain_calls": plain})
    total = dict(launches)

    # ---- B. brownout:qwen3 -------------------------------------------------
    for k, v in phase_brownout(torch, cfgs, params, X, ref, raw1,
                               smi).items():
        total[k] = total.get(k, 0) + v

    # ---- C. sim:qwen3 ------------------------------------------------------
    for k, v in phase_sim(torch, cfgs, params, X, all_rows, ref,
                          smi).items():
        total[k] = total.get(k, 0) + v
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


# brownout:qwen3's drills on its one system: the tier table the measured
# costs name, then each member alone (the measured costs may name either,
# PERF.md), so every run holds rows served by either member alone
BROWNOUT_TIERS = (None, ((0, 1), (1,)), ((0, 1), (0,)))
DRILL_COUNTERS = ("requests_demoted", "members_demoted", "rows_demoted",
                  "brownout_planned", "h2d_staged")


def brownout_system(torch, cfgs, params, X, stall_s: float = SLOW_CHUNK_S):
    """``brownout:qwen3``'s system: one cell, [[16, 8]], ``combine=
    "weighted"``, member 0 stalled ``stall_s`` a chunk by a repeating
    ``slow`` fault, an admission budget of one burst's bytes, and an HTTP
    front door on port 0.  Returns (system, the slow fault's spec (its
    ``stall_s`` may be changed between drills), the budget, the HTTP
    server, its batcher, its URL)."""
    import numpy as np
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.serving import InferenceSystem
    from repro_torch.serving.admission import AdmissionBudget
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    from repro_torch.serving.server import serve as http_serve
    budget = AdmissionBudget(max_bytes=len(X) * CONTROL_SEQ * 4)
    spec = FaultSpec(stage="predictor", kind="slow", stall_s=stall_s,
                     worker="w0.0")
    system = InferenceSystem(
        cfgs, params, AllocationMatrix(cuda_devices()[:1],
                                       [c.name for c in cfgs],
                                       np.array([[16, 8]])),
        combine="weighted", use_kernel=True, max_seq=CONTROL_SEQ,
        segment_size=CONTROL_SEG, member_dtypes=["fp32", "int8"],
        fault_plan=FaultPlan(spec), admission_budget=budget)
    httpd, batcher = http_serve(system, port=0)
    return (system, spec, budget, httpd, batcher,
            f"http://127.0.0.1:{httpd.server_address[1]}")


def brownout_drill(torch, system, cfgs, X, url: str, *, tiers=None,
                   refuse: bool = False, trace: bool = False) -> dict:
    """One drill on ``brownout_system``'s system.  With ``tiers`` None, a
    fresh ``LiveBench`` warmed by a burst at the full tier prices the tier
    table; with ``refuse``, the next burst is in flight while an HTTP
    request over the admission budget is refused (429 and Retry-After);
    then a fresh ``BrownoutController`` (on ``tiers`` where given) demotes
    the burst after it in flight.  The controller is stopped and detached
    after it, so the next drill starts at level 0.  With ``trace``, the
    tracer records which (request, segment, member) units the senders
    forgave.  Returns what was served: the answers, each request's planned
    and demoted members and forgiven weight, the counters' growth, the
    tiers, whether they were given, and the member costs."""
    import numpy as np
    from repro_torch.serving.control import BrownoutController, LiveBench
    before = system.serving_counters()
    out = {"Y_warm": None, "Y_full": None, "refused": None}
    if tiers is None:
        system.set_profiler(LiveBench(cfgs, seq=CONTROL_SEQ))
        out["Y_warm"], _, _ = serve(system, X, CONTROL_REQ, CONTROL_ROWS)
    if refuse:
        # the budget is one burst's bytes: with a burst in flight, an
        # HTTP request is refused with 429 and a Retry-After
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
            out["refused"] = {"code": e.code, "retry_after": e.headers.get(
                "Retry-After"), "body": json.loads(e.read())}
        out["retry_after_s_after"] = system.retry_after_s()
        t0 = time.perf_counter()
        out["Y_full"] = np.concatenate([h.result(600.0) for h in handles])
        out["burst_done_after_s"] = time.perf_counter() - t0
    # the drill: member 0 runs slow; the controller's level rises and
    # demotes the burst in flight to the tier's members
    ctl = BrownoutController(system, depth_ref=1.0, tiers=tiers)
    costs = ctl.member_costs()
    if trace:
        system.tracer.clear()
        system.tracer.enabled = True
    try:
        ctl.start()
        handles = [system.predict_async(
            X[i * CONTROL_ROWS:(i + 1) * CONTROL_ROWS])
            for i in range(CONTROL_REQ)]
        Ys = [h.result(600.0) for h in handles]
    finally:
        ctl.stop()
        system.brownout = None
        system.tracer.enabled = False
    by_sender = None
    if trace:
        by_sender = set()
        for w in system.workers:
            for ev in system.tracer.ring(f"{w.worker_id}/sender").snapshot():
                if ev[1] == "forgive_demoted":
                    by_sender.add((ev[4], ev[5], w.model_idx))
    after = system.serving_counters()
    return {**out, "Ys": Ys, "rows": CONTROL_ROWS,
            "served": [served_record(h) for h in handles],
            "by_sender": by_sender, "brownout": ctl.stats(),
            "tiers_given": tiers is not None, "member_costs": costs,
            "counters": {k: after.get(k, 0) - before.get(k, 0)
                         for k in DRILL_COUNTERS}}


def served_record(h) -> dict:
    """What a drill reads of a completed request's handle: its quality,
    the members it was planned with at admission, those demoted
    mid-flight, the combine weight forgiven on each row and its
    segments' row bounds."""
    return {"rid": h.req.rid, "quality": h.quality,
            "members": sorted(h.req.members),
            "demoted": sorted(h.req.demoted), "missing": h._missing_w,
            "bounds": [h.req.bounds(s) for s in range(h.req.num_segments())]}


def drill_groups(served, rows: int) -> dict:
    """Which members served each row of a drill's burst (``rows`` rows a
    request, in order): the members a request was planned with at
    admission, less those demoted mid-flight on the rows whose combine
    weight was forgiven.  Returns {members: [row]}."""
    groups = {}
    for i, s in enumerate(served):
        full = tuple(s["members"])
        cut = tuple(m for m in full if m not in s["demoted"])
        missing = s["missing"]
        for j in range(rows):
            forgiven = missing is not None and missing[j] > 0
            groups.setdefault(cut if forgiven else full, []).append(
                i * rows + j)
    return groups


GROUP_NAMES = {(0, 1): "rows_full", (1,): "rows_int8_alone",
               (0,): "rows_fp32_alone"}


def group_weights(weights, members) -> list:
    """The combine weights of ``members`` renormalized over them, as the
    accumulator renormalizes a row over the members that reported."""
    total = sum(weights[m] for m in members)
    return [weights[m] / total if m in members else 0.0
            for m in range(len(weights))]


def tier_miss(run, weights):
    """Whether a drill demoted to its controller's tier: every request
    planned at admission with fewer members, and every request demoted
    mid-flight, kept a tier below the full one; the deepest tier served
    some rows alone; and, where the tiers were priced from the measured
    costs, the deepest tier keeps the member with the least cost per
    combine weight.  Returns None, or what missed."""
    tiers = [tuple(t) for t in run["brownout"]["tiers"]]
    for s in run["served"]:
        full = tuple(s["members"])
        cut = tuple(m for m in full if m not in s["demoted"])
        for kept in {full, cut} - {tiers[0]}:
            if kept not in tiers[1:]:
                return (f"request {s['rid']} kept members {list(kept)}, "
                        f"not a tier of {tiers}")
    if not drill_groups(run["served"], run["rows"]).get(tiers[-1]):
        return f"no row was served by the tier {list(tiers[-1])} alone"
    if not run["tiers_given"]:
        per_weight = [c / w for c, w in zip(run["member_costs"], weights)]
        if any(per_weight[k] > min(per_weight) for k in tiers[-1]):
            return (f"the tier {list(tiers[-1])} does not keep the member "
                    f"of least cost per weight {per_weight}")
    return None


def drill_verdict(run, ref, raw1) -> dict:
    """Hold a drill's answers to the plain reference ``ref`` (as
    ``served_checks`` does, without failing): the warm and full bursts to
    the full combine, each row of the drilled burst to the combine of the
    members that served it (``drill_groups``), and the members each
    request kept to the controller's tiers (``tier_miss``).  Returns the
    verdict, each request's classification, the rows and true max |Y -
    Y_ref| of each group, and on a miss the ``demotion_report``."""
    import numpy as np
    logits, scales, weights = ref
    Y = np.concatenate(run["Ys"])
    checks, miss = {}, tier_miss(run, weights)
    for name, got in (("burst_warm", run["Y_warm"]),
                      ("burst_full", run["Y_full"])):
        if got is None:
            continue
        c = held_to(got, logits, scales, weights)
        checks[name] = c
        miss = miss or served_miss(c, got.size, name)
    groups = drill_groups(run["served"], run["rows"])
    off = {}
    for who, rows in sorted(groups.items()):
        rows = np.array(rows)
        c = held_to(Y[rows], [lg[rows] for lg in logits],
                    scales[rows], group_weights(weights, who))
        name = GROUP_NAMES[who]
        checks[name] = c
        m = served_miss(c, Y[rows].size, name)
        if m:
            miss = miss or m
            off[who] = rows[c["rows_off"]]
    out = {"ok": miss is None, "miss": miss,
           "requests": drill_requests(run),
           "groups": {GROUP_NAMES[k]: len(v) for k, v in groups.items()},
           "max_abs_err": {k: c["max_abs_err"] for k, c in checks.items()},
           "checks": {k: {f: v for f, v in c.items() if f != "row_residual"}
                      for k, c in checks.items()}}
    if miss is not None:
        out["report"] = demotion_report(run, Y, off, ref, raw1)
    return out


def forgiving_stage(s: dict, row: int, by_sender):
    """Where a request's row lost its demoted member: at admission (the
    request was planned without it), a sender (a ``forgive_demoted``
    instant for its segment) or the batcher (forgiven before packing);
    "in flight" where the drill was not traced (``by_sender`` None); None
    for a row every member served."""
    if s["missing"] is None or s["missing"][row] <= 0:
        return "admission" if len(s["members"]) < 2 else None
    if by_sender is None:
        return "in flight"
    seg = next(k for k, (lo, hi) in enumerate(s["bounds"]) if lo <= row < hi)
    return "sender" if any((s["rid"], seg, m) in by_sender
                           for m in s["demoted"]) else "batcher"


def drill_requests(run) -> list:
    """Each request of the drilled burst: tier-planned at admission or
    demoted mid-flight, its quality, its members (planned, demoted) and
    its forgiven rows by the stage that forgave them."""
    out = []
    for s in run["served"]:
        stages = {}
        for j in range(run["rows"]):
            st = forgiving_stage(s, j, run["by_sender"])
            if st is not None:
                stages[st] = stages.get(st, 0) + 1
        out.append({"rid": s["rid"], "planned": len(s["members"]) < 2,
                    "demoted_midflight": bool(s["demoted"]),
                    "quality": s["quality"], "members": s["members"],
                    "demoted": s["demoted"],
                    "forgiven_rows": None if s["missing"] is None
                    else int((s["missing"] > 0).sum()),
                    "forgiven_by": stages})
    return out


def demotion_report(run, Y, off, ref, raw1) -> dict:
    """For drilled rows that missed their reference (``off``: members ->
    rows off): the controller's tiers, the member costs they were priced
    from and the counters, and for the first rows of each group: the true
    max |Y - Y_ref| (not the residual off a whole int8 step), the
    least-squares fit of the row as a·P1 + b·P0 (a mix of the members, or
    a row not renormalized, shows here), the nearest row of each member's
    reference and of the full combine (a row served out of place shows
    here), the max residual against the int8 member's plain logits before
    the output quantization, and the stage that forgave it."""
    import numpy as np
    (P0, P1), _, weights = ref
    full = weights[0] * P0 + weights[1] * P1
    rows = []
    for who, bad in off.items():
        w = group_weights(weights, who)
        for r in bad[:4]:
            i, j = divmod(int(r), run["rows"])
            y = Y[r].astype(np.float64)
            A = np.stack([P1[r], P0[r]], 1).astype(np.float64)
            (a, b), *_ = np.linalg.lstsq(A, y, rcond=None)
            near = {}
            for name, P in (("P0", P0), ("P1", P1), ("full", full)):
                d = np.abs(P - Y[r]).max(axis=1)
                near[name] = [int(d.argmin()), float(d.min())]
            rows.append({
                "row": int(r), "members": list(who),
                "true_max_abs": float(np.abs(
                    Y[r] - (w[0] * P0[r] + w[1] * P1[r])).max()),
                "a_P1": float(a), "b_P0": float(b), "nearest": near,
                "max_abs_vs_unquantized_P1": float(
                    np.abs(Y[r] - raw1[r]).max()),
                "forgiven_by": forgiving_stage(run["served"][i], j,
                                               run["by_sender"])})
    return {"tiers": run["brownout"]["tiers"],
            "level": run["brownout"]["level"],
            "member_costs": run["member_costs"],
            "counters": run["counters"], "rows": rows}


def drill_line(run, verdict) -> dict:
    """A drill's JSON record: its verdict and classification, the true
    max |Y - Y_ref| by group, the controller's tiers and the member costs
    they were priced from, the counters' growth, and the report on a
    miss."""
    line = {k: verdict[k] for k in ("ok", "miss", "requests", "groups",
                                    "max_abs_err")}
    line.update({"tiers": run["brownout"]["tiers"],
                 "tiers_given": run["tiers_given"],
                 "level": run["brownout"]["level"],
                 "member_costs": run["member_costs"],
                 "counters": run["counters"]})
    if "report" in verdict:
        line["report"] = verdict["report"]
    return line


def phase_brownout(torch, cfgs, params, X, ref, raw1, smi: str) -> dict:
    """``brownout:qwen3`` (see the module docstring): one drill for each
    of ``BROWNOUT_TIERS`` on the one system ``brownout_system`` builds,
    each held to the plain reference ``ref`` of ``control:qwen3``
    (``raw1``: the int8 member's logits before the output quantization,
    for the miss report).  Any miss fails the phase.  Returns the kernel
    launches of the served runs."""
    from repro_torch.kernels import ops
    from repro_torch.serving.server import _header_s
    system, _, budget, httpd, batcher, url = brownout_system(
        torch, cfgs, params, X)
    runs = []
    try:
        torch.cuda.synchronize()
        ops.reset_counts()
        for d, tiers in enumerate(BROWNOUT_TIERS):
            runs.append(brownout_drill(torch, system, cfgs, X, url,
                                       tiers=tiers, refuse=d == 0))
        launches = ops.kernel_launches()
        plain = ops.plain_calls()
    finally:
        httpd.shutdown()
        batcher.stop()
        system.shutdown()
    del system, httpd, batcher
    gc.collect()
    torch.cuda.empty_cache()
    refused = runs[0]["refused"]
    ra = refused["body"].get("retry_after_s")
    if refused["code"] != 429 or ra is None or \
            refused["retry_after"] != _header_s(ra):
        fail(f"brownout:qwen3: the refusal was {refused}")
    lines = []
    for d, run in enumerate(runs):
        verdict = drill_verdict(run, ref, raw1)
        if not verdict["ok"]:
            print(json.dumps({"brownout:qwen3 drill": d, **drill_line(
                run, verdict)}, default=str), file=sys.stderr, flush=True)
            fail(f"brownout:qwen3: drill {d}: {verdict['miss']}")
        lines.append({"drill": d, **drill_line(run, verdict),
                      "checks": verdict["checks"]})
    # member 1 serves every row of the warm and full bursts and of the
    # drill whose tier keeps it
    minima = launches_hold("brownout:qwen3", cfgs[1:], [8], 3 * len(X),
                           launches, plain, combine_kernels=False)
    emit({"phase": "brownout:qwen3", "ok": True, "card": smi,
          "members": [c.name for c in cfgs],
          "member_dtypes": ["fp32", "int8"],
          "allocation": [[16, 8]], "combine": "weighted",
          "slow_fault": {"stage": "predictor", "stall_s": SLOW_CHUNK_S,
                         "worker": "w0.0"},
          "admission_budget_bytes": budget.max_bytes,
          "refused": {"code": refused["code"],
                      "retry_after_header": refused["retry_after"],
                      "retry_after_s": ra,
                      "retry_after_s_after": runs[0]["retry_after_s_after"],
                      "burst_done_after_s": runs[0]["burst_done_after_s"]},
          "drills": lines,
          "max_abs_err": max(max(ln["max_abs_err"].values())
                             for ln in lines),
          "launches": launches, "launch_minima": minima,
          "plain_calls": plain})
    return launches


def phase_sim(torch, cfgs, params, X, rows, ref, smi: str) -> dict:
    """``sim:qwen3``: the offered trace of SIM_BURSTS bursts of SIM_REQ
    requests, recorded on the card, replayed twice through the port's
    simulator with a ``ServiceModel`` fitted from the ``LiveBench`` of the
    same run.  Returns the served runs' kernel launches."""
    import numpy as np
    from repro_torch.core import AllocationMatrix, cuda_devices
    from repro_torch.kernels import ops
    from repro_torch.serving import InferenceSystem
    from repro_torch.serving.control import LiveBench
    from repro_torch.serving.sim import ServiceModel, SimSystem
    from repro_torch.serving.trace import TraceRecorder

    alloc = AllocationMatrix(cuda_devices()[:1], [c.name for c in cfgs],
                             np.array([[16, 8]]))
    system = InferenceSystem(
        cfgs, params, alloc, combine="pallas", use_kernel=True,
        max_seq=CONTROL_SEQ, segment_size=CONTROL_SEG,
        member_dtypes=["fp32", "int8"])
    rec = TraceRecorder()
    n_burst = SIM_REQ * SIM_ROWS
    checks, lat = {}, []
    try:
        live = LiveBench(cfgs, seq=CONTROL_SEQ)
        system.set_profiler(live)
        torch.cuda.synchronize()
        ops.reset_counts()
        serve(system, X, CONTROL_REQ, CONTROL_ROWS)     # warms the bench
        system.trace_recorder = rec
        t0 = time.perf_counter()
        for b in range(SIM_BURSTS):
            sel = rows[(np.arange(n_burst) + b * SIM_ROWS) % len(rows)]
            Y, wall, lat_b = serve(system, X[sel], SIM_REQ, SIM_ROWS, t0=t0)
            lat += lat_b
            c = served_checks("sim:qwen3", Y, sel, ref, f"burst {b}")
            checks["max_abs_err"] = max(checks.get("max_abs_err", 0.0),
                                        c["max_abs_err"])
            checks["int8_flips"] = (checks.get("int8_flips", 0)
                                    + c["int8_flips"])
        system.trace_recorder = None
        launches, plain = ops.kernel_launches(), ops.plain_calls()
        snap = live.snapshot()
    finally:
        system.shutdown()
    del system, Y
    gc.collect()
    torch.cuda.empty_cache()
    minima = launches_hold("sim:qwen3", cfgs, [16, 8], len(X), launches,
                           plain, combine_kernels=True)
    trace = rec.events()
    n_req = SIM_BURSTS * SIM_REQ
    svc = ServiceModel.from_livebench(snap)
    replays = [SimSystem.from_alloc(alloc, svc, segment_size=CONTROL_SEG,
                                    record_events=True).run(trace)
               for _ in range(2)]
    sim = replays[0].results()
    if replays[1].results() != sim or \
            replays[1].event_log != replays[0].event_log:
        fail("sim:qwen3: two replays of one trace differ")
    if sim["completed"] != len(trace) or len(trace) != n_req:
        fail(f"sim:qwen3: {sim['completed']} of {len(trace)} recorded "
             f"requests completed in the simulation ({n_req} sent)")
    measured = {"throughput_req_per_s": n_req / wall,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)), "wall_s": wall}
    ratios = {k: sim[k] / measured[k]
              for k in ("throughput_req_per_s", "p50_ms", "p99_ms")}
    emit({"phase": "sim:qwen3", "ok": True, "card": smi,
          "allocation": [[16, 8]], "segment_size": CONTROL_SEG,
          "trace": {"requests": len(trace), "bursts": SIM_BURSTS,
                    "rows": sum(e.rows for e in trace),
                    "span_s": trace[-1].t - trace[0].t},
          "service_model": snap["latency_ewma_s"],
          "measured": measured,
          "simulated": {k: sim[k] for k in (
              "throughput_req_per_s", "p50_ms", "p99_ms", "makespan_s",
              "completed", "offered")},
          "sim_over_measured": ratios, "replays_identical": True,
          "events": len(replays[0].event_log),
          "max_abs_err": checks["max_abs_err"], "checks": checks,
          "launches": launches, "launch_minima": minima,
          "plain_calls": plain})
    return launches


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


def clone_tree(tree):
    from repro_torch.training import tree as T
    return T.unflatten(tree, [t.clone() for t in T.leaves(tree)])


def phase_parallel(torch, seed: int, smi: str) -> dict:
    """``parallel:flash_decode`` (see the module docstring) on the
    world-size-1 ``nccl`` group, which the caller destroys.  Returns the
    decode kernel's launches of the kernel path's steps."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import runtime_flags
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import join_process_group, make_host_mesh
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.attention import masked_decode, slot_valid
    from repro_torch.models.transformer import param_shapes
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.collectives import flash_decode

    dev = torch.device("cuda", 0)
    join_process_group()
    mesh = make_host_mesh(1, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)
    cache_spec = shd.P("data", "model", None, None)
    rep_spec = shd.P("data", None, None, None)
    place = lambda t, spec: shd.place([t], [spec], mesh)[0]
    cases = []
    for (b, L, h, kv, hd), window, pos in (
            (MAIN_DECODE, 0, MAIN_DECODE_VALID - 1),
            (HYMBA_DECODE, HYMBA_DECODE[1], FD_RING_POS)):
        q, kn, vn = (torch.randn((b, 1, n, hd), generator=gen, device=dev)
                     for n in (h, kv, kv))
        kc, vc = (torch.randn((b, L, kv, hd), generator=gen, device=dev)
                  for _ in range(2))
        slot = pos % L if window else pos
        kr, vr = kc.clone(), vc.clone()
        kr[:, slot], vr[:, slot] = kn[:, 0], vn[:, 0]
        valid = slot_valid(L, pos, window, dev)
        want = masked_decode(q, kr, vr, valid)
        kern = ops.decode_attention(q, kr, vr, valid)
        dk, dv = place(kc.clone(), cache_spec), place(vc.clone(), cache_spec)
        dq, dkn, dvn = (place(t, rep_spec) for t in (q, kn, vn))
        run = lambda: flash_decode(mesh, dq, dk, dv, dkn, dvn, pos,
                                   window=window)
        with implicit_replication():
            out = run().full_tensor()
            torch.cuda.synchronize()
            ms = time_ms(torch, run)
        err_plain = max_err(torch, out, want)[0]
        err_kernel = max_err(torch, out, kern)[0]
        cache_err = max(max_err(torch, dk.full_tensor(), kr)[0],
                        max_err(torch, dv.full_tensor(), vr)[0])
        case = {"shape": [b, L, h, kv, hd], "window": window, "pos": pos,
                "n_valid": int(valid.sum().item()),
                "max_abs_err_plain": err_plain,
                "max_abs_err_kernel": err_kernel, "cache_err": cache_err,
                "enqueued_ms": ms, "plain_enqueued_ms": time_ms(
                    torch, lambda: masked_decode(q, kr, vr, valid)),
                "kernel_enqueued_ms": time_ms(
                    torch, lambda: ops.decode_attention(q, kr, vr, valid))}
        cases.append(case)
        if err_plain > FD_TOL or err_kernel > FD_KERNEL_TOL or cache_err:
            fail(f"parallel:flash_decode: {case}")
        del q, kn, vn, kc, vc, kr, vr, dk, dv, dq, dkn, dvn

    # 16 decode steps of the full model: plain, the kernel path, and the
    # sequence-sharded cache through flash_decode
    cfg = get_config(FD_MODEL)
    params = init_params(cfg, seed, dev)
    b = MAIN_DECODE[0]
    prompt = torch.randint(0, cfg.vocab_size, (b, FD_PROMPT), generator=gen,
                           device=dev)
    toks = torch.randint(0, cfg.vocab_size, (b, FD_STEPS), generator=gen,
                         device=dev)
    with torch.no_grad():
        _, cache0 = prefill(params, cfg, prompt, FD_MAX_LEN)

    def steps(p, cache, tok_of, use_kernel=False, full=lambda t: t):
        logits, ev = [], [torch.cuda.Event(enable_timing=True)
                          for _ in range(FD_STEPS + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        for t in range(FD_STEPS):
            lg, cache = decode_step(p, cfg, cache, tok_of(t), FD_PROMPT + t,
                                    use_kernel=use_kernel)
            logits.append(full(lg)[:, :cfg.vocab_size])
            ev[t + 1].record()
        torch.cuda.synchronize()
        return torch.stack(logits), [ev[i].elapsed_time(ev[i + 1])
                                     for i in range(FD_STEPS)]

    with torch.no_grad():
        ref, plain_ms = steps(params, clone_tree(cache0),
                              lambda t: toks[:, t:t + 1])
        ops.reset_counts()
        kout, kernel_ms = steps(params, clone_tree(cache0),
                                lambda t: toks[:, t:t + 1], use_kernel=True)
        launches = ops.kernel_launches()
        runtime_flags.set_variant("cache_seqshard", mesh)
        try:
            dparams = shd.place(
                params, shd.param_specs(cfg, param_shapes(cfg), mesh), mesh)
            dcache = shd.place(cache0, shd.cache_specs(
                cfg, mesh, b, FD_MAX_LEN), mesh)
            host_toks = toks.cpu().numpy()
            ops.reset_counts()
            with implicit_replication():
                sout, sharded_ms = steps(
                    dparams, dcache,
                    lambda t: shard_batch({"t": host_toks[:, t:t + 1]},
                                          mesh)["t"],
                    full=lambda lg: lg.full_tensor())
            sharded_launches = ops.kernel_launches()
        finally:
            runtime_flags.set_variant("baseline")
    err, scale = max_err(torch, sout, ref)
    kerr = max_err(torch, kout, ref)[0]
    del params, dparams, cache0, dcache
    gc.collect()
    torch.cuda.empty_cache()
    if err > FD_STEP_TOL * scale or any(sharded_launches.values()) or \
            launches.get("decode_attention", 0) != \
            FD_STEPS * layer_counts(cfg)[0]:
        fail(f"parallel:flash_decode: sharded decode err {err} (scale "
             f"{scale}), sharded-run launches {sharded_launches}, kernel "
             f"path launches {launches}")
    med = lambda xs: float(sorted(xs)[len(xs) // 2])
    import torch.distributed as dist
    emit({"phase": "parallel:flash_decode", "ok": True, "card": smi,
          "mesh": {"data": 1, "model": 1}, "backend": dist.get_backend(),
          "cases": cases, "model": cfg.name, "layers": cfg.num_layers,
          "batch": b, "prompt": FD_PROMPT, "max_len": FD_MAX_LEN,
          "steps": FD_STEPS, "max_abs_err": err, "tol": FD_STEP_TOL * scale,
          "kernel_path_max_abs_err": kerr,
          "sharded_ms_per_step": med(sharded_ms),
          "kernel_ms_per_step": med(kernel_ms),
          "plain_ms_per_step": med(plain_ms),
          "sharded_launches": sharded_launches,
          "kernel_path_launches": launches})
    return launches


def phase_sharded_prefill(torch, seed: int, smi: str) -> None:
    """``parallel:prefill`` (see the module docstring) on the world-size-1
    group, which the caller destroys."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import init_params, prefill
    from repro_torch.models.transformer import param_shapes
    from repro_torch.parallel import sharding as shd

    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(1, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 37)
    rows = {}
    for name in SP_MODELS:
        cfg = get_config(name)
        params = init_params(cfg, seed, dev)
        prompt = torch.randint(0, cfg.vocab_size, (SP_BATCH, SP_PROMPT),
                               generator=gen, device=dev)

        def timed(fn):
            """fn's result and the ms of its second call (the first warms
            the libraries up)."""
            fn()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            out = fn()
            ev[1].record()
            torch.cuda.synchronize()
            return out, ev[0].elapsed_time(ev[1])

        with torch.no_grad():
            (ref, ref_cache), plain_ms = timed(
                lambda: prefill(params, cfg, prompt, SP_PROMPT))
            dparams = shd.place(
                params, shd.param_specs(cfg, param_shapes(cfg), mesh), mesh)
            tokens = shard_batch({"t": prompt.cpu().numpy()}, mesh)["t"]
            step = build_prefill_step(cfg, SP_PROMPT, mesh)
            ops.reset_counts()
            with implicit_replication():
                (logits, cache), sharded_ms = timed(
                    lambda: step(dparams, tokens))
                launches = ops.kernel_launches()
                logits = logits.full_tensor()
                h = [e["h"].full_tensor() for e in cache["layers"]]
        err, scale = max_err(torch, logits, ref)
        h_err, h_scale = max(max_err(torch, g, e["h"])
                             for g, e in zip(h, ref_cache["layers"]))
        row = {"layers": cfg.num_layers, "batch": SP_BATCH,
               "prompt": SP_PROMPT, "in_proj_placements": [
                   str(q) for q in dparams["layers"][0]["in_proj"].placements],
               "logits_max_abs_err": err, "logits_tol": SP_TOL * scale,
               "h_max_abs_err": h_err, "h_tol": SP_TOL * h_scale,
               "sharded_ms": sharded_ms, "plain_ms": plain_ms,
               "sharded_launches": launches}
        rows[name] = row
        del params, dparams, ref, ref_cache, logits, cache, h
        gc.collect()
        torch.cuda.empty_cache()
        if err > SP_TOL * scale or h_err > SP_TOL * h_scale or \
                any(launches.values()):
            fail(f"parallel:prefill: {name}: {row}")
    emit({"phase": "parallel:prefill", "ok": True, "card": smi,
          "mesh": {"data": 1, "model": 1}, "models": rows})


def phase_pod(torch, seed: int, smi: str, train_step_s: float) -> int:
    """``train:pod``: the training launcher's pod path in process on the
    world-size-1 group (see the module docstring).  Returns its peak
    device bytes."""
    import repro_torch.configs as C
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import train_pod
    from repro_torch.models import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step

    dev = torch.device("cuda", 0)
    cfg = get_config(TRAIN_MODEL)
    C.INPUT_SHAPES[POD_SHAPE] = dict(seq_len=POD_SEQ, global_batch=POD_BATCH,
                                     kind="train")
    try:
        # the plain train_step on the same params and batches
        params = init_params(cfg, seed, dev)
        state = opt.init(params)
        it = SyntheticLM(cfg.vocab_size, POD_SEQ, task="copy",
                         seed=seed).iterator(POD_BATCH, cfg)
        step = make_train_step(cfg, opt.AdamWConfig(total_steps=POD_STEPS),
                               remat=True)
        plain = []
        for _ in range(POD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, next(it))
            plain.append({"loss": float(m["loss"]),
                          "s": time.perf_counter() - t0})
        del params, state, step, m
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        history = train_pod(TRAIN_MODEL, POD_SHAPE, steps=POD_STEPS,
                            seed=seed, log=lambda m: None)
        peak = torch.cuda.max_memory_allocated(dev)
        peak_gb = peak / 1e9
    finally:
        del C.INPUT_SHAPES[POD_SHAPE]
        gc.collect()
        torch.cuda.empty_cache()
    losses = [h["loss"] for h in history]
    plain_losses = [h["loss"] for h in plain]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    if len(losses) != POD_STEPS or max(rel) > POD_LOSS_RTOL or \
            not all(math.isfinite(x) for x in losses):
        fail(f"train:pod: losses {losses} vs the plain steps' "
             f"{plain_losses} (relative {rel})")
    median = lambda hist: float(sorted(h["s"] for h in hist[1:])[
        (len(hist) - 1) // 2])
    import torch.distributed as dist
    emit({"phase": "train:pod", "ok": True, "card": smi,
          "model": cfg.name, "layers": cfg.num_layers,
          "mesh": {"data": 1, "model": 1}, "backend": dist.get_backend(),
          "seq": POD_SEQ, "global_batch": POD_BATCH, "data": "copy",
          "remat": True, "use_kernel": False, "loss": losses,
          "plain_loss": plain_losses, "loss_rel_err": rel,
          "loss_rtol": POD_LOSS_RTOL, "step_s": [h["s"] for h in history],
          "step_s_after_first": median(history),
          "plain_step_s": [h["s"] for h in plain],
          "plain_step_s_after_first": median(plain),
          "peak_device_gb": peak_gb,
          "train_qwen3_step_s_median": train_step_s,
          "train_qwen3_tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
          "tokens_per_step": POD_BATCH * POD_SEQ})
    return peak


def phase_dryrun_pod(torch, smi: str, measured: int) -> None:
    """``dryrun:pod``: ``train:pod``'s step traced as the dry-run traces
    it (``FakeTensorMode``, nothing allocated) at the pod path's own dtype,
    shape, remat and mesh; its predicted peak, argument + temp bytes, held
    to the ``measured`` peak."""
    import repro_torch.configs as C
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import lower_step
    from repro_torch.launch.train import pod_mesh

    cfg = get_config(TRAIN_MODEL)
    C.INPUT_SHAPES[POD_SHAPE] = dict(seq_len=POD_SEQ, global_batch=POD_BATCH,
                                     kind="train")
    try:
        t0 = time.perf_counter()
        traced = lower_step(cfg, POD_SHAPE, pod_mesh(False),
                            param_dtype=torch.float32, remat=True)
        trace_s = time.perf_counter() - t0
        mem = traced.memory_analysis()
        del traced
    finally:
        del C.INPUT_SHAPES[POD_SHAPE]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    ratio = predicted / measured
    if abs(ratio - 1) > POD_PEAK_RTOL:
        fail(f"dryrun:pod: predicted peak {predicted / 1e9:.3f} GB, "
             f"measured {measured / 1e9:.3f} GB (ratio {ratio:.4f}, "
             f"allowed 1 +- {POD_PEAK_RTOL}): {mem}")
    emit({"phase": "dryrun:pod", "ok": True, "card": smi,
          "model": cfg.name, "mesh": {"data": 1, "model": 1},
          "seq": POD_SEQ, "global_batch": POD_BATCH, "dtype": "float32",
          "remat": True, "trace_s": trace_s, "memory_analysis": mem,
          "predicted_peak_gb": predicted / 1e9,
          "measured_peak_gb": measured / 1e9, "ratio": ratio,
          "rtol": POD_PEAK_RTOL,
          "note": "predicted: the eager step's peak of live storage "
                  "bytes (argument + temp), every step alike (the AdamW "
                  "state is an argument); measured: "
                  "torch.cuda.max_memory_allocated over train:pod's 3 steps"})


def start_dryrun(out_dir: str):
    """``dryrun:qwen3``'s subprocesses (CPU only), started early so that
    they run beside the card's phases: qwen3's three shapes, and the SSM
    members' ``prefill_32k``, one process each."""
    import os
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--out", out_dir] + shape
            for arch, shape in [(DRYRUN_ARCH, [])] + [
                (a, ["--shape", "prefill_32k"]) for a in DRYRUN_SSM]]
    return cmds, time.perf_counter(), [subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(SRC),
                        "OMP_NUM_THREADS": "1"}) for cmd in cmds]


def phase_dryrun(started, out_dir: str, smi: str) -> None:
    """``dryrun:qwen3``: the dry-run's three records and roofline rows, and
    the SSM members' ``prefill_32k`` records held to their bounds."""
    from repro_torch.launch import roofline
    cmds, t0, procs = started
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT_S
                            - (time.perf_counter() - t0))))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            fail(f"dryrun:qwen3: {' '.join(cmd[2:])}: rc {proc.returncode}:"
                 f" {out[-1500:]} {err[-1500:]}")
    recs, ssm = {}, {}
    for f in sorted(Path(out_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec["arch"] == DRYRUN_ARCH:
            recs[rec["shape"]] = rec
        else:
            ssm[rec["arch"]] = rec
    ssm_rows = {}
    for arch, (jax_temp, over) in DRYRUN_SSM.items():
        rec = ssm.get(arch)
        if rec is None or rec["shape"] != "prefill_32k":
            fail(f"dryrun:qwen3: no {arch} prefill_32k record: {sorted(ssm)}")
        mem = rec["memory_analysis"]
        ssm_rows[arch] = {
            "shape": rec["shape"], "memory_analysis": mem,
            "flops_per_rank": rec["flops_per_rank"],
            "temp_gb": mem["temp_size_in_bytes"] / 1e9,
            "jax_temp_gb_xla_cpu_buffer_assignment": jax_temp / 1e9,
            "temp_bound_gb": over * jax_temp / 1e9,
            "collective_counts": rec["collectives"]["counts"]}
        if mem["temp_size_in_bytes"] > over * jax_temp:
            fail(f"dryrun:qwen3: {arch} prefill_32k temp over {over}x the "
                 f"JAX record's: {ssm_rows[arch]}")
    rows = {r.shape: r for r in roofline.load_rows("single",
                                                   directory=out_dir)}
    shapes = ("train_4k", "prefill_32k", "decode_32k")
    if not set(shapes) <= set(rows) or \
            not all(recs[s]["flops_per_rank"] > 0 for s in shapes):
        fail(f"dryrun:qwen3: records {sorted(recs)}, rows {sorted(rows)}")
    peak = {s: recs[s]["memory_analysis"]["argument_size_in_bytes"]
            + recs[s]["memory_analysis"]["temp_size_in_bytes"]
            for s in shapes}
    if max(peak.values()) >= DRYRUN_RANK_BYTES:
        fail(f"dryrun:qwen3: a rank's argument + temp reaches the card's "
             f"{DRYRUN_RANK_BYTES / 1e9:.0f} GB: {peak}")
    emit({"phase": "dryrun:qwen3", "ok": True, "card": smi,
          "commands": [" ".join(["python", "-m"] + c[2:]) for c in cmds],
          "seconds": seconds, "mesh": recs["train_4k"]["mesh_shape"],
          "counts": "PyTorch's (per-rank ops of the traced step), not XLA's",
          "rank_bytes_limit_gb": DRYRUN_RANK_BYTES / 1e9,
          "jax_temp_note": "the JAX dry-run's temp on a CPU host: XLA's "
                           "buffer assignment for the CPU, not the card's",
          "rows": {s: {
              "trace_s": recs[s]["trace_s"],
              "flops": rows[s].hlo_flops,
              "flops_per_rank": recs[s]["flops_per_rank"],
              "bytes_accessed_per_rank": recs[s]["bytes_accessed_per_rank"],
              "memory_analysis": recs[s]["memory_analysis"],
              "argument_plus_temp_gb": peak[s] / 1e9,
              "temp_gb": recs[s]["memory_analysis"]["temp_size_in_bytes"]
              / 1e9,
              "jax_temp_gb_xla_cpu_buffer_assignment":
                  JAX_CPU_TEMP[s] / 1e9,
              "collective_bytes_per_rank": recs[s]["collectives"]["bytes"],
              "collective_counts": recs[s]["collectives"]["counts"],
              "compute_s": rows[s].compute_s, "memory_s": rows[s].memory_s,
              "collective_s": rows[s].collective_s,
              "dominant": rows[s].dominant,
              "model_flops": rows[s].model_flops,
              "model_over_traced": rows[s].useful_ratio}
              for s in shapes},
          "ssm_prefill_32k": ssm_rows})


def phase_quickstart(smi: str) -> None:
    """``example:quickstart``: ``examples/torch_quickstart.py`` on the
    card as a user runs it."""
    import os
    cmd = [sys.executable, "examples/torch_quickstart.py"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=QUICKSTART_TIMEOUT_S,
                              env={**os.environ, "PYTHONPATH": str(SRC)})
    except subprocess.TimeoutExpired as e:
        fail(f"example:quickstart: no end in {QUICKSTART_TIMEOUT_S} s: "
             f"{(e.stdout or '')[-1500:]}")
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not any("cuda0" in ln for ln in lines):
        fail(f"example:quickstart: rc {proc.returncode}: {lines[-20:]} "
             f"{proc.stderr[-2000:]}")
    emit({"phase": "example:quickstart", "ok": True, "card": smi,
          "command": "python examples/torch_quickstart.py",
          "rc": proc.returncode, "seconds": seconds,
          "output": [ln for ln in lines if ln.strip()][:40]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="serve each pair's requests a second time, run "
                         "a few more decode steps of each generation phase "
                         "and one more training step, under torch.profiler, "
                         "and print device time by kernel")
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
               phase_decode(torch, gen, dev), phase_gemm(torch, gen, dev),
               phase_grouped(torch, gen, dev)]

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

    # the dry-run traces on the host beside the training phases
    import tempfile
    dry_dir = tempfile.mkdtemp(prefix="dryrun_torch_")
    dryrun = start_dryrun(dry_dir)

    # 7-8. training at full width, its checkpoint served; a train step
    # held to float64
    got, train_step_s = phase_train(torch, args.seed, smi, args.profile)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    phase_train_step(torch, args.seed, smi)

    # 13-15. flash_decode and the pod training path on a world-size-1 nccl
    # group (destroyed before the control phases), its step's predicted
    # peak, then the dry-run's records
    import torch.distributed as dist
    try:
        for k, v in phase_parallel(torch, args.seed, smi).items():
            launches[k] = launches.get(k, 0) + v
        phase_sharded_prefill(torch, args.seed, smi)
        pod_peak = phase_pod(torch, args.seed, smi, train_step_s)
        phase_dryrun_pod(torch, smi, pod_peak)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    phase_dryrun(dryrun, dry_dir, smi)

    # 9-12. the front door and the control plane, the simulator, then the
    # serve launcher
    for k, v in phase_control(torch, args.seed, smi).items():
        launches[k] = launches.get(k, 0) + v
    phase_launch(smi)
    # 16. the quickstart example as a user runs it
    phase_quickstart(smi)
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
