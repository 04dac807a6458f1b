"""A worker: one model instance pinned to one device at one batch size.

Faithful to paper Fig. 2 — three asynchronous threads per worker:
  * the *batcher* coalesces incoming segment rows into padded batches,
  * the *predictor* owns the params on its device and runs the forward,
  * the *prediction sender* scatters batch outputs back to their segments
    and forwards them (device partial or {s, m, P} message).

Hardware adaptation (DESIGN.md §2): the paper uses one OS process per worker
(TF1 sessions hold the GIL); here the forward runs eagerly and, on the card,
only enqueues kernels on the device's current stream (the compute stream,
shared by every worker on the card) and returns, so threads + per-worker
queues give the same overlap without IPC serialization overhead.  The JAX
package's mechanisms map so: ``jax.jit`` with pow2 buckets -> an eager call
at the same ``bucket_for`` shapes; ``device_put`` -> ring slots in pinned
host memory copied with ``.to(device, non_blocking=True)``, the staged
uploads on the worker's own copy stream; ``block_until_ready`` -> a CUDA
event recorded after the predict call and synchronised in the sender.

Coalescing scheduler (DESIGN.md §3): the paper's batching process forms
batches strictly within one (request, segment) pair, so heavy traffic of
many small requests runs nothing but padded remainder buckets.  Here the
batcher drains its input queue and packs rows from *multiple* in-flight
requests/segments into full compiled batches:

  * the unit moved through the pipeline is a **ring slot** spanning
    ``ceil(segment/batch)`` compiled batches, plus a **scatter descriptor**
    — a list of :class:`~repro_torch.serving.segments.Span` entries mapping slot
    row-ranges back to (request, segment, segment-row) coordinates.  Spans
    never cross a compiled-batch boundary, so each span belongs to exactly
    one predictor chunk;
  * a full slot flushes immediately; a partial slot lingers at most
    ``max_wait_us`` for more rows (bounded latency), and ``SHUTDOWN`` /
    ``FLUSH`` (quiesce) force an immediate flush;
  * a flushed slot is cut into full compiled batches plus a short remainder
    padded to the next **power-of-two bucket** (not the full compiled batch)
    — one callable serves every bucket, and the bucket set is bounded to
    ~log2(batch) shapes;
  * ``coalesce=False`` restores the PR-1 one-item-at-a-time batching (each
    (request, segment) flushes its own slot) as a measurement baseline;
  * slots come from a **preallocated ring** (free-list backpressure bounds
    in-flight memory).  Mismatched-seq requests (request width != compiled
    ring width) draw buffers from a small per-width side pool instead of
    allocating per slot.

Chunk-granular dispatch (DESIGN.md §3, ROADMAP items e/k): a flushed slot
is no longer slot-indivisible through the predictor.  The batcher cuts it
into its compiled chunks *at flush time* and each chunk enters a per-worker
priority :class:`~repro_torch.serving.admission.DispatchQueue` as an independent
:class:`~repro_torch.serving.segments.ChunkDesc`:

  * a high-priority chunk (any span from a ``priority="high"`` request)
    jumps every queued bulk chunk — the non-preemptible head shrinks from
    up to ``RING_SLOTS`` flushed slots to the single chunk already
    dispatched plus the dispatch-ahead window;
  * high-priority packing is **express**: it never blocks on the ring free
    list (a pooled side buffer serves when all slots are in flight with
    bulk), and a bulk descriptor's own wait for a free slot is
    *interruptible* — high-priority descriptors landing mid-wait are
    admitted first;
  * the predictor keeps up to ``dispatch_ahead`` (K) async dispatches
    outstanding — the device never starves while the queue reorders, and K
    bounds the committed (non-preemptible) work ahead of a late-arriving
    high-priority chunk;
  * a chunk whose every span belongs to a cancelled/expired request is
    dropped at dequeue time (never dispatched): the predictor posts the
    ``DROPPED`` resolution and the rows land on the ``rows_dropped``
    counter instead of occupying device time;
  * slot recycling moves to a per-slot outstanding-chunk **refcount**
    (:class:`~repro_torch.serving.segments.SlotRef`): the ring buffer recycles
    only after every chunk's output is materialized — on CPU the upload
    may alias host memory, so one chunk retiring early must not free rows
    another chunk still reads;
  * the sender forwards a (request, segment) contribution **as soon as its
    last span's chunk returns** (early per-segment forwarding) rather than
    when the whole slot retires; spans may now materialize out of order
    within a segment (a mixed chunk rides the high-priority class while its
    bulk siblings queue), so reassembly is row-count-based with parts keyed
    by segment offset.  Still ONE contribution per (request, segment) —
    per-span forwarding would multiply combiner/accumulator traffic by
    chunks-per-segment;
  * per-stage wall-clock counters (metrics.StageTimers) instrument the
    batcher wait, the wait for a free ring slot (``slot_wait``), batch
    fill, per-class dispatch-queue wait (``dispatch_wait.high`` /
    ``dispatch_wait.normal``), predict dispatch, and device sync/transfer;
    padding counters (``rows_valid`` / ``rows_dispatched``) and the
    ``queue_depth`` gauge expose coalescing efficiency.  While tracing is
    on, each descriptor's wait before the batcher pops it is recorded too
    (``input_wait``), and on the card each chunk's forward is timed on the
    device (``forward_device.m<member>.b<bucket>``,
    ``device_queue.m<member>`` and a ``forward`` span on the
    ``<worker>/device`` track; see ``_record_forward``).

Request-API admission (DESIGN.md §7): the input queue is a two-level
:class:`~repro_torch.serving.admission.AdmissionQueue` — high-priority descriptors
drain before normal ones, and packing a high-priority request's rows
*preempts the linger* (the open slot's deadline collapses to "flush as soon
as the queue runs dry") so a latency-sensitive request never waits out
``max_wait_us`` behind its own batch.  A descriptor whose request is past
its deadline or cancelled is dropped instead of packed: the batcher posts
``Message(DROPPED, ...)`` and the accumulator fails the request, so expired
work never occupies ring slots or device time.  With ``linger="adaptive"``
the linger budget scales down with the queue backlog (deep queue → flush
immediately, idle queue → full ``max_wait_us``; ROADMAP item b).
"""
from __future__ import annotations

import gc
import queue
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.devices import DeviceSpec
from repro_torch.kernels import quant as kquant
from repro_torch.kernels.ops import pow2_clamp
from repro_torch.serving import segments as seg
from repro_torch.serving.admission import DispatchQueue, chunk_level
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.metrics import StageTimers
from repro_torch.serving.tracing import pack_times
from repro_torch.serving.segments import (FLUSH, ChunkDesc, FlushBarrier, Message,
                                    Request, SHUTDOWN, SlotRef, Span)

MIN_BUCKET = 8
RING_SLOTS = 4          # in-flight slot bound per worker
ALT_POOL_CAP = 4        # pooled mismatched-seq buffers per width
ADAPTIVE_DEPTH = 8      # linger="adaptive": backlog at which linger hits 0
DISPATCH_AHEAD = 16     # default outstanding async dispatches (K):
                        # throughput-friendly — K bounds the committed
                        # (non-preemptible) window, so latency-sensitive
                        # mixed-traffic deployments set it small (1-2)

STAGE_BYTES = 64 << 20  # each of the two pinned buffers a parameter tree is
                        # uploaded through (upload_tree)

# worker health states (exported via serving_gauges / GET /metrics)
HEALTH_READY = 0        # all stage threads alive and making progress
HEALTH_DEGRADED = 1     # a stage has been mid-work past the watchdog
HEALTH_DEAD = 2         # a stage thread died (crashed event / not alive)
# heartbeat states: a stage blocked on an empty queue is WAITing (healthy
# at any age — idleness is not a stall); only an ACTIVE stamp going stale
# means the stage is stuck mid-work
_HB_WAIT = 0
_HB_ACTIVE = 1


def bucket_for(n: int, batch_size: int) -> int:
    """Compiled batch shape for an ``n``-row chunk: the full batch size, or
    the next power of two >= n (min 8) for remainder chunks."""
    if n >= batch_size:
        return batch_size
    return pow2_clamp(n, MIN_BUCKET, batch_size)


def make_predict_fn(cfg: ModelConfig, use_kernel: bool = False,
                    member_dtype: str = "fp32",
                    quant_out: bool = False) -> Callable:
    """Classification-style serving fn: tokens (b,S) -> last-token class
    scores (b, C) with C = the unpadded vocab (the paper's f(x)->y).  Runs
    eagerly: on the card a call enqueues its kernels and returns before they
    finish.

    The final norm and the head run on the last position only.  The norm
    works per position, so this is the same function as slicing the full
    logits at ``[:, -1]``, and a full-width head never materializes the
    (b, S, Vpad) f32 logits.

    ``member_dtype`` != "fp32" expects params wrapped by
    :func:`repro_torch.kernels.quant.quantize_params`; the forward
    dequantizes each matrix just before its use (weight-only quantization:
    storage and H2D are narrow, math is fp32).  ``quant_out`` additionally
    quantizes the output logits per row (symmetric **int8** over classes,
    also for fp8 members) and returns ``(q (b, C) int8, scale (b, 1) f32)``
    for the fused dequant-weight-accumulate combine epilogue.  ``frontend``
    (b, F, fdim) feeds a cross-attention member (None for the others)."""
    from repro_torch.models.transformer import hidden, logits_from_hidden

    def predict(params, tokens, frontend=None):
        with torch.no_grad():
            x = hidden(params, cfg, tokens, frontend, use_kernel=use_kernel)
            out = logits_from_hidden(params, cfg, x[:, -1])
            out = out[:, :cfg.vocab_size].contiguous()
            if quant_out:
                return kquant.quantize_symmetric(out, axis=-1)
            return out

    if cfg.moe is None or cfg.moe.impl != "dropless":
        return predict
    # a dropless MoE counts its calls and rows on the device
    # (``predict.moe_tally``, read through the worker's timers)
    from repro_torch.models.moe import MoETally
    tally = MoETally()

    def predict_tallied(params, tokens, frontend=None):
        with tally.active(tokens.device):
            return predict(params, tokens, frontend)

    predict_tallied.moe_tally = tally
    return predict_tallied


def _span_rids(spans):
    """rid annotation for a chunk-level trace event: the bare rid, or a
    tuple when the chunk coalesced rows from several requests."""
    if len(spans) == 1:
        return spans[0].req.rid
    return tuple({sp.req.rid for sp in spans})


class _OpenBatch:
    """The batcher's in-progress coalesced batch."""
    __slots__ = ("slot", "buf", "width", "fill", "spans", "deadline")

    def __init__(self, slot, buf, width: int, deadline: float):
        self.slot = slot             # ring index, or None (side-pool buffer)
        self.buf = buf
        self.width = width
        self.fill = 0
        self.spans: List[Span] = []
        self.deadline = deadline     # linger expiry (perf_counter seconds)


def upload_tree(params, device: torch.device, stream: "torch.cuda.Stream"):
    """A host parameter tree's copy on ``device``: uploaded on ``stream``
    through two pinned ``STAGE_BYTES`` buffers in turns, and landed when
    this returns.  Pageable copies on the card's default stream, where
    every worker's forward runs, would hold the forward then in flight for
    the whole upload (seconds for a full-width qwen3-1.7b), long enough for
    the supervisor to read a sibling as stalled.  Each destination is
    allocated on the caller's stream, which uses it next; its copy waits
    for the work that stream had queued, which may still read the block's
    earlier tenant."""
    compute = torch.cuda.current_stream(device)
    bufs = [torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    done = [None, None]
    turn = 0

    def put(t):
        nonlocal turn
        if t.device.type != "cpu":
            return t.to(device)
        dst = torch.empty(t.shape, dtype=t.dtype, device=device)
        stream.wait_stream(compute)
        src = t.detach().contiguous().reshape(-1).view(torch.uint8)
        out = dst.view(-1).view(torch.uint8)
        for lo in range(0, src.numel(), STAGE_BYTES):
            n = min(STAGE_BYTES, src.numel() - lo)
            if done[turn] is not None:
                done[turn].synchronize()      # its last copy has read it
            bufs[turn][:n].copy_(src[lo:lo + n])
            with torch.cuda.stream(stream):
                out[lo:lo + n].copy_(bufs[turn][:n], non_blocking=True)
                done[turn] = torch.cuda.Event()
                done[turn].record(stream)
            turn ^= 1
        return dst

    try:
        return kquant.tree_map(put, params)
    finally:
        # also after a failed allocation: no copy may go on writing into a
        # block the allocator hands out again
        stream.synchronize()


class Worker:
    def __init__(self, worker_id: str, cfg: ModelConfig, params,
                 device: DeviceSpec, batch_size: int,
                 input_queue: "queue.Queue",
                 prediction_queue: "queue.Queue[Message]",
                 model_idx: int, max_seq: int, segment_size: int,
                 *, fake: bool = False, frontend: Optional[np.ndarray] = None,
                 use_kernel: bool = False, combiner=None,
                 timers: Optional[StageTimers] = None,
                 coalesce: bool = True, max_wait_us: int = 500,
                 linger: str = "fixed", generation: int = 0,
                 profiler=None, oom_sentinel: bool = True,
                 fake_delay_us: int = 0,
                 dispatch_ahead: int = DISPATCH_AHEAD,
                 fault_plan: Optional[FaultPlan] = None,
                 nan_guard: bool = False, tracer=None,
                 member_dtype: str = "fp32",
                 dispatch_queue: Optional[type] = None):
        self.worker_id = worker_id
        self.cfg = cfg
        self.batch_size = batch_size
        self.member_dtype = kquant.validate_member_dtype(member_dtype)
        self.model_idx = model_idx
        self.generation = generation     # reconfig epoch that spawned us (§8)
        self.profiler = profiler         # optional LiveBench sink
        self.device_idx: Optional[int] = None   # set by InferenceSystem
        self.input_queue = input_queue
        self.prediction_queue = prediction_queue
        self.segment_size = segment_size
        self.fake = fake
        # simulated per-compiled-batch device time for fake workers: lets
        # scheduler benchmarks/tests model heterogeneous service rates
        # deterministically (the sleep releases the GIL, so cross-worker
        # parallelism is real even on a small host)
        self.fake_delay_us = fake_delay_us
        self.device = device
        self.combiner = combiner
        self.timers = timers or StageTimers()
        self.coalesce = coalesce
        self.linger_s = max(0, max_wait_us) * 1e-6
        if linger not in ("fixed", "adaptive"):
            raise ValueError(f"linger must be 'fixed' or 'adaptive', "
                             f"got {linger!r}")
        self.linger_mode = linger
        self._depth_gauge = f"queue_depth.{worker_id}"
        self.num_classes = cfg.vocab_size
        # chunk-granular dispatch: priority queue batcher -> predictor, plus
        # the dispatch-ahead window (K outstanding async dispatches —
        # the semaphore is acquired before a chunk is *committed*, so the
        # queue may reorder right up to the moment of dispatch)
        self.dispatch_ahead = max(1, dispatch_ahead)
        # pluggable dispatch policy (ROADMAP item m): FIFO-within-priority
        # by default; ``EDFDispatchQueue`` orders by request deadline
        self._dispatch_q = (dispatch_queue or DispatchQueue)()
        # span tracing (DESIGN.md §13): emitters check tracer.enabled first
        # and reuse timestamps the pipeline already takes, so the disabled
        # cost is one attribute check per site
        self.tracer = tracer
        self._tr_batcher = f"{worker_id}/batcher"
        self._tr_predict = f"{worker_id}/predict"
        self._tr_sender = f"{worker_id}/sender"
        self._tr_device = f"{worker_id}/device"
        # batcher ring cached once: rings are cleared in place, never
        # replaced, and _flush is too hot for a per-flush locked lookup
        self._tr_batcher_ring = tracer.ring(self._tr_batcher) \
            if tracer is not None else None
        self._dispatch_sem = threading.BoundedSemaphore(self.dispatch_ahead)
        # SimpleQueue (C implementation): per-chunk hand-offs are hot, and
        # depth is already bounded by the dispatch-ahead window (the sem is
        # only released once the sender materializes a chunk)
        self._send_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads: List[threading.Thread] = []
        # a simulated cell (no torch_device) can only back a fake worker: a
        # real member on it would be served wherever its tensors landed, so
        # the CPU must be asked for explicitly (host_cpus())
        if device.torch_device is None and not fake:
            raise ValueError(f"worker {worker_id}: cell {device.name!r} has no "
                             "torch_device; use cuda_devices() or host_cpus()")
        self._device = device.torch_device if device.torch_device is not None \
            else torch.device("cpu")
        self._cuda = self._device.type == "cuda"

        # ---- fault tolerance (DESIGN.md §10) ----
        self._fault = fault_plan         # None on the default hot path
        self.nan_guard = nan_guard
        self._oom_sentinel = oom_sentinel
        self.crashed = threading.Event()   # any stage thread died
        self.crash_cause: Optional[BaseException] = None
        # supervised containment hook: when set, _guarded reports the crash
        # here instead of posting the paper's global {-1, None, None}
        self.on_crash: Optional[Callable[["Worker", BaseException], None]] = None
        # in-flight ledger: (rid, s) -> Request for every descriptor admitted
        # by the batcher but not yet forwarded by the sender.  The sender
        # pops an entry IMMEDIATELY BEFORE posting its completed
        # contribution and skips the post when the pop misses — dict ops
        # are GIL-atomic, so the pop is a perfect mutual-exclusion gate
        # between the sender and a supervisor replaying this worker's
        # in-flight units (replay idempotency; a late wakeup of a stalled
        # quarantined stage can therefore never double-post).
        self._ledger: Dict[tuple, Request] = {}
        # per-stage heartbeats: stage -> [state, perf_counter stamp].  List
        # mutation is GIL-atomic; no lock on the hot path.
        now = time.perf_counter()
        self._hb: Dict[str, list] = {s: [_HB_WAIT, now]
                                     for s in ("batcher", "predictor",
                                               "sender")}

        # preallocated input ring: each slot spans ceil(segment/batch)
        # compiled batches, so one queue hand-off moves a whole segment's
        # worth of coalesced rows through the pipeline (per-batch hand-offs
        # would multiply queue traffic by chunks-per-segment).  The free-list
        # bounds in-flight slots (backpressure).  Mismatched-seq requests
        # draw from a pooled per-width side list instead.
        chunks_per_seg = max(1, -(-segment_size // batch_size))
        self._span = chunks_per_seg * batch_size
        # on the card the slots are pinned, so their uploads are async
        # copies; the batcher writes them through numpy views
        self._ring_t = [torch.zeros((self._span, max_seq), dtype=torch.int32,
                                    pin_memory=self._cuda)
                        for _ in range(RING_SLOTS)]
        self._ring = [t.numpy() for t in self._ring_t]
        # the predictor's staged uploads run here, beside the compute
        # stream, so chunk i+1's copy overlaps chunk i's forward
        self._copy = torch.cuda.Stream(self._device) if self._cuda else None
        self._free_slots: "queue.Queue[int]" = queue.Queue()
        for i in range(len(self._ring)):
            self._free_slots.put(i)
        self._alt_pool: Dict[int, List[np.ndarray]] = {}
        self._alt_lock = threading.Lock()
        # seconds the batcher has waited for free ring slots, so that
        # ``batch_fill`` leaves the waits out (batcher thread only)
        self._slot_waited = 0.0
        # (timing event, perf_counter) taken together after the warm-up:
        # maps a traced forward's device events onto the host clock
        self._anchor = None

        try:
            if self._fault is not None:
                self._fault.tick(worker_id, "spawn")
            if self.member_dtype != "fp32" and not fake:
                # quantize BEFORE the move where the params are on the host:
                # the narrow tree (int8/fp8 weights + per-channel scales) is
                # what the device holds (~dtype_bytes/4 the fp32 footprint);
                # the forward dequantizes one matrix at a time
                params = kquant.quantize_params(params, self.member_dtype)
            if self._cuda:
                self.params = upload_tree(params, self._device, self._copy)
            else:
                self.params = kquant.tree_map(
                    lambda t: t.to(self._device), params)
            # a cross-attention member's frontend embeddings, on the device;
            # each batch reads its first rows (zeros unless given)
            self.frontend = None
            if cfg.frontend_tokens:
                fe = frontend if frontend is not None else np.zeros(
                    (batch_size, cfg.frontend_tokens, cfg.fdim), np.float32)
                self.frontend = torch.as_tensor(fe).to(self._device)
            # quantized members feeding a device combiner emit (q, scale)
            # logits for the fused dequant-weight-accumulate epilogue
            self._quant_out = (kquant.is_quantized_dtype(self.member_dtype)
                               and combiner is not None)
            self.predict_fn = make_predict_fn(
                cfg, use_kernel, member_dtype=self.member_dtype,
                quant_out=self._quant_out)
            tally = getattr(self.predict_fn, "moe_tally", None)
            if tally is not None:
                self.timers.add_device_counters(
                    lambda m=model_idx, t=tally: {
                        f"{k}.m{m}": v for k, v in t.read().items()})
            if not fake:   # warm-up (and kernel build) so READY means servable
                if self._copy is not None:
                    # the copy stream's first block: allocated here, its
                    # segment is cached before the first staged upload
                    with torch.cuda.stream(self._copy):
                        torch.empty(batch_size * max_seq, dtype=torch.int32,
                                    device=self._device)
                warm = torch.zeros((batch_size, max_seq), dtype=torch.int32,
                                   device=self._device)
                self.predict_fn(self.params, warm, self.frontend)
                if self._cuda:
                    torch.cuda.synchronize(self._device)
                    a = torch.cuda.Event(enable_timing=True)
                    a.record(torch.cuda.current_stream(self._device))
                    a.synchronize()
                    self._anchor = (a, time.perf_counter())
            self.prediction_queue.put(Message(seg.READY, model_idx, None))
        except (MemoryError, RuntimeError, ValueError) as e:
            # paper §II.C.2: {-1, None, None} triggers system shutdown.  A
            # controller-initiated speculative spawn passes oom_sentinel=False
            # so a failed probe rejects ONE reconfig action instead of
            # failing every in-flight request (DESIGN.md §8).
            if oom_sentinel:
                self.prediction_queue.put(Message(seg.OOM, None, None))
            # the error's traceback holds the failed forward's frames and
            # this one: clear the finished ones (their activations) and drop
            # the partly moved tree, or a controller's retry would find card
            # memory that nothing owns
            traceback.clear_frames(e.__traceback__)
            params = warm = None
            self.release_device()
            raise

    def release_device(self) -> None:
        """Drop this worker's device tensors (parameters, frontend, pinned
        ring slots) and return the card's cached blocks.  Only for a worker
        whose threads have exited or never started."""
        self.params = self.frontend = self._copy = None
        self._ring_t, self._ring = [], []
        if self._cuda:
            gc.collect()
            torch.cuda.empty_cache()

    # ---- threads -------------------------------------------------------------
    def start(self):
        for fn, name in [(self._batcher, "batcher"), (self._predictor, "predictor"),
                         (self._sender, "sender")]:
            t = threading.Thread(target=self._guarded, args=(fn,),
                                 name=f"{self.worker_id}-{name}", daemon=True)
            t.start()
            self._threads.append(t)

    def _guarded(self, fn):
        """A stage thread dying mid-request would hang its request (and leak
        its in-flight window slot) forever.  Under supervision (``on_crash``
        set) the failure is *contained*: the supervisor quarantines this one
        instance and replays its in-flight work on siblings (DESIGN.md §10).
        Unsupervised, fall back to the paper's {-1, None, None} sentinel,
        which fails every in-flight request and shuts the system down
        (§II.C.2 all-or-nothing semantics, still the default)."""
        try:
            if self._cuda:
                # a new thread's current device is card 0: name this
                # worker's card before the stage enqueues anything
                torch.cuda.set_device(self._device)
            fn()
        except BaseException as e:
            self.crash_cause = e
            self.crashed.set()
            hook = self.on_crash
            if hook is not None:
                try:
                    hook(self, e)
                except Exception:
                    pass          # supervisor loop still sweeps on interval
                return            # contained: no stderr traceback spam
            if self._oom_sentinel:
                self.prediction_queue.put(Message(seg.OOM, None, None))
            raise

    def join(self, timeout: float = 30.0) -> List[str]:
        """Join all stage threads against ONE shared deadline (the seed gave
        each thread the full budget — a 3-stage hang took 3x the timeout)
        and report which stages failed to stop instead of silently
        returning; stuck daemons are leaked deliberately (a stalled device call
        cannot be interrupted), the caller just must know routing-wise the
        worker is gone but its threads may still wake up later."""
        deadline = time.perf_counter() + timeout
        stuck = []
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
            if t.is_alive():
                stuck.append(t.name)
        if stuck:
            self.timers.inc("join_timeouts", len(stuck))
        return stuck

    def health(self, watchdog_s: float = 5.0) -> int:
        """Liveness verdict for the supervisor: DEAD when a stage thread
        crashed or exited; DEGRADED when a stage has been ACTIVE (mid-work,
        not blocked on an empty queue) longer than ``watchdog_s``; READY
        otherwise.  WAIT-state stamps never age into DEGRADED — an idle
        worker is healthy, and so is a batcher blocked on the free ring
        slots, which waits on the stages after it.  The predictor and the
        sender restamp after every chunk, so ACTIVE ages over one chunk's
        work: a dispatch round of many chunks on a card that every cell
        shares can outlast the watchdog while each chunk progresses."""
        if self.crashed.is_set():
            return HEALTH_DEAD
        if self._threads and not all(t.is_alive() for t in self._threads):
            return HEALTH_DEAD
        now = time.perf_counter()
        for state, stamp in self._hb.values():
            if state == _HB_ACTIVE and now - stamp > watchdog_s:
                return HEALTH_DEGRADED
        return HEALTH_READY

    # ---- batch slots ---------------------------------------------------------
    def _effective_linger(self) -> float:
        """Linger budget for a freshly-opened slot.  ``adaptive`` scales the
        configured ``max_wait_us`` down linearly with the input backlog: a
        deep queue means more rows are already on the way (no need to wait
        for them — they arrive this drain) while an idle queue earns the
        full linger to give concurrent requests a chance to coalesce."""
        if self.linger_mode == "adaptive":
            depth = self.input_queue.qsize()
            return self.linger_s * max(0.0, 1.0 - depth / ADAPTIVE_DEPTH)
        return self.linger_s

    def _side_buffer(self, width: int) -> np.ndarray:
        with self._alt_lock:
            pool = self._alt_pool.setdefault(width, [])
            buf = pool.pop() if pool else None
        return buf if buf is not None else \
            np.zeros((self._span, width), np.int32)

    def _open_batch(self, width: int,
                    express: bool = False) -> Optional[_OpenBatch]:
        """Open a fresh slot.  ``express`` (high-priority packing) never
        blocks: it takes a free ring slot if one is instantly available and
        otherwise draws a pooled side buffer — a latency-sensitive request
        must not wait for ``RING_SLOTS`` bulk slots to materialize.  The
        bulk path blocks on the free list (backpressure), but the wait is
        *interruptible*: it returns None the moment high-priority work
        lands in the admission queue, so the batcher can service it first
        (the preemptible-pipeline lever, ROADMAP items e/k)."""
        slot = buf = None
        if width == self._ring[0].shape[1]:
            if express:
                try:
                    slot = self._free_slots.get_nowait()
                except queue.Empty:
                    slot = None
            else:
                # backpressure: the wait is on the stages after this one
                hb = self._hb["batcher"]
                t_wait = time.perf_counter()
                hb[:] = [_HB_WAIT, t_wait]
                while True:
                    try:
                        slot = self._free_slots.get(timeout=0.002)
                        break
                    except queue.Empty:
                        if self.input_queue.depth(seg.PRIORITY_HIGH):
                            slot = None
                            break
                now = time.perf_counter()
                hb[:] = [_HB_ACTIVE, now]
                self._slot_waited += now - t_wait
                self.timers.add("slot_wait", now - t_wait)
                if slot is None:
                    return None           # high work first; retry after
            if slot is not None:
                buf = self._ring[slot]
        if buf is None:        # side pool: mismatched seq or express overflow
            slot = None
            buf = self._side_buffer(width)
        return _OpenBatch(slot, buf, width,
                          time.perf_counter() + self._effective_linger())

    def _recycle(self, slot: Optional[int], buf: np.ndarray) -> None:
        if slot is not None:
            self._free_slots.put(slot)
            return
        with self._alt_lock:
            pool = self._alt_pool.setdefault(buf.shape[1], [])
            if len(pool) < ALT_POOL_CAP:
                pool.append(buf)

    # ---- backlog accounting (work stealing, DESIGN.md §8) --------------------
    @property
    def chunks_per_segment(self) -> int:
        """Compiled chunks per full segment (drain-time unit conversion)."""
        return self._span // self.batch_size

    def dispatch_backlog(self) -> int:
        """Chunks flushed but not yet committed to the device — the stage
        the admission-queue depth can no longer see (steal accounting)."""
        return self._dispatch_q.qsize()

    # ---- stage 1: batcher ----------------------------------------------------
    def _flush(self, batch: _OpenBatch) -> None:
        """Close a slot: cut it into compiled-batch chunks (full batches plus
        a pow2-bucketed remainder), zero stale pad rows, and enqueue each
        chunk as an independently schedulable :class:`ChunkDesc` on the
        priority dispatch queue.  The slot's :class:`SlotRef` refcount
        starts at the chunk count, so the ring buffer recycles only after
        every chunk's output is materialized.  Padding counters make
        coalescing efficiency observable."""
        chunks = []                           # (offset, bucket, valid) views
        for off in range(0, batch.fill, self.batch_size):
            valid = min(self.batch_size, batch.fill - off)
            bucket = bucket_for(valid, self.batch_size)
            if valid < bucket:
                batch.buf[off + valid:off + bucket] = 0   # stale tail rows
            chunks.append((off, bucket, valid))
            self.timers.inc("rows_valid", valid)
            self.timers.inc("rows_dispatched", bucket)
        self.timers.inc("batches", len(chunks))
        self.timers.inc("spans", len(batch.spans))
        if not chunks:                        # defensive: nothing packed
            self._recycle(batch.slot, batch.buf)
            return
        ref = SlotRef(batch.slot, batch.buf, len(chunks))
        by_chunk: Dict[int, List[Span]] = {}
        for sp in batch.spans:                # spans are chunk-aligned
            by_chunk.setdefault(sp.batch_off // self.batch_size,
                                []).append(sp)
        now = time.perf_counter()
        by_level: Dict[int, list] = {}
        for i, (off, bucket, valid) in enumerate(chunks):
            spans = by_chunk.get(i, [])
            level = chunk_level(spans)
            by_level.setdefault(level, []).append(
                ChunkDesc(ref, off, bucket, valid, spans, level, now))
        tr = self.tracer
        if tr is not None and tr.enabled:
            # ONE slot-pack instant per flush, stamped with the chunks'
            # shared t_enq — the timestamp the grouped dispatch-round
            # records join against to recover per-chunk request ids, so
            # this is the only place the slot's spans are walked for
            # attribution (batch.spans, not chunks x spans)
            rids = {sp.req.rid for sp in batch.spans}
            self._tr_batcher_ring.append(
                ("i", "pack", now, 0.0,
                 rids.pop() if len(rids) == 1 else tuple(rids),
                 len(chunks), max(by_level), None))
        for level, descs in sorted(by_level.items()):
            self._dispatch_q.put_many(descs, level)

    def _batcher(self):
        open_batch: Optional[_OpenBatch] = None
        hb = self._hb["batcher"]
        while True:
            t0 = time.perf_counter()
            hb[:] = [_HB_WAIT, t0]
            if open_batch is None:
                item = self.input_queue.get()
            else:
                # linger: wait for more rows, bounded by the slot deadline
                wait = open_batch.deadline - time.perf_counter()
                try:
                    if wait > 0:
                        item = self.input_queue.get(timeout=wait)
                    else:
                        item = self.input_queue.get_nowait()
                except queue.Empty:
                    t0 = self.timers.timed("batcher_wait", t0)
                    hb[:] = [_HB_ACTIVE, t0]
                    self._flush(open_batch)   # linger expired
                    open_batch = None
                    self.timers.timed("batch_fill", t0)
                    continue
            t0 = self.timers.timed("batcher_wait", t0)
            hb[:] = [_HB_ACTIVE, t0]
            self.timers.gauge(self._depth_gauge, self.input_queue.qsize())
            if item == SHUTDOWN:
                if open_batch is not None:
                    self._flush(open_batch)
                # a quiesce(wait=True) racing a drain may have enqueued its
                # FlushBarrier behind this SHUTDOWN — release those waiters
                # instead of leaving them to time out (descriptors cannot
                # land here: routing was removed before the SHUTDOWN)
                while True:
                    try:
                        tail = self.input_queue.get_nowait()
                    except queue.Empty:
                        break
                    if isinstance(tail, FlushBarrier):
                        tail.done.set()
                self._dispatch_q.put(None)
                return
            if item == FLUSH or isinstance(item, FlushBarrier):
                if open_batch is not None:    # quiesce: close the open slot
                    self._flush(open_batch)
                    open_batch = None
                if isinstance(item, FlushBarrier):
                    # the barrier rides the dispatch queue: the predictor
                    # acks it only once every chunk flushed before the
                    # quiesce has actually been dispatched (DESIGN.md §8)
                    self._dispatch_q.put(item)
                continue
            waited = self._slot_waited
            open_batch = self._admit(item, open_batch, t0)
            # the row copy and packing: the ring-slot waits are slot_wait's
            self.timers.add("batch_fill", time.perf_counter() - t0 -
                            (self._slot_waited - waited))

    def _admit(self, item, open_batch: Optional[_OpenBatch],
               t_pop: float) -> Optional[_OpenBatch]:
        """Pack one (request, segment) descriptor, popped from the input
        queue at ``t_pop``, returning the (possibly new / possibly flushed)
        open batch.  A bulk descriptor's wait for a ring slot is
        preemptible: when high-priority work lands in the admission queue
        mid-wait, the high descriptors are admitted first through express
        side buffers (recursion is one level deep — the express path never
        blocks), then the bulk wait resumes."""
        req, s = item                         # type: Request, int
        tr = self.tracer
        if tr is not None and tr.enabled and req.t_submit is not None:
            self.timers.add("input_wait", t_pop - req.t_submit)
        if req.dropped():
            # expired/cancelled: never pack rows — fail fast instead of
            # occupying ring slots (idempotent across workers/segments)
            self.prediction_queue.put(Message(
                seg.DROPPED, None, None, rid=req.rid))
            return open_batch
        if req.demoted_for(self.model_idx):
            # demoted mid-flight (brownout, DESIGN.md §11): forgive the
            # unit instead of packing — P=None with s >= 0 debits this
            # member's rows and tracks the missing weight for the
            # completion-time renormalization.  Never DROPPED (that fails
            # the whole request).  Checked BEFORE the ledger add, so no
            # pop-gate is involved: this batcher is the unit's only owner.
            if self.combiner is None or self.combiner.unexpect(req, s):
                lo, hi = req.bounds(s)
                self.timers.inc("rows_demoted", hi - lo)
                self.prediction_queue.put(Message(
                    s, self.model_idx, None, rid=req.rid))
            return open_batch
        # in-flight ledger entry BEFORE any rows are packed: from here the
        # descriptor is this worker's responsibility until the sender (or a
        # replaying supervisor) pops it — the one-statement gap between the
        # admission-queue pop and this add is the only window where a crash
        # loses the unit (hang, bounded by the client deadline, not silent
        # corruption)
        self._ledger[(req.rid, s)] = req
        if self._fault is not None:
            self._fault.tick(self.worker_id, "batcher")
        express = req.priority == seg.PRIORITY_HIGH
        lo, hi = req.bounds(s)
        width = req.x.shape[1]
        pos = lo
        while pos < hi:
            if open_batch is not None and open_batch.width != width:
                self._flush(open_batch)       # can't mix seq widths
                open_batch = None
            if open_batch is None:
                open_batch = self._open_batch(width, express=express)
                if open_batch is None:        # bulk slot wait interrupted
                    # take_high is atomic vs a racing drain_descriptors
                    # (which may empty the queue between a depth check and
                    # a pop) and never swallows sentinels.  A burst of high
                    # descriptors coalesces into ONE express batch (threaded
                    # through the loop) instead of one padded slot each.
                    hot = None
                    while True:
                        hitem = self.input_queue.take_high()
                        if hitem is None:
                            break
                        hot = self._admit(hitem, hot, time.perf_counter())
                    if hot is not None:       # high work never lingers here
                        self._flush(hot)
                    continue                  # resume the bulk slot wait
            f = open_batch.fill
            fill = min(self._span - f, hi - pos)
            open_batch.buf[f:f + fill] = req.x[pos:pos + fill]    # one copy
            # spans never cross a compiled-batch boundary inside the
            # slot, so every span maps to exactly one predictor chunk
            while fill > 0:
                k = min(self.batch_size - f % self.batch_size, fill)
                open_batch.spans.append(Span(req, s, pos - lo, f, k))
                f += k
                pos += k
                fill -= k
            open_batch.fill = f
            if f == self._span:
                self._flush(open_batch)       # full slot: flush immediately
                open_batch = None
        if open_batch is not None and req.deadline is not None:
            # deadline-aware linger (ROADMAP item f): the slot may wait
            # at most half the tightest packed row's remaining deadline
            # budget — a tight-deadline row never waits out a full
            # linger, and the other half of the budget is left for
            # predict + combine.  Same perf_counter clock as the linger.
            open_batch.deadline = min(
                open_batch.deadline,
                (time.perf_counter() + req.deadline) / 2.0)
        if open_batch is not None and express:
            # high-priority rows preempt the linger: flush as soon as
            # the queue runs dry instead of waiting out max_wait_us
            # (anything already queued still coalesces first)
            open_batch.deadline = 0.0
        if not self.coalesce and open_batch is not None:
            self._flush(open_batch)           # PR-1 semantics: per-item flush
            open_batch = None
        return open_batch

    # ---- stage 2: predictor --------------------------------------------------
    def _upload(self, c: ChunkDesc) -> torch.Tensor:
        """Chunk ``c``'s rows on the device, copied on the current stream.
        A ring slot is pinned, so the copy is async; its pinned source stays
        alive until the chunk's output has materialized (SlotRef).  A
        side-pool buffer is pageable numpy memory: ``non_blocking`` then
        returns only once the source has been read, so its copy is correct
        but does not overlap.  On the CPU the result aliases the slot."""
        if c.ref.slot is not None:
            src = self._ring_t[c.ref.slot][c.off:c.off + c.bucket]
        else:
            src = torch.from_numpy(c.ref.buf[c.off:c.off + c.bucket])
        return src.to(self._device, non_blocking=True)

    def _stage(self, c: ChunkDesc) -> tuple:
        """Start chunk ``c``'s upload ahead of its forward -> (c, buffer,
        the copy's event); on the card it runs on this worker's copy
        stream."""
        if self._copy is None:
            return c, self._upload(c), None
        with torch.cuda.stream(self._copy):
            x = self._upload(c)
            ev = torch.cuda.Event()
            ev.record(self._copy)
        return c, x, ev

    def _staged_input(self, staged: tuple) -> torch.Tensor:
        """A staged buffer made ready for the forward: the compute stream
        waits for the copy, and the buffer's block, allocated on the copy
        stream, is not handed back to it before the compute stream's work
        enqueued so far has run (else the next staged upload could
        overwrite rows the forward still reads)."""
        _, x, ev = staged
        if ev is not None:
            compute = torch.cuda.current_stream(self._device)
            compute.wait_event(ev)
            x.record_stream(compute)
        return x

    @staticmethod
    def _settle(staged: Optional[tuple]) -> None:
        """Wait for a staged copy that no forward will read: its chunk's
        slot may be recycled, and rewritten, as soon as the sender sees
        the chunk."""
        if staged is not None and staged[2] is not None:
            staged[2].synchronize()

    def _predictor(self):
        """Pop chunks from the priority dispatch queue and commit them to
        the device, keeping at most ``dispatch_ahead`` (K) async dispatches
        outstanding.  A window token is acquired *before* each pop, so a
        chunk only leaves the queue when it can dispatch immediately — the
        queue stays free to reorder until the last moment, and K bounds the
        committed (non-preemptible) work.  Dispatched chunks accumulate in
        a local group shipped to the sender in ONE queue hop whenever the
        window fills, the queue runs dry, or a control item arrives —
        per-chunk hand-offs would pay a thread wakeup per chunk
        (chunks-per-slot × the old slot rate) without changing scheduling,
        since the window token is what gates commitment.  A chunk whose
        every span belongs to a cancelled/expired request is never
        dispatched: it rides the group as a skipped chunk (the sender owns
        the staging dict and the DROPPED accounting)."""
        tr = self.tracer
        tr_ring = tr.ring(self._tr_predict) if tr is not None else None
        while True:
            # grab every instantly-available window token (>= 1, blocking
            # for the first) and pop that many chunks in ONE queue lock
            # round — per-chunk lock rounds would pay a contended lock +
            # thread wakeup per chunk with identical commitment semantics,
            # since the token count is what bounds the committed window
            hb = self._hb["predictor"]
            hb[:] = [_HB_WAIT, time.perf_counter()]
            self._dispatch_sem.acquire()
            tokens = 1
            while tokens < self.dispatch_ahead and \
                    self._dispatch_sem.acquire(blocking=False):
                tokens += 1
            items = self._dispatch_q.get_batch(tokens)
            hb[:] = [_HB_ACTIVE, time.perf_counter()]
            group: List[tuple] = []
            committed = 0
            stop = False
            ctl = False                   # round saw a non-chunk item
            t0 = time.perf_counter()
            # double-buffered H2D staging: after committing chunk i, chunk
            # i+1's upload is issued at once on the copy stream, so it
            # overlaps chunk i's compute instead of serializing upload ->
            # compute per chunk.  One buffer deep: the SlotRef refcount
            # keeps the staged rows alive (the staged chunk hasn't
            # materialized), and the dispatch window bounds how far ahead
            # staging can run.
            staged = mine = None          # (ChunkDesc, buffer, copy event)
            stage_h2d = not self.fake
            # traced rounds time each forward on the card (_record_forward)
            timed = tr is not None and tr.enabled and self._cuda \
                and not self.fake

            def _skippable(c):
                return c.spans and all(
                    sp.req.dropped() or sp.req.demoted_for(self.model_idx)
                    for sp in c.spans)

            try:
                for pos, item in enumerate(items):
                    if item is None:
                        stop = True
                        ctl = True
                        break
                    if isinstance(item, FlushBarrier):
                        if group:     # every earlier chunk is dispatched
                            self._send_q.put(group)
                            group = []
                        item.done.set()
                        ctl = True
                        continue
                    chunk: ChunkDesc = item
                    self.timers.add("dispatch_wait.high" if chunk.level ==
                                    seg.PRIORITY_HIGH else
                                    "dispatch_wait.normal", t0 - chunk.t_enq)
                    if staged is not None and staged[0] is chunk:
                        mine, staged = staged, None
                    if _skippable(chunk):
                        # demoted or dropped since it was staged: its copy
                        # ends before the sender may recycle its slot
                        self._settle(mine)
                        mine = None
                        group.append((chunk, None, None, t0, True, None))
                        continue
                    committed += 1
                    y = ev = clock = None
                    nan_out = False
                    if self._fault is not None:
                        nan_out = self._fault.tick(
                            self.worker_id, "predictor") == "nan"
                    if nan_out:
                        # poisoned device output: bypasses the real dispatch
                        # so it works identically on fake and real devices;
                        # the sender's nan_guard is what must catch it
                        self._settle(mine)
                        y = np.full((chunk.bucket, self.num_classes),
                                    np.nan, np.float32)
                    elif self.fake:
                        if self.fake_delay_us:    # simulated device time
                            time.sleep(self.fake_delay_us * 1e-6)
                    else:
                        if mine is not None:      # upload already in flight
                            x = self._staged_input(mine)
                            self.timers.inc("h2d_staged", 1)
                        else:
                            x = self._upload(chunk)
                        fe = (self.frontend[:chunk.bucket]
                              if self.frontend is not None else None)
                        if timed:
                            # the enqueue's start and a timing event before
                            # the forward; the marker below ends it
                            t_start = time.perf_counter()
                            start = torch.cuda.Event(enable_timing=True)
                            start.record(torch.cuda.current_stream(
                                self._device))
                        y = self.predict_fn(self.params, x, fe)
                        if self._cuda:        # materialization marker
                            ev = torch.cuda.Event(enable_timing=timed)
                            ev.record(torch.cuda.current_stream(self._device))
                        if timed:
                            clock = (t_start, start)
                        if stage_h2d:
                            # overlap the NEXT chunk's upload with this
                            # compute
                            for nxt in items[pos + 1:]:
                                if nxt is None or isinstance(nxt, FlushBarrier):
                                    break
                                if not _skippable(nxt):
                                    staged = self._stage(nxt)
                                    break
                    mine = None
                    group.append((chunk, y, ev, t0, False, clock))
                    hb[:] = [_HB_ACTIVE, time.perf_counter()]   # progress
            finally:
                # a round always reaches the chunk it staged; a crash
                # mid-round leaves no copy reading a slot, and no buffer
                # or event held by this frame's traceback
                self._settle(staged)
                self._settle(mine)
                staged = mine = x = None
            for _ in range(tokens - committed):   # unused / skipped tokens
                self._dispatch_sem.release()
            if group:
                self._send_q.put(group)
            if committed:
                t1 = self.timers.timed("predict", t0)
            if tr is not None and tr.enabled and items:
                # ONE flat rid-free record per pop round (invisible to
                # the GC), with ZERO per-chunk work in the loop above:
                # the popped list is reused as the round's chunk group
                # (filtered only when a control item rode along — rare).
                # dur slot = absolute pop time, slot a = the packed
                # per-chunk enqueue times, slots b/c = the attached
                # predict duration / committed count.  Request
                # attribution is recovered at export time by joining
                # each t_enq against this worker's pack instants, so the
                # hot loop never walks span lists.
                dw = items if not ctl else \
                    [c for c in items if isinstance(c, ChunkDesc)]
                if dw:
                    tr_ring.append(
                        ("G", "dispatch_wait", dw[0].t_enq, t0, None,
                         pack_times([c.t_enq for c in dw]),
                         (t1 - t0) if committed else None,
                         committed or None))
            if stop:
                self._send_q.put(None)
                return

    # ---- stage 3: sender -----------------------------------------------------
    def _sender(self):
        """Materialize each chunk's output and scatter its spans back to
        their segments, forwarding a (request, segment) contribution **as
        soon as its last span's chunk returns** — early per-segment
        forwarding; the whole slot no longer has to retire first.  All of a
        segment's spans still pass through THIS sender (the broadcaster
        assigns every (segment, model) pair to one instance), but priority
        reordering in the dispatch queue means they may arrive out of
        seg_off order, so staging is row-count-based with parts keyed by
        segment offset; downstream accounting already counts rows.  Still
        ONE contribution per (request, segment) — per-span forwarding would
        multiply combiner/accumulator traffic by chunks-per-segment and
        serialize senders on the combiner lock.  The sender also owns the
        DROPPED path: spans of cancelled/expired requests (and whole
        skipped chunks) purge their staging entry and post the rows to the
        ``rows_dropped`` counter, keyed by an idempotent ``DROPPED``
        resolution message."""
        on_device = self.combiner is not None
        staging: Dict[tuple, list] = {}     # (rid, s) -> [rows, {seg_off: P}]
        tr = self.tracer
        tr_ring = tr.ring(self._tr_sender) if tr is not None else None
        hb = self._hb["sender"]
        while True:
            hb[:] = [_HB_WAIT, time.perf_counter()]
            batch = self._send_q.get()
            if batch is None:
                return
            t0 = time.perf_counter()
            hb[:] = [_HB_ACTIVE, t0]
            profiled = []                  # (bucket, valid) materialized
            for chunk, y, ev, _t_dispatch, skipped, clock in batch:
                self._send_chunk(chunk, y, ev, skipped, staging, on_device,
                                 profiled, clock)
                hb[:] = [_HB_ACTIVE, time.perf_counter()]   # progress
            now = self.timers.timed("transfer", t0)   # sync+scatter, group
            if tr is not None and tr.enabled:
                # grouped single span: slot a carries the group's shared
                # dispatch (pop) time — the correlation key export joins
                # against this worker's "G" dispatch-round record (which
                # in turn joins the pack instants) to recover request
                # ids, so the sender packs nothing per chunk
                tr_ring.append(
                    ("g", "transfer", t0, now - t0, None,
                     batch[0][3], len(batch), None))
            if profiled:
                # live bench feed (DESIGN.md §8): the group shares one
                # dispatch timestamp, so dispatch-to-materialized wall time
                # is attributed to its chunks proportionally by dispatched
                # rows — charging each chunk the cumulative group elapsed
                # would inflate the profile by up to dispatch_ahead x
                dt = now - batch[0][3]
                total = sum(b for b, _ in profiled) or 1
                for bucket, valid in profiled:
                    self.profiler.observe(self.model_idx, self.device.key(),
                                          bucket, valid, dt * bucket / total)

    def _record_forward(self, chunk: ChunkDesc, clock: tuple,
                        end: "torch.cuda.Event") -> None:
        """A traced chunk's forward on the card, read once its end event
        (the materialization marker) is reached:
        its device seconds by member and bucket
        (``forward_device.m<member>.b<bucket>``) beside its valid rows
        (counter ``forward_rows.m<member>.b<bucket>``), its wait on the
        compute stream from the start of its enqueue to the start of its
        first kernel (``device_queue.m<member>``: the enqueue itself can
        block on a full launch queue while the forward already runs), and a
        ``forward`` span on the host clock on the ``<worker>/device`` track.
        The span's request ids are joined at export through the chunk's
        ``t_enq``; its host marks (enqueue start, this sync's return) ride
        along for causality checks.  The device seconds run from the start
        mark to the end mark on the one compute stream, so they also hold
        whatever another worker enqueued there meanwhile: with two members'
        predictors enqueuing at once, the two forwards' kernels interleave.
        The start event lands on the host clock through the worker's clock
        anchor (float32 milliseconds from it: a few microseconds' grain a
        minute on)."""
        t_synced = time.perf_counter()
        t_start, start = clock
        anchor, t_anchor = self._anchor
        t0 = t_anchor + 1e-3 * anchor.elapsed_time(start)
        dur = 1e-3 * start.elapsed_time(end)
        m, b = self.model_idx, chunk.bucket
        self.timers.add(f"forward_device.m{m}.b{b}", dur)
        self.timers.inc(f"forward_rows.m{m}.b{b}", chunk.valid)
        self.timers.add(f"device_queue.m{m}", t0 - t_start)
        self.tracer.ring(self._tr_device).append(
            ("g", "forward", t0, dur, None, pack_times((chunk.t_enq,)), 1,
             pack_times((t_start, t_synced))))

    def _send_chunk(self, chunk, y, ev, skipped, staging, on_device,
                    profiled, clock):
        if not skipped:
            if self._fault is not None:
                self._fault.tick(self.worker_id, "sender")
            if y is not None:
                if ev is not None:
                    ev.synchronize()       # compute done; outputs on device
                if clock is not None:
                    self._record_forward(chunk, clock, ev)
                if not on_device and not isinstance(y, np.ndarray):
                    y = y.cpu().numpy()    # d->h copy
                if self.nan_guard and isinstance(y, np.ndarray) \
                        and np.isnan(y).any():
                    # poisoned output: dying here (WorkerCrashed through
                    # _guarded) routes recovery through quarantine + replay
                    # on a sibling rather than folding NaN into Y
                    raise seg.WorkerCrashed(
                        f"{self.worker_id}: NaN in device output")
            self._dispatch_sem.release()   # window slot free again
            if self.profiler is not None and (y is not None
                                              or self.fake_delay_us):
                profiled.append((chunk.bucket, chunk.valid))
        if chunk.ref.release():            # last outstanding chunk:
            self._recycle(chunk.ref.slot, chunk.ref.buf)   # recycle slot
        dropped_rids = set()
        for sp in chunk.spans:
            lo, hi = sp.req.bounds(sp.s)
            key = (sp.req.rid, sp.s)
            if sp.req.demoted_for(self.model_idx) and not sp.req.dropped():
                # demoted mid-flight (brownout, DESIGN.md §11): discard any
                # staged rows and forgive the whole segment behind the
                # ledger pop-gate (exactly once vs a replaying supervisor
                # — same gate as the forwarding path).  Checked BEFORE the
                # dropped branch: a chunk skipped because its spans are
                # demoted must forgive, never DROPPED-fail the request.
                staging.pop(key, None)
                self.timers.inc("rows_demoted", sp.n)
                if self._ledger.pop(key, None) is not None and (
                        self.combiner is None or
                        self.combiner.unexpect(sp.req, sp.s)):
                    self.prediction_queue.put(Message(
                        sp.s, self.model_idx, None, rid=sp.req.rid))
                    tr = self.tracer
                    if tr is not None and tr.enabled:
                        tr.ring(self._tr_sender).append(
                            ("i", "forgive_demoted", tr.clock(), 0.0,
                             sp.req.rid, sp.s, None, None))
                continue
            if skipped or sp.req.dropped():
                # purge any rows staged by this segment's earlier chunks
                # (whatever order the chunks retired in, its LAST chunk
                # runs this branch too, so no entry can leak) and post
                # the idempotent DROPPED resolution
                staging.pop(key, None)
                self._ledger.pop(key, None)
                self.timers.inc("rows_dropped", sp.n)
                if sp.req.rid not in dropped_rids:
                    dropped_rids.add(sp.req.rid)
                    self.prediction_queue.put(Message(
                        seg.DROPPED, None, None, rid=sp.req.rid))
                    tr = self.tracer
                    if tr is not None and tr.enabled:
                        tr.ring(self._tr_sender).append(
                            ("i", "dropped", tr.clock(), 0.0,
                             sp.req.rid, sp.s, None, None))
                continue
            st = staging.get(key)
            if st is None:
                st = staging[key] = [0, {}]
            if y is not None:
                off = sp.batch_off - chunk.off   # row within this chunk
                if isinstance(y, tuple):   # quantized (q, per-row scale)
                    st[1][sp.seg_off] = (y[0][off:off + sp.n],
                                         y[1][off:off + sp.n])
                else:
                    st[1][sp.seg_off] = y[off:off + sp.n]
            st[0] += sp.n
            if st[0] < hi - lo:
                continue                   # segment still in flight
            del staging[key]
            # pop-gate (DESIGN.md §10): claim the in-flight ledger entry
            # IMMEDIATELY before forwarding.  dict.pop is GIL-atomic, so
            # exactly one of {this sender, a supervisor replaying this
            # worker} wins the entry — a miss means the unit was already
            # resubmitted to a sibling (this worker was quarantined, e.g.
            # a stalled stage waking up late) and forwarding it again
            # would double-count rows into Y.  Popping BEFORE the post
            # (not after) means a crash inside the post window hangs the
            # unit (bounded by deadline / retry) instead of corrupting Y.
            if self._ledger.pop(key, None) is None:
                continue
            # no forward instant here: the pop-gate moment is already
            # observable as the downstream combine/accumulate span for
            # (rid, s), and this path runs per (segment, member) — hot
            # enough that an extra clock call + emit showed up in the
            # tracing_overhead gate
            if y is None and not st[1]:    # fake predictor: instant zeros
                P = np.zeros((hi - lo, self.num_classes), np.float32)
            else:
                parts = [st[1][k] for k in sorted(st[1])]
                if len(parts) == 1:
                    P = parts[0]
                elif isinstance(parts[0], tuple):   # quantized parts
                    P = (torch.cat([p[0] for p in parts], dim=0),
                         torch.cat([p[1] for p in parts], dim=0))
                elif isinstance(parts[0], torch.Tensor):
                    P = torch.cat(parts, dim=0)
                else:
                    P = np.concatenate(parts, axis=0)
            if on_device:
                self.combiner.add(sp.req, sp.s, self.model_idx, P)
            else:
                self.prediction_queue.put(Message(
                    sp.s, self.model_idx, np.asarray(P),
                    rid=sp.req.rid))
