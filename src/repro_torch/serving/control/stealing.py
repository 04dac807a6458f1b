"""Cross-worker work stealing (DESIGN.md §8, ROADMAP items c/g).

The replanner corrects *minutes*-scale drift; this module corrects
*milliseconds*-scale imbalance: when one member-instance's admission queue
runs deep while a data-parallel sibling idles, queued segment descriptors are
re-routed to the sibling.  Three invariants make a steal safe:

* **atomic ownership** — ``AdmissionQueue.steal`` pops descriptors under the
  queue lock, so a descriptor is processed by exactly one batcher; a whole
  ``(request, segment)`` moves at once, so the sender's span reassembly is
  untouched (all of a segment's spans still flow through one batcher).
  Selection is deadline-aware (ROADMAP item i): the tightest remaining
  deadline budget moves first — it gains the most from the idle sibling;
* **expected-row maps move with the work** — with the device-resident
  partial combine, the source device's combiner expected one contribution
  for the stolen (request, segment); ``unexpect``/``expect_one`` transfer
  that expectation (flushing the source partial early when the remaining
  members' rows already closed it), so row-count flush accounting still
  closes on both devices;
* **topology consistency** — steals run under the system's submit lock, so
  they cannot interleave with a spawn/drain (a descriptor is never re-routed
  into a queue behind a ``SHUTDOWN``) or a racing broadcaster registering a
  new request's expected maps.
"""
from __future__ import annotations

from typing import List

from repro_torch.serving.segments import PRIORITY_NORMAL
from repro_torch.serving.worker import Worker


def _transfer(req, s: int, src: Worker, dst: Worker) -> None:
    """Move the combiner expectation for (req, s) from src's device to
    dst's.  Same-device siblings share a combiner (no move); a dropped
    (cancelled/expired) request's maps were already torn down — the
    descriptor still forwards so the destination batcher posts the DROPPED
    resolution."""
    if (src.combiner is None or dst.combiner is None
            or src.combiner is dst.combiner or req.dropped()):
        return
    if src.combiner.unexpect(req, s):
        dst.combiner.expect_one(req, s)


def migrate_descriptors(system, src: Worker, siblings: List[Worker]) -> int:
    """Drain-side migration: move EVERYTHING still queued on ``src`` —
    including high-priority descriptors, which :meth:`AdmissionQueue.steal`
    deliberately never touches — to its siblings round-robin.  Caller
    (``InferenceSystem.drain_instance``) holds the submit lock and has
    already removed ``src`` from routing."""
    targets = [w for w in siblings if w is not src]
    if not targets:
        return 0
    stolen = src.input_queue.drain_descriptors()
    for i, (req, s) in enumerate(stolen):
        dst = targets[i % len(targets)]
        _transfer(req, s, src, dst)
        dst.input_queue.put((req, s), req.priority)
    return len(stolen)


def steal_from(system, src: Worker, dst: Worker, max_items: int = 32) -> int:
    """Re-route up to ``max_items`` queued descriptors from ``src`` to its
    data-parallel sibling ``dst``.  Returns the number moved (0 when either
    worker is no longer a routable instance — e.g. a concurrent drain)."""
    if src.model_idx != dst.model_idx or src is dst:
        raise ValueError("work stealing requires data-parallel siblings")
    with system._submit_lock:
        inst = system._instances.get(src.model_idx, [])
        if src not in inst or dst not in inst:
            return 0
        stolen = src.input_queue.steal(max_items)
        for req, s in stolen:
            _transfer(req, s, src, dst)
            dst.input_queue.put((req, s), req.priority)
    return len(stolen)


def balance_member(system, m: int, *, threshold: int = 4,
                   max_items: int = 32, profile=None) -> int:
    """One balancing pass for member ``m``: steal from the instance with the
    longest estimated *drain time* to the one with the shortest.

    Raw queue depth is the wrong imbalance signal under heterogeneous
    batch sizes: a batch-128 sibling with 28 queued segments drains sooner
    than a batch-8 sibling with 20.  With a live profile (``LiveBench``),
    each instance's backlog is weighted by its measured per-segment service
    time and the move count is chosen to equalize drain times; without one,
    siblings are assumed equal-rate and this reduces to halving the depth
    gap.  ``threshold`` is in descriptors, measured at the *destination*'s
    service rate (how many descriptors of gap make the steal worthwhile).
    Backlog is the normal-priority admission depth **plus the chunk
    dispatch-queue backlog in segment units** (chunk-granular pipeline:
    flushed-but-undispatched work is real drain time the admission depth
    can no longer see, but it is not stealable — only the admission part
    moves).  High-priority descriptors are never stolen, so counting them
    (``qsize``) would make the fast loop chase phantom imbalance it can
    move nothing for.  Returns descriptors moved.

    The fast loop runs every couple of milliseconds, so an idle system must
    not pay for it: a lock-free peek at the per-queue depths (list copy is
    atomic under the GIL; each queue has its own lock) skips the member
    without ever touching the global submit lock the request hot path
    contends on — only a member with actual stealable backlog proceeds to
    the locked snapshot."""
    peek = list(system._instances.get(m, ()))
    if len(peek) < 2 or all(
            w.input_queue.depth(PRIORITY_NORMAL) == 0 for w in peek):
        return 0
    inst = system.instances(m)
    if len(inst) < 2:
        return 0
    rates = []
    for w in inst:
        t_seg = None
        if profile is not None:
            t_seg = profile.segment_time(m, w.device.key(), w.batch_size,
                                         system.segment_size)
        # admission backlog + flushed-but-undispatched chunks (in segment
        # units) — the dispatch queue is drain time too, just not stealable
        depth = w.input_queue.depth(PRIORITY_NORMAL) + \
            w.dispatch_backlog() / max(1, w.chunks_per_segment)
        rates.append((w, depth, t_seg))
    if any(t is None for _, _, t in rates):
        t_by_w = {id(w): 1.0 for w, _, _ in rates}     # cold profile: equal
    else:
        t_by_w = {id(w): t for w, _, t in rates}
    drains = [(n * t_by_w[id(w)], w, n) for w, n, _ in rates]
    deep_drain, deep_w, _ = max(drains, key=lambda t: t[0])
    idle_drain, idle_w, _ = min(drains, key=lambda t: t[0])
    t_deep, t_idle = t_by_w[id(deep_w)], t_by_w[id(idle_w)]
    # descriptors the idle sibling could absorb inside the drain-time gap
    gap = (deep_drain - idle_drain) / t_idle
    if deep_w is idle_w or gap < threshold:
        return 0
    # move enough to equalize drain times, not just halve the depth gap
    k = int((deep_drain - idle_drain) / (t_deep + t_idle))
    if k < 1:
        return 0
    return steal_from(system, deep_w, idle_w, min(max_items, k))
