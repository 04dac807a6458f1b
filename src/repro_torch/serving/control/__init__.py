"""Online reconfiguration (DESIGN.md §8): the control plane that closes the
loop between the paper's offline allocator (worst-fit + bounded greedy) and
the live serving hot path.

* :class:`LiveBench` — an EWMA per-(member, device, bucket) latency profile
  plus per-member demand shares, fed by the workers and the broadcaster;
  callable as a ``Bench`` so the paper's Algorithm 2 can replan against the
  *live* workload instead of the offline calibration profile.
* :class:`ReconfigController` — a background thread that periodically
  re-runs the bounded greedy against the live profile and applies the
  allocation delta as live actions (spawn / drain / rebatch instances),
  and runs the work-stealing fast path between replans.
* :mod:`stealing` — re-routes queued descriptors from a deep admission
  queue to an idle data-parallel sibling, moving the device combiners'
  expected-row maps with them.
* :class:`Supervisor` — per-worker heartbeat/liveness sweep that contains
  instance failures (quarantine + chunk replay / graceful degradation,
  DESIGN.md §10) instead of the paper's all-or-nothing sentinel.
* :class:`BrownoutController` — overload robustness (DESIGN.md §11):
  pressure-driven quality tiers with hysteresis, cost-aware admission with
  computed Retry-After, mid-flight demotion and confidence-gated cascade.
"""
from repro_torch.serving.control.controller import ReconfigController
from repro_torch.serving.control.livebench import LiveBench
from repro_torch.serving.control.overload import (
    BrownoutController, CascadeHandle, build_tier_table, estimate_drain_s)
from repro_torch.serving.control.stealing import balance_member, steal_from
from repro_torch.serving.control.supervisor import Supervisor

__all__ = ["ReconfigController", "LiveBench", "balance_member", "steal_from",
           "Supervisor", "BrownoutController", "CascadeHandle",
           "build_tier_table", "estimate_drain_s"]
