"""Deterministic fault injection for the serving pipeline (DESIGN.md §10).

Every recovery path in the fault-tolerance layer — supervision, quarantine,
chunk replay, graceful degradation — must be testable without real hardware
failures.  A :class:`FaultPlan` is a set of :class:`FaultSpec` triggers the
worker consults at fixed instrumentation points; on ``fake_delay_us``
simulated devices the Nth-chunk counters make the failure land at the same
pipeline position every run:

  * ``stage="batcher"``    fires on the Nth admitted (request, segment)
                           descriptor (after its in-flight ledger entry is
                           registered, so recovery is exercised, not a
                           pre-admission drop);
  * ``stage="predictor"``  fires on the Nth committed chunk, before its
                           dispatch — ``kind="nan"`` substitutes a NaN
                           output matrix instead (caught by the sender's
                           ``nan_guard``);
  * ``stage="sender"``     fires on the Nth chunk entering materialization,
                           before any contribution is forwarded (so the
                           ledger pop-gate, not luck, decides idempotency);
  * ``stage="spawn"``      fires in ``Worker.__init__`` — a failed spawn,
                           exercising the controller's backoff path.

Kinds: ``raise`` (the stage thread dies with :class:`InjectedFault`),
``stall`` (the stage sleeps ``stall_s`` — past the supervisor watchdog the
worker is quarantined while the thread is still alive, exercising the
late-wakeup idempotency protocol), ``nan`` (predictor only), ``slow``
(the stage sleeps ``stall_s`` but the spec stays armed with ``repeat=True``
— sustained slowdown, the overload/brownout drill in DESIGN.md §11, as
opposed to ``stall``'s one-shot hang).

Each spec fires **once** unless ``repeat=True``; counters are per
(worker, stage), so one plan can be shared by a whole system and scoped
with ``worker=`` prefixes.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

_STAGES = ("batcher", "predictor", "sender", "spawn")
_KINDS = ("raise", "stall", "nan", "slow")


class InjectedFault(RuntimeError):
    """A deterministic test fault raised by a :class:`FaultPlan` trigger."""


@dataclass
class FaultSpec:
    """One trigger: in ``stage``, on the ``after``+1-th unit, do ``kind``.

    ``worker`` scopes the spec to worker ids starting with that prefix
    (``"w0.1"`` matches the generation-tagged respawns too); None = any."""
    stage: str
    kind: str = "raise"
    after: int = 0              # units through the stage before firing
    stall_s: float = 30.0       # kind="stall"/"slow": simulated hang/delay
    worker: Optional[str] = None
    repeat: bool = False        # stay armed after firing (sustained faults)

    def __post_init__(self):
        if self.stage not in _STAGES:
            raise ValueError(f"unknown fault stage {self.stage!r} "
                             f"(expected one of {_STAGES})")
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if self.kind == "nan" and self.stage != "predictor":
            raise ValueError("kind='nan' only applies to stage='predictor'")
        if self.kind == "slow":
            self.repeat = True  # a one-shot "slow" is just a short stall

    def matches(self, worker_id: str) -> bool:
        return self.worker is None or worker_id.startswith(self.worker)

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """Build a spec from a ``key=value[,key=value...]`` CLI string, e.g.
        ``stage=predictor,kind=raise,after=3,worker=w0.0``."""
        kw: Dict[str, object] = {}
        for part in text.split(","):
            if not part.strip():
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key in ("after",):
                kw[key] = int(val)
            elif key in ("stall_s",):
                kw[key] = float(val)
            elif key in ("repeat",):
                kw[key] = val.strip().lower() in ("1", "true", "yes")
            elif key in ("stage", "kind", "worker"):
                kw[key] = val.strip()
            else:
                raise ValueError(f"unknown --fault key {key!r}")
        if "stage" not in kw:
            raise ValueError("--fault needs at least stage=<name>")
        return cls(**kw)  # type: ignore[arg-type]


class FaultPlan:
    """A shared, thread-safe set of triggers.  ``tick`` is the worker-side
    hook: it counts one unit through ``stage`` for ``worker_id`` and fires
    any matching armed spec — raising for ``raise``, sleeping for ``stall``
    (the sleep releases the GIL, so the supervisor keeps running), and
    returning ``"nan"`` for ``nan`` so the predictor substitutes outputs.
    Workers skip the call entirely when no plan is configured, so the hot
    path pays nothing by default."""

    def __init__(self, *specs: FaultSpec):
        self._specs: List[FaultSpec] = list(specs)
        self._armed: List[bool] = [True] * len(self._specs)
        self._counts: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str, str]] = []   # (worker, stage, kind)

    def add(self, spec: FaultSpec) -> "FaultPlan":
        with self._lock:
            self._specs.append(spec)
            self._armed.append(True)
        return self

    def tick(self, worker_id: str, stage: str) -> Optional[str]:
        with self._lock:
            key = (worker_id, stage)
            n = self._counts.get(key, 0)
            self._counts[key] = n + 1
            hit = None
            for i, spec in enumerate(self._specs):
                if (self._armed[i] and spec.stage == stage
                        and spec.matches(worker_id) and n >= spec.after):
                    if not spec.repeat:
                        self._armed[i] = False
                    self.fired.append((worker_id, stage, spec.kind))
                    hit = spec
                    break
        if hit is None:
            return None
        if hit.kind in ("stall", "slow"):
            time.sleep(hit.stall_s)
            return None
        if hit.kind == "nan":
            return "nan"
        raise InjectedFault(
            f"injected {stage} fault on {worker_id} (unit {n})")
