"""Trace-driven discrete-event simulator of the serving pipeline.

DESIGN.md §12.  The simulator replays request traces (recorded or
synthetic) through a virtual-clock model of the hot path — admission →
batcher/coalescing → DispatchQueue → predictor groups → completion — while
driving the *real* policy code: the real ``AdmissionQueue`` /
``DispatchQueue`` (and the EDF prototype), the real
``chunk_level``/``bucket_for`` packing rules, real ``Span``/``ChunkDesc``/
``SlotRef`` objects, and the real control plane (``balance_member``,
``BrownoutController.step``, ``LiveBench`` + ``bounded_greedy`` replans).
Only *time* is modelled: per-member chunk service times come from a
:class:`ServiceModel` fitted from recorded ``fake_delay_us`` runs (or a
LiveBench snapshot of one).

Everything is deterministic: one thread, one event heap with a sequence
tie-break, ``numpy`` generators seeded explicitly — the same seed and trace
produce a bit-identical event log and metrics.
"""
from repro_torch.serving.sim.engine import SimSystem, SimWorker, WorkerSpec
from repro_torch.serving.sim.events import EventLoop
from repro_torch.serving.sim.forecast import DemandForecaster
from repro_torch.serving.sim.service import ServiceModel
from repro_torch.serving.sim.traces import (diurnal_trace, mmpp_trace,
                                            poisson_trace)
from repro_torch.serving.sim.tuner import tune_dispatch_ahead

__all__ = ["SimSystem", "SimWorker", "WorkerSpec", "EventLoop",
           "ServiceModel", "DemandForecaster", "poisson_trace",
           "mmpp_trace", "diurnal_trace", "tune_dispatch_ahead"]
