"""The asynchronous inference system (paper §II): segment broadcaster,
worker pool, prediction accumulator, the EnsembleClient request facade and
the HTTP wrapper."""
from repro_torch.serving.accumulator import PredictionAccumulator, RequestHandle
from repro_torch.serving.admission import (AdmissionBudget, AdmissionQueue,
                                           DispatchQueue, chunk_level)
from repro_torch.serving.client import ClientHandle, EnsembleClient
from repro_torch.serving.combiner import DeviceCombiner
from repro_torch.serving.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.serving.metrics import StageTimers
from repro_torch.serving.request_cache import PredictionCache
from repro_torch.serving.segments import (DEFAULT_SEGMENT_SIZE, PRIORITY_HIGH,
                                          PRIORITY_NORMAL, ChunkDesc,
                                          DeadlineExceeded, MemberUnavailable,
                                          Message, Overloaded, PredictOptions,
                                          Request, RequestCancelled,
                                          RetriesExhausted, ServingUnavailable,
                                          SlotRef, WorkerCrashed)
from repro_torch.serving.server import AdaptiveBatcher, serve
from repro_torch.serving.system import InferenceSystem
from repro_torch.serving.tracing import FlightRecorder, Tracer
from repro_torch.serving.worker import Worker, bucket_for, make_predict_fn
from repro_torch.serving.control import (BrownoutController, LiveBench,
                                         ReconfigController, Supervisor)

__all__ = ["InferenceSystem", "Worker", "make_predict_fn", "bucket_for",
           "Message", "Request", "RequestHandle", "PredictionAccumulator",
           "DeviceCombiner", "StageTimers", "AdaptiveBatcher", "serve",
           "DEFAULT_SEGMENT_SIZE", "PredictOptions", "EnsembleClient",
           "ClientHandle", "AdmissionQueue", "DispatchQueue", "chunk_level",
           "ChunkDesc", "SlotRef", "PredictionCache",
           "DeadlineExceeded", "RequestCancelled", "PRIORITY_HIGH",
           "PRIORITY_NORMAL", "LiveBench", "ReconfigController",
           "FaultPlan", "FaultSpec", "InjectedFault", "Supervisor",
           "ServingUnavailable", "WorkerCrashed", "MemberUnavailable",
           "RetriesExhausted", "Overloaded", "AdmissionBudget",
           "BrownoutController", "Tracer", "FlightRecorder"]
