"""The asynchronous inference system (paper §II): segment broadcaster,
worker pool, device combiner and prediction accumulator."""
from repro_torch.serving.accumulator import PredictionAccumulator, RequestHandle
from repro_torch.serving.combiner import DeviceCombiner
from repro_torch.serving.metrics import StageTimers
from repro_torch.serving.segments import (DEFAULT_SEGMENT_SIZE, Message,
                                          PredictOptions, Request)
from repro_torch.serving.system import InferenceSystem
from repro_torch.serving.worker import Worker, bucket_for, make_predict_fn

__all__ = ["InferenceSystem", "Worker", "make_predict_fn", "bucket_for",
           "Message", "Request", "RequestHandle", "PredictionAccumulator",
           "DeviceCombiner", "StageTimers", "DEFAULT_SEGMENT_SIZE",
           "PredictOptions"]
