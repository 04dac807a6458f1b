"""HTTP v2 on the EnsembleClient facade (paper §II.A, DESIGN.md §7).

Endpoints (stdlib only):
  POST /v2/predict  body: {"tokens": [[...], ...],
                           "priority": "high"|"normal",       (optional)
                           "deadline_ms": float,              (optional)
                           "members": [model ids],            (optional)
                           "combine": "mean|weighted|vote|pallas",
                           "cache": "use|bypass|refresh"}     (optional)
                    -> {"predictions": [[...], ...]}
                       plus "quality" < 1.0 when the result is a degraded
                       partial-ensemble combine (DESIGN.md §10)
                    (504 when the deadline expires; 429 + Retry-After when
                    admission refuses the request — infeasible deadline at
                    the current pressure, or byte/row budget exhausted
                    (DESIGN.md §11); 503 + Retry-After when capacity is
                    transiently unavailable — quarantined member, retries
                    exhausted; both Retry-After values derive from the live
                    drain estimate; 400 on bad input)
  POST /predict     v1 compatibility shim: the original adaptive batcher —
                    requests buffered until a segment fills or ``max_wait_s``
                    elapses, then predicted as one batch (paper §I.B).  New
                    clients should POST /v2/predict: the system's own
                    coalescing scheduler already does cross-request batching
                    with per-request options honored.
  GET  /metrics     serving counters (padding efficiency, rows, batches,
                    spans), per-worker queue-depth gauges (+ the rolling
                    hp_p50_ms gauge), per-priority-class latency p50/p99
                    (from fixed-bucket log-scale histograms; raw buckets
                    under "latency_hist"), per-stage timings incl.
                    dispatch_wait.high/normal, cache hit rates (ROADMAP
                    item d).  With ``?format=prom`` — or an ``Accept``
                    header naming ``text/plain`` / ``openmetrics`` — the
                    same surface renders as Prometheus text exposition
                    0.0.4 (typed, labeled families; DESIGN.md §13)
  GET  /v2/trace    Chrome-trace / Perfetto JSON of the flight recorder
                    (DESIGN.md §13); ``?dumps=1`` returns the
                    anomaly-triggered dumps instead
  GET  /health      -> {"status": "ok", "workers": N}
  GET  /allocation  -> the allocation matrix
"""
from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np

import math

from repro_torch.serving.client import EnsembleClient
from repro_torch.serving.metrics import PROM_CONTENT_TYPE, prometheus_text
from repro_torch.serving.segments import (DeadlineExceeded, Overloaded,
                                          PredictOptions, ServingUnavailable)
from repro_torch.serving.system import InferenceSystem


class _Pending:
    def __init__(self, x: np.ndarray):
        self.x = x
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.cancelled = False          # submitter gave up (timeout)


class AdaptiveBatcher:
    """Buffers requests into segments; flushes on size or timeout.  Kept as
    the v1 ``/predict`` compatibility path — the v2 route goes straight
    through the facade and relies on the worker-level coalescing scheduler."""

    def __init__(self, system: InferenceSystem, *, max_wait_s: float = 0.05,
                 cache=None):
        self.system = system
        self.max_wait_s = max_wait_s
        self.cache = cache                  # optional PredictionCache
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, x: np.ndarray, timeout: float = 120.0) -> np.ndarray:
        p = _Pending(x)
        self.q.put(p)
        if not p.event.wait(timeout):
            # mark so the flush loop drops it instead of predicting rows
            # nobody will collect (the timed-out _Pending used to stay in
            # the queue and still get predicted)
            p.cancelled = True
            raise TimeoutError("request timed out")
        return p.result

    def stop(self):
        self._stop.set()
        self._thread.join(5.0)

    def _run(self):
        target = self.system.segment_size
        while not self._stop.is_set():
            batch: List[_Pending] = []
            count = 0
            deadline = None
            while count < target:
                timeout = None if deadline is None else max(0.0, deadline - time.monotonic())
                try:
                    p = self.q.get(timeout=0.05 if deadline is None else timeout)
                except queue.Empty:
                    if deadline is None:
                        if self._stop.is_set():
                            return
                        continue
                    break                       # adaptive flush on timeout
                if deadline is None:
                    deadline = time.monotonic() + self.max_wait_s
                batch.append(p)
                count += p.x.shape[0]
            batch = [p for p in batch if not p.cancelled]   # timed-out waiters
            if not batch:
                continue
            X = np.concatenate([p.x for p in batch], axis=0)
            try:
                Y = (self.cache.predict_through(self.system, X)
                     if self.cache is not None else self.system.predict(X))
                off = 0
                for p in batch:
                    p.result = Y[off:off + p.x.shape[0]]
                    off += p.x.shape[0]
            except Exception:                   # surface errors to all waiters
                for p in batch:
                    p.result = None
            for p in batch:
                p.event.set()


def _header_s(retry_after_s: float) -> str:
    """``Retry-After`` header value: whole seconds, never below 1 (the
    header grammar is integer seconds; the JSON body carries the exact
    float for clients that can use sub-second backoff)."""
    return str(max(1, int(math.ceil(retry_after_s))))


def _parse_options(payload: dict) -> PredictOptions:
    """Per-request options from the v2 JSON body (unknown keys ignored)."""
    kw = {}
    if "priority" in payload:
        kw["priority"] = payload["priority"]
    if payload.get("deadline_ms") is not None:
        kw["deadline_ms"] = float(payload["deadline_ms"])
    if payload.get("members") is not None:
        kw["members"] = [int(m) for m in payload["members"]]
    if payload.get("combine") is not None:
        kw["combine"] = str(payload["combine"])
    if payload.get("cache") is not None:
        kw["cache"] = str(payload["cache"])
    return PredictOptions(**kw)


def serve(system: InferenceSystem, host: str = "127.0.0.1", port: int = 8600,
          *, max_wait_s: float = 0.05,
          cache=None) -> Tuple[ThreadingHTTPServer, AdaptiveBatcher]:
    """Start the HTTP server (returns immediately; server runs on a thread).
    ``cache``: optional serving.request_cache.PredictionCache (paper §I.B),
    shared by the v1 shim and the v2 facade."""
    batcher = AdaptiveBatcher(system, max_wait_s=max_wait_s, cache=cache)
    client = EnsembleClient(system, cache=cache)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):              # quiet
            pass

        def _retry_after(self, e: BaseException) -> float:
            """Drain-estimate-derived backoff, shared by 429 and 503
            (DESIGN.md §11).  An exception that computed its own estimate
            at raise time (``Overloaded``) wins; otherwise ask the system
            now."""
            ra = getattr(e, "retry_after_s", None)
            if ra is None:
                ra = system.retry_after_s()
            return round(float(ra), 3)

        def _json(self, code: int, payload, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _text(self, code: int, body: str, content_type: str):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _wants_prom(self, query: str) -> bool:
            """Content negotiation for /metrics: explicit ``?format=prom``
            wins; otherwise an Accept header naming the text exposition
            (Prometheus scrapers send ``text/plain;version=0.0.4`` or an
            openmetrics type — a browser's ``text/html,...`` does not
            match)."""
            if "format=prom" in query:
                return True
            accept = self.headers.get("Accept", "")
            return "openmetrics" in accept or "text/plain" in accept

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/health":
                self._json(200, {"status": "ok",
                                 "workers": len(system.workers),
                                 "models": [c.name for c in system.cfgs]})
            elif path == "/allocation":
                self._json(200, {"models": system.alloc.model_names,
                                 "A": system.alloc.A.tolist()})
            elif path == "/v2/trace":
                # flight-recorder export (DESIGN.md §13): the live Perfetto
                # timeline, or the anomaly-triggered dumps with ?dumps=1
                if "dumps=1" in query:
                    self._json(200, {"dumps": system.tracer.dumps(),
                                     "anomalies": system.tracer.anomalies()})
                else:
                    self._json(200, system.tracer.export())
            elif path == "/metrics":
                if self._wants_prom(query):
                    system.serving_gauges()   # refresh worker health gauges
                    self._text(200, prometheus_text(system.timers),
                               PROM_CONTENT_TYPE)
                    return
                ctl = system.controller
                self._json(200, {
                    "counters": system.serving_counters(),
                    "gauges": system.serving_gauges(),
                    # per-class p50/p99 (incl. hp_p50 — the SLO the
                    # chunk-granular preemption targets, DESIGN.md §3)
                    "latency": system.latency_snapshot(),
                    # raw log-scale buckets behind those percentiles (§13)
                    "latency_hist": system.timers.latency_histogram(),
                    "stages": system.stage_timings(),
                    "cache": ({"hits": cache.hits, "misses": cache.misses}
                              if cache is not None else None),
                    # online reconfiguration observability (DESIGN.md §8)
                    "controller": ctl.stats() if ctl is not None else None,
                    # overload/brownout observability (DESIGN.md §11)
                    "brownout": (system.brownout.stats()
                                 if system.brownout is not None else None),
                    "admission_budget": (
                        system.admission_budget.snapshot()
                        if system.admission_budget is not None else None)})
            else:
                self._json(404, {"error": "not found"})

        def _tokens(self, payload) -> np.ndarray:
            x = np.asarray(payload["tokens"], np.int32)
            if x.ndim != 2:
                raise ValueError("tokens must be 2-D (batch, seq)")
            return x

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                if self.path == "/v2/predict":
                    x = self._tokens(payload)
                    opts = _parse_options(payload)
                    quality = 1.0
                    try:
                        h = client.predict_async(x, opts)
                        y = h.result(600.0)
                        quality = h.quality()
                    except DeadlineExceeded as e:
                        self._json(504, {"error": f"deadline exceeded: {e}"})
                        return
                    except Overloaded as e:
                        # refused at admission (DESIGN.md §11): infeasible
                        # deadline or exhausted byte/row budget — 429, with
                        # Retry-After computed from the drain estimate
                        ra = self._retry_after(e)
                        self._json(429,
                                   {"error": f"{type(e).__name__}: {e}",
                                    "retry_after_s": ra},
                                   headers={"Retry-After": _header_s(ra)})
                        return
                    except ServingUnavailable as e:
                        # transient capacity failure (quarantined member /
                        # exhausted retries, DESIGN.md §10): retryable —
                        # 503 + Retry-After, never a permanent error.  Same
                        # drain-estimate-derived value as the 429 path
                        ra = self._retry_after(e)
                        self._json(503,
                                   {"error": f"{type(e).__name__}: {e}",
                                    "retry_after_s": ra},
                                   headers={"Retry-After": _header_s(ra)})
                        return
                    if y is None:
                        self._json(500, {"error": "prediction failed"})
                        return
                    out = {"predictions": y.tolist()}
                    if quality < 1.0:     # degraded partial-ensemble result
                        out["quality"] = quality
                    self._json(200, out)
                    return
                elif self.path == "/predict":   # v1 compatibility shim
                    x = self._tokens(payload)
                    y = batcher.submit(x)
                else:
                    self._json(404, {"error": "not found"})
                    return
                if y is None:
                    self._json(500, {"error": "prediction failed"})
                    return
                self._json(200, {"predictions": y.tolist()})
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, batcher
