"""EnsembleClient: the one request API over every entry point (DESIGN.md §7).

The paper frames the system as a single ``f(X, A) -> {Y, S}`` interface, but
the implementation had grown three inconsistent doors — ``InferenceSystem``
(in-process), the HTTP server's adaptive batcher, and
``PredictionCache.predict_through``.  The facade subsumes all three:

  * **transport**: construct with ``system=`` for the in-process path or
    ``url=`` for a remote HTTP v2 server — call styles are identical;
  * **cache**: an optional :class:`PredictionCache` is consulted per the
    request's :class:`PredictOptions.cache` policy ("use" / "bypass" /
    "refresh"); only miss rows travel through the transport and the merged
    result preserves row order;
  * **call styles**: ``predict`` (sync), ``predict_async`` (a
    :class:`ClientHandle` future with ``result()`` / ``cancel()``), and
    ``predict_stream`` (per-segment callback as ensemble rows complete —
    in-process transport only).

Every per-request knob (priority class, deadline, member subset, combine
rule) rides on :class:`PredictOptions`, so SLO-aware admission applies the
same way whichever door a request came through.
"""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from dataclasses import replace
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serving.request_cache import PredictionCache
from repro_torch.serving.segments import (DeadlineExceeded, MemberUnavailable,
                                          Overloaded, PredictOptions,
                                          RequestCancelled, priority_level,
                                          PRIORITY_HIGH)


def quality_salt(salt: bytes, quality: float) -> bytes:
    """Cache salt for a degraded/brownout result (DESIGN.md §11): a
    quality < 1.0 prediction must never be stored under — or served for —
    a full-quality key, so the served tier partitions the key space."""
    if quality >= 1.0:
        return salt
    return salt + f"|q={quality:.6f}".encode()


class ClientHandle:
    """Facade-level future: merges cached rows with the transport's miss
    rows at ``result()`` time; ``cancel()`` propagates to the underlying
    request (in-process: through spans/combiner/accumulator accounting)."""

    def __init__(self, *, inner=None, Y: Optional[np.ndarray] = None,
                 error: Optional[BaseException] = None,
                 cached: Optional[List[Optional[np.ndarray]]] = None,
                 miss_idx: Optional[List[int]] = None,
                 X_miss: Optional[np.ndarray] = None,
                 cache: Optional[PredictionCache] = None,
                 cache_salt: bytes = b""):
        self._inner = inner            # RequestHandle / _HttpFuture, or None
        self._Y = Y                    # immediate result (every row cached)
        self._error = error
        self._cached = cached
        self._miss_idx = miss_idx
        self._X_miss = X_miss
        self._cache = cache            # insert target for resolved misses
        self._cache_salt = cache_salt

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if self._error is not None:
            raise self._error
        if self._Y is not None:
            return self._Y
        Y_miss = self._inner.result(timeout)
        if self._cache is not None:
            # quality-salted insert: a degraded partial-ensemble result
            # would otherwise poison the full-quality key and be replayed
            # at quality 1.0 long after the brownout ends
            self._cache.insert(self._X_miss, Y_miss,
                               quality_salt(self._cache_salt, self.quality()))
        if self._cached is None:       # nothing served from cache
            self._Y = Y_miss
        else:
            merged = list(self._cached)
            for j, i in enumerate(self._miss_idx):
                merged[i] = Y_miss[j]
            self._Y = np.stack(merged, axis=0)
        return self._Y

    def cancel(self) -> bool:
        if self._inner is None:
            return False
        return self._inner.cancel()

    def done(self) -> bool:
        if self._Y is not None or self._error is not None:
            return True
        return self._inner.done.is_set()

    def quality(self) -> float:
        """Fraction of the ensemble actually served (DESIGN.md §§10-11):
        1.0 = full ensemble; < 1.0 means a degraded partial combine (a
        member lost its last instance mid-request) or a brownout tier.
        Rows served from the cache under the base salt were full-quality
        when inserted (degraded results are quality-salted)."""
        if self._inner is None:
            return 1.0
        return getattr(self._inner, "quality", 1.0)

    def retry_after_s(self) -> Optional[float]:
        """Suggested backoff when the request was refused (429
        ``Overloaded``) or capacity was transiently unavailable (503) —
        the server's drain-estimate value, surfaced from the typed error.
        None when the request was not refused or has not resolved yet."""
        err = self._error
        if err is None and self._inner is not None:
            err = getattr(self._inner, "error", None)
            if err is None:
                err = getattr(self._inner, "_error", None)
        return getattr(err, "retry_after_s", None)


def _retry_after_of(e, detail: str) -> Optional[float]:
    """The server's suggested backoff: the exact float from the JSON body
    when present, else the integer-seconds ``Retry-After`` header."""
    try:
        return float(json.loads(detail).get("retry_after_s"))
    except (TypeError, ValueError):
        pass
    try:
        return float(e.headers.get("Retry-After"))
    except (TypeError, ValueError):
        return None


class _HttpFuture:
    """Duck-types RequestHandle for the HTTP transport: a worker thread owns
    the blocking round-trip.  ``cancel()`` is client-local best-effort (the
    server enforces the request's own deadline)."""

    def __init__(self, call: Callable[[], np.ndarray]):
        self.done = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self.quality = 1.0             # < 1.0: degraded partial combine
        self._thread = threading.Thread(target=self._run, args=(call,),
                                        daemon=True)
        self._thread.start()

    def _run(self, call):
        try:
            res = call()
            if isinstance(res, tuple):
                self._result, self.quality = res
            else:
                self._result = res
        except BaseException as e:
            self._error = e
        self.done.set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("HTTP predict timed out")
        if self._cancelled:
            raise RequestCancelled("request cancelled client-side")
        if self._error is not None:
            raise self._error
        return self._result

    def cancel(self) -> bool:
        if self.done.is_set():
            return False
        self._cancelled = True
        return True


class EnsembleClient:
    """``f(X, options) -> Y`` over either transport, with optional caching.

    Exactly one of ``system`` (an :class:`InferenceSystem`) or ``url`` (an
    HTTP v2 server, e.g. ``"http://127.0.0.1:8600"``) must be given.
    ``options`` is the default descriptor for calls that pass none; a
    per-call ``options`` object replaces it wholesale (build variants with
    ``dataclasses.replace(client.default_options, ...)``)."""

    def __init__(self, system=None, *, url: Optional[str] = None,
                 cache: Optional[PredictionCache] = None,
                 options: Optional[PredictOptions] = None,
                 http_timeout: float = 600.0):
        if (system is None) == (url is None):
            raise ValueError("construct with exactly one of system= or url=")
        self.system = system
        self.url = url.rstrip("/") if url else None
        self.cache = cache
        self.default_options = options or PredictOptions()
        self.http_timeout = http_timeout

    # ---- call styles ---------------------------------------------------------
    def predict(self, X, options: Optional[PredictOptions] = None,
                timeout: float = 600.0) -> np.ndarray:
        """Sync style: blocks until the ensemble prediction is ready (or the
        request's deadline / ``timeout`` expires)."""
        return self.predict_async(X, options).result(timeout)

    def predict_async(self, X,
                      options: Optional[PredictOptions] = None) -> ClientHandle:
        """Async-handle style: returns immediately with a future."""
        opts = options or self.default_options
        X = np.asarray(X, np.int32)
        if self.cache is None or opts.cache == "bypass" or opts.stream:
            return ClientHandle(inner=self._submit(X, opts))
        salt = self._cache_salt(opts)
        if opts.cache == "refresh":    # recompute and overwrite entries
            return ClientHandle(inner=self._submit(X, opts), X_miss=X,
                                cache=self.cache, cache_salt=salt)
        cached, miss_idx = self.cache.lookup(X, salt)
        if not miss_idx:               # every row served from cache
            return ClientHandle(Y=np.stack(cached, axis=0))
        X_miss = X[miss_idx]
        return ClientHandle(inner=self._submit(X_miss, opts), cached=cached,
                            miss_idx=miss_idx, X_miss=X_miss,
                            cache=self.cache, cache_salt=salt)

    def predict_stream(self, X, on_segment: Callable,
                       options: Optional[PredictOptions] = None) -> ClientHandle:
        """Streaming-partials style: ``on_segment(s, lo, hi, Y_seg)`` fires
        as each segment's ensemble rows complete; ``result()`` still returns
        the full prediction.  In-process transport only (segment boundaries
        are not surfaced over HTTP), and the cache is bypassed so segment
        coordinates refer to ``X`` itself."""
        if self.system is None:
            raise ValueError("predict_stream requires the in-process "
                             "transport (construct with system=)")
        opts = replace(options or self.default_options, stream=True,
                       on_segment=on_segment, cache="bypass")
        return self.predict_async(X, opts)

    def _cache_salt(self, opts: PredictOptions) -> bytes:
        """A prediction is only reusable under the same ensemble config, so
        member subsets / combine rules partition the key space.  Normalized
        so semantically identical requests share a salt: members sort to a
        set, and (in-process, where the defaults are known) the full member
        set and the system's own combine rule collapse to None."""
        members = None if opts.members is None else \
            tuple(sorted(set(opts.members)))
        combine = opts.combine
        if self.system is not None:
            if members == tuple(range(self.system.M)):
                members = None
            if combine == self.system.combine:
                combine = None
        if members is None and combine is None:
            return b""
        return repr((members, combine)).encode()

    # ---- transports ----------------------------------------------------------
    def _submit(self, X: np.ndarray, opts: PredictOptions):
        if opts.stream and self.system is None:
            raise ValueError("streaming requires the in-process transport")
        if self.system is not None:
            return self.system.predict_async(X, options=opts)
        return _HttpFuture(lambda: self._http_predict(X, opts))

    def _http_predict(self, X: np.ndarray, opts: PredictOptions) -> np.ndarray:
        payload = {"tokens": X.tolist()}
        if priority_level(opts.priority) == PRIORITY_HIGH:
            payload["priority"] = "high"
        if opts.deadline_ms is not None:
            payload["deadline_ms"] = opts.deadline_ms
        if opts.members is not None:
            payload["members"] = list(opts.members)
        if opts.combine is not None:
            payload["combine"] = opts.combine
        if opts.cache != "use":
            payload["cache"] = opts.cache   # server-side cache policy
        try:
            r = self._http_json("POST", "/v2/predict", payload)
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            if e.code == 504:
                raise DeadlineExceeded(detail) from None
            if e.code == 429:
                # refused at admission (DESIGN.md §11): typed + the
                # server's drain-estimate backoff, so callers can shed or
                # retry elsewhere immediately
                raise Overloaded(
                    detail, retry_after_s=_retry_after_of(e, detail)) \
                    from None
            if e.code == 503:
                # transient capacity failure (DESIGN.md §10): the server
                # set Retry-After — the request is retryable, not broken
                err = MemberUnavailable(detail)
                err.retry_after_s = _retry_after_of(e, detail)
                raise err from None
            raise RuntimeError(f"/v2/predict failed ({e.code}): {detail}") \
                from None
        return (np.asarray(r["predictions"], np.float32),
                float(r.get("quality", 1.0)))

    def _http_json(self, method: str, path: str, payload=None):
        req = urllib.request.Request(
            self.url + path,
            data=None if payload is None else json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method=method)
        with urllib.request.urlopen(req, timeout=self.http_timeout) as resp:
            return json.load(resp)

    # ---- observability -------------------------------------------------------
    def metrics(self) -> dict:
        """Serving counters/gauges (+ cache hit rates), whichever transport."""
        if self.system is not None:
            # same shape as the server's GET /metrics, so code written
            # against one transport reads the other
            ctl = self.system.controller
            return {"counters": self.system.serving_counters(),
                    "gauges": self.system.serving_gauges(),
                    "latency": self.system.latency_snapshot(),
                    "stages": self.system.stage_timings(),
                    "cache": ({"hits": self.cache.hits,
                               "misses": self.cache.misses}
                              if self.cache is not None else None),
                    "controller": ctl.stats() if ctl is not None else None}
        return self._http_json("GET", "/metrics")

    def dump_trace(self, path: Optional[str] = None) -> dict:
        """Chrome-trace / Perfetto JSON of the flight recorder (DESIGN.md
        §13), whichever transport (in-process ``system.tracer.export()`` or
        ``GET /v2/trace``).  With ``path`` the JSON is also written to disk
        — open it at https://ui.perfetto.dev or chrome://tracing."""
        if self.system is not None:
            trace = self.system.tracer.export()
        else:
            trace = self._http_json("GET", "/v2/trace")
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace
