"""The accumulator's resolution races in the PyTorch port, ported from
tests/test_accumulator_races.py.

Race coverage for PredictionAccumulator completion: ``fail()`` /
``cancel()`` racing normal completion must resolve each request exactly
once — one ``on_complete`` call (the in-flight window is a
BoundedSemaphore: a double release raises), one error-or-result, stale
messages and stale handles ignored."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving.accumulator import PredictionAccumulator  # noqa: E402
from repro_torch.serving.segments import (Message, Request,  # noqa: E402
                                          RequestCancelled, WorkerCrashed)

C = 4


def make_req(rid, n=8, seg=4, members=(0, 1)):
    return Request(rid=rid, x=np.zeros((n, 4), np.int32), n=n,
                   num_classes=C, segment_size=seg, members=list(members),
                   weights={m: 1.0 / len(members) for m in members})


def data_messages(req):
    """Every per-member message the pipeline would produce for ``req``."""
    out = []
    for s in range(req.num_segments()):
        lo, hi = req.bounds(s)
        for m in req.members:
            out.append(Message(s, m, np.ones((hi - lo, C), np.float32),
                               rid=req.rid))
    return out


class Harness:
    """Accumulator + the system's semantics around it: one bounded
    in-flight slot released by on_complete (double release raises)."""

    def __init__(self):
        self.q = __import__("queue").Queue()
        self.completions = []
        self.release_errors = []
        self.sem = threading.BoundedSemaphore(1)
        self.acc = PredictionAccumulator(self.q, 2,
                                         on_complete=self._on_complete)
        self.acc.start()

    def _on_complete(self, handle):
        self.completions.append(handle.req.rid)
        try:
            self.sem.release()
        except ValueError as e:           # double release: the bug we hunt
            self.release_errors.append(e)

    def begin(self, req):
        self.sem.acquire()
        return self.acc.begin(req)

    def stop(self):
        self.acc.stop()


@pytest.mark.parametrize("resolver", ["fail", "cancel"])
def test_resolution_races_completion_exactly_once(resolver):
    """fail()/cancel() from one thread racing the full message stream from
    another: whatever wins, the handle resolves exactly once and the
    in-flight slot releases exactly once."""
    h = Harness()
    try:
        for rid in range(120):
            req = make_req(rid)
            handle = h.begin(req)
            barrier = threading.Barrier(2)

            def feed():
                barrier.wait()
                for msg in data_messages(req):
                    h.q.put(msg)

            def resolve():
                barrier.wait()
                if resolver == "fail":
                    h.acc.fail(req.rid, WorkerCrashed("boom"))
                else:
                    handle.cancel()

            ts = [threading.Thread(target=feed),
                  threading.Thread(target=resolve)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert handle.done.wait(10.0)
            # exactly one resolution: either the error won or the fold won
            if handle.error is not None:
                exc = WorkerCrashed if resolver == "fail" else RequestCancelled
                assert isinstance(handle.error, exc)
            else:
                assert handle.remaining == 0
                np.testing.assert_allclose(handle.Y, np.ones((8, C)))
            assert handle._finished
        # drain: every rid completed exactly once, no double release
        assert sorted(h.completions) == list(range(120))
        assert h.release_errors == []
        assert h.acc._requests == {}
    finally:
        h.stop()


def test_cancel_then_stragglers_are_stale():
    """Messages that arrive after cancel() resolve nothing, fold nothing,
    and never re-fire on_complete."""
    h = Harness()
    try:
        req = make_req(0)
        handle = h.begin(req)
        assert handle.cancel() is True
        assert handle.cancel() is False       # already resolved
        assert req.dropped()                  # batchers will skip its rows
        with pytest.raises(RequestCancelled):
            handle.result(5.0)
        for msg in data_messages(req):        # stragglers from the pipeline
            h.q.put(msg)
        probe = make_req(99)                  # flush the loop behind a probe
        ph = h.begin(probe)
        for msg in data_messages(probe):
            h.q.put(msg)
        ph.result(10.0)
        assert h.completions == [0, 99]       # each exactly once
        assert not np.any(handle.Y)           # nothing folded after cancel
        assert h.release_errors == []
    finally:
        h.stop()


def test_fail_unknown_rid_is_noop():
    h = Harness()
    try:
        assert h.acc.fail(12345, WorkerCrashed("ghost")) is False
        req = make_req(1)
        handle = h.begin(req)
        for msg in data_messages(req):
            h.q.put(msg)
        handle.result(10.0)
        # late fail on a completed request: stale handle, no effect
        assert h.acc.fail(req.rid, WorkerCrashed("late")) is False
        assert handle.error is None
        assert h.completions == [1] and h.release_errors == []
    finally:
        h.stop()


def test_fail_before_any_rows_then_full_stream():
    """fail() before the first message: the whole stream is stale."""
    h = Harness()
    try:
        req = make_req(2)
        handle = h.begin(req)
        assert h.acc.fail(req.rid, WorkerCrashed("early")) is True
        for msg in data_messages(req):
            h.q.put(msg)
        with pytest.raises(WorkerCrashed):
            handle.result(5.0)
        probe = make_req(3)                   # flush the loop behind a probe
        ph = h.begin(probe)
        for msg in data_messages(probe):
            h.q.put(msg)
        ph.result(10.0)
        assert handle.messages == 0           # nothing folded
        assert h.completions == [2, 3] and h.release_errors == []
    finally:
        h.stop()


def test_concurrent_fail_and_cancel_single_winner():
    """cancel() and fail() racing each other (no data at all): one wins,
    one resolution, one release."""
    h = Harness()
    try:
        for rid in range(100):
            req = make_req(rid)
            handle = h.begin(req)
            barrier = threading.Barrier(2)

            def do_cancel():
                barrier.wait()
                handle.cancel()

            def do_fail():
                barrier.wait()
                h.acc.fail(req.rid, WorkerCrashed("boom"))

            ts = [threading.Thread(target=do_cancel),
                  threading.Thread(target=do_fail)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert handle.done.wait(5.0)
            assert isinstance(handle.error, (RequestCancelled, WorkerCrashed))
        assert len(h.completions) == 100
        assert h.release_errors == []
    finally:
        h.stop()
