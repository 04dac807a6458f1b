"""The end-to-end arithmetic: a rate over the whole window, percentiles
over every request, and a stall inside the window that moves both."""
import heapq
import math
from types import SimpleNamespace

import pytest

from harness import cell, stats, traffic


def _requests(done_times, rows=16, due=None):
    out = []
    for i, d in enumerate(done_times):
        r = traffic.Request(idx=i, rows=rows, X=None,
                            due=d - 0.5 if due is None else due[i])
        r.done = d
        out.append(r)
    return out


def _ctx(reqs, t0=0.0, t1=30.0):
    done = [r for r in reqs if r.ok]
    return SimpleNamespace(
        requests=reqs, t0=t0, t1=t1, stats=stats, rows_per_s=(
            stats.completion_rate([r.due for r in done],
                                  [r.done for r in done],
                                  [r.rows for r in done], t0, t1)))


def _closed_loop(stall=None, start=-20.0, clients=8, service=0.5):
    """A closed loop of ``clients`` callers of 16 rows in front of one
    server that answers in turn, ``service`` s a request (32 rows/s), and
    answers nothing from ``stall[0]`` to ``stall[1]``."""
    free, sends, out = start, [(start, c) for c in range(clients)], []
    heapq.heapify(sends)
    while sends:
        t, c = heapq.heappop(sends)
        if t >= 60.0:
            continue
        begin = max(t, free)
        if stall and begin < stall[1] and begin + service > stall[0]:
            begin = stall[1]
        free = begin + service
        r = traffic.Request(idx=len(out), rows=16, X=None, due=t, sent=t)
        r.done = free
        out.append(r)
        heapq.heappush(sends, (free, c))
    return out


def test_percentile_is_linear_between_order_statistics():
    v = [float(x) for x in range(1, 101)]
    assert stats.percentile(v, 50) == pytest.approx(50.5)
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(v + [math.inf], 50) == pytest.approx(51.0)
    assert stats.percentile([1.0, math.inf], 95) == math.inf


def test_rate_covers_the_whole_window():
    # 32 rows/s whatever the phase at which requests cross the window's
    # edges
    for phase in (0.0, 0.1, 0.37, 0.5):
        reqs = _closed_loop(start=-20.0 + phase)
        assert cell.reader("rows_per_s")(_ctx(reqs)) == pytest.approx(32.0)
    # requests wholly outside the window do not count, one inside counts
    # whole, one across an edge for its share inside
    reqs = _requests([-1.0, 1.0, 29.0, 31.0, 40.0], rows=8,
                     due=[-3.0, 0.5, 28.0, 29.0, 31.0])
    assert cell.reader("rows_per_s")(_ctx(reqs)) == pytest.approx(
        (8 + 8 + 8 / 2) / 30)


@pytest.mark.parametrize("stall", [(-3.0, 4.0), (26.0, 40.0), (27.0, 30.0)],
                         ids=["slow_first", "stall_past_t1", "stall_to_t1"])
def test_time_with_no_answer_at_an_edge_lowers_the_rate(stall):
    """Nothing answered from stall[0] to stall[1]: at the window's start
    (the first answer comes 4 s late), across its close (answers resume
    after it) or up to it: the rate drops by about the stall's share of
    the window (less where the callers' waits across the close are
    credited for their part inside)."""
    lost = min(stall[1], 30.0) - max(stall[0], 0.0)
    hit = cell.reader("rows_per_s")(_ctx(_closed_loop(stall)))
    assert 32.0 * (30.0 - lost) / 30.0 - 1.0 <= hit < \
        32.0 * (1 - 0.5 * lost / 30.0)


def test_a_stall_moves_rate_and_tail():
    steady = _closed_loop()
    # the same loop, with a 5 s stall in the middle of the window
    stalled = _closed_loop((12.0, 17.0))
    assert cell.reader("rows_per_s")(_ctx(stalled)) < \
        0.9 * cell.reader("rows_per_s")(_ctx(steady))
    # an open mix: requests due every 0.5 s, served in 0.2 s, except those
    # due during a 3 s stall, which wait for its end
    due = [0.5 * k for k in range(60)]
    done = [d + 0.2 for d in due]
    wait = [max(d, 10.0) + 0.2 if 7.0 <= d < 10.0 else d + 0.2 for d in due]
    base = _ctx(_requests(done, due=due))
    hit = _ctx(_requests(wait, due=due))
    p95 = cell.reader("latency_p95_ms")
    p50 = cell.reader("latency_p50_ms")
    assert p95(base) == pytest.approx(200.0)
    assert p95(hit) > 1000.0
    assert p50(hit) == pytest.approx(p50(base))
    # a request that never came back counts as the slowest
    failed = _requests(done, due=due)
    failed[3].done = None
    failed[4].error = "TimeoutError"
    assert p95(_ctx(failed)) == pytest.approx(200.0)
    for r in failed[5:10]:
        r.error = "TimeoutError"
    assert p95(_ctx(failed)) == math.inf

