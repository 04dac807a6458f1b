"""The traffic generator: deterministic for a seed, the same work for
every seed, and the open mix's sizes and gaps as specified."""
import numpy as np
import pytest

import json

from harness import traffic
from servebench_fixtures import ROOT

OPEN = traffic.arrival("open")
SPEC = {"kind": "open", "rate_rps": 6.0, "rows_min": 1, "rows_max": 32,
        "rows_alpha": 1.5, "order_seed": 5}
BIG = 2 ** 31 + 12345


def test_tokens_follow_the_seed():
    a = traffic.tokens(BIG, 3, 7, 4, 16, 50280)
    assert a.dtype == np.int32 and a.shape == (4, 16)
    assert np.array_equal(a, traffic.tokens(BIG, 3, 7, 4, 16, 50280))
    assert not np.array_equal(a, traffic.tokens(BIG + 1, 3, 7, 4, 16, 50280))
    assert not np.array_equal(a, traffic.tokens(BIG, 3, 8, 4, 16, 50280))
    assert a.min() >= 0 and a.max() < 50280
    traffic.tokens(-5, 0, 0, 1, 4, 10)          # any whole number is a seed


def test_open_schedule_is_the_mixs_one_order():
    d1, s1 = OPEN.schedule(SPEC, 40.0)
    d2, s2 = OPEN.schedule(dict(SPEC), 40.0)
    assert np.array_equal(d1, d2) and np.array_equal(s1, s2)
    assert len(d1) == 240 and d1[0] == 0 and d1[-1] < 40.0
    # another order_seed: the same set of sizes, in another order
    d3, s3 = OPEN.schedule(dict(SPEC, order_seed=6), 40.0)
    assert sorted(s1) == sorted(s3) and not np.array_equal(s1, s3)


def test_open_sizes_are_the_heavy_tailed_mix():
    sizes = OPEN.size_quantiles(20000, 1, 32, 1.5)
    assert sizes.min() == 1 and sizes.max() == 32
    assert np.mean(sizes) == pytest.approx(4.40, abs=0.05)
    assert np.mean(sizes <= 2) == pytest.approx(0.60, abs=0.01)
    assert np.mean(sizes > 16) == pytest.approx(0.063, abs=0.005)


def test_open_gaps_are_poisson():
    due, _ = OPEN.schedule(SPEC, 2000.0)
    gaps = np.diff(due)
    assert gaps.mean() == pytest.approx(1 / 6.0, rel=0.01)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.03)
    # exponential: P(gap > mean) = 1/e
    assert np.mean(gaps > gaps.mean()) == pytest.approx(np.exp(-1), abs=0.01)
    # the order is a shuffle: no trend from the window's start to its end
    half = len(gaps) // 2
    assert gaps[:half].mean() == pytest.approx(gaps[half:].mean(), rel=0.1)


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (ROOT / "servebench" / "traffic").glob("*.json")))
def test_each_mix_names_an_arrival_process(mix):
    spec = json.loads((ROOT / "servebench" / "traffic" / f"{mix}.json")
                      .read_text())
    assert callable(traffic.arrival(spec["kind"]).run)


def test_an_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="unknown traffic kind"):
        traffic.arrival("bursty")
