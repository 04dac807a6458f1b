"""The benchmark's own tests: on the CPU, at reduced sizes."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


from servebench_fixtures import (  # noqa: E402
    CLOSED, LEFT_OUT, OPEN, reduce_cfg)


@pytest.fixture
def reduced_spec():
    """``make(workload, open=False)``: the cell's spec at CPU size, with a
    small closed or open mix."""
    from harness import cell

    def make(workload: str, open_mix: bool = False) -> dict:
        if workload in LEFT_OUT:
            config, listed = LEFT_OUT[workload]
            spec = cell.load_spec(listed)
            spec["cfg"] = cell.load_config(config)
        else:
            spec = cell.load_spec(workload)
        spec["cfg"] = reduce_cfg(spec["cfg"])
        spec["traffic"] = dict(OPEN if open_mix else CLOSED)
        return spec
    return make
