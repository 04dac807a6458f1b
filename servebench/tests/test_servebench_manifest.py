"""BENCHMARK.json against the benchmark's contract: names, units and
lengths, the files each entry names, and which metrics each cell reports."""
import json
import re

import pytest

from harness import cell, family
from servebench_fixtures import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "servebench"


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(_line(w) for w in MANIFEST["command"])
    t = MANIFEST["run_seconds"]
    assert isinstance(t, int) and 1 <= t <= 51
    # a full check of 24 cells fits its allowance
    assert (2 + 14 * 24) * (t + 60) + 24 * 180 + 1200 <= 43200


def test_entries():
    cfgs = {c["name"]: c for c in MANIFEST["configs"]}
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for group in (cfgs, cells, {m["name"]: m for m in metrics}):
        assert all(NAME.match(n) for n in group)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in cfgs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("servebench/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    assert len({c["file"] for c in cfgs.values()}) == len(cfgs)
    assert {w["config"] for w in cells.values()} == set(cfgs)
    pairs = set()
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(cells)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert cell.reader_path(m["name"]).is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def _reports(cell, entries):
    return {m["name"] for m in entries
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e = _reports(cell, MANIFEST["end_to_end"])
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in MANIFEST["per_layer"]
             if cell in m.get("workloads", [cell])]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], cell)
    # a layer's name is the same letter for letter wherever it appears
    by_layer = {}
    for m in MANIFEST["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("config", sorted(
    p.stem for p in (ROOT / "servebench" / "configs").glob("*.json")))
def test_each_configuration_names_its_family_module(config):
    cfg = cell.load_config(config)
    assert NAME.match(cfg["reference"])
    assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    mod = family.module(cfg)
    assert all(callable(getattr(mod, f)) for f in family.FUNCTIONS)
    assert set(family.FUNCTIONS) == {"layer_shapes", "layer_flops",
                                     "combined"}
