"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program under test."""
import json
import os
import subprocess
import sys

from servebench_fixtures import ROOT

BENCH = ROOT / "servebench"
PROBE = r"""
import glob, importlib.util, json, os, sys
sys.path[:0] = [{bench!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = PROBE.format(bench=str(BENCH), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _loaded(
        "spec = importlib.util.spec_from_file_location('sb_run', "
        f"{str(BENCH / 'run.py')!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "run._environment()\n"
        "from harness import cell, check, devtrace, family, stats, traffic\n"
        "from harness import weights, work\n"
        "for f in glob.glob(os.path.join("
        f"{str(BENCH / 'configs')!r}, '*.json')):\n"
        "    family.module(json.load(open(f)))\n"
        "import calibrate, sweep\n"
        "cell.port_models(cell.load_spec('mamba2-pair.bulk')['cfg'])\n"
        "from repro_torch.serving import InferenceSystem\n"
        "for f in glob.glob(os.path.join("
        f"{str(BENCH / 'metrics')!r}, '*.py')):\n"
        "    cell.reader(os.path.basename(f)[:-3])\n"
        "for f in glob.glob(os.path.join("
        f"{str(BENCH / 'arrivals')!r}, '*.py')):\n"
        "    traffic.arrival(os.path.basename(f)[:-3])\n")
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    assert "repro_torch" in names


def test_reference_loads_nothing_of_the_program():
    """Each family module under ``servebench/reference/``, alone."""
    modules = sorted(p.stem for p in (BENCH / "reference").glob("*.py")
                     if p.stem != "__init__")
    assert "model" in modules
    for module in modules:
        names = _loaded(f"import reference.{module}")
        assert "torch" in names
        assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                            "harness"}, (module, names)
