"""The PyTorch port imports neither JAX nor anything of the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)",
                     re.MULTILINE)


def _modules():
    out = []
    for p in PKG.rglob("*.py"):
        parts = ("repro_torch",) + p.relative_to(PKG).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(out)


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for m in ("repro_torch.serving.system", "repro_torch.models.ssm",
              "repro_torch.kernels.ssd_scan", "repro_torch.models.cache",
              "repro_torch.kernels.decode_attention",
              "repro_torch.models.moe", "repro_torch.core.memory",
              "repro_torch.core.worst_fit", "repro_torch.core.greedy",
              "repro_torch.core.bench", "repro_torch.core.optimizer",
              "repro_torch.core.bbs", "repro_torch.serving.client",
              "repro_torch.serving.server", "repro_torch.serving.request_cache",
              "repro_torch.serving.trace", "repro_torch.serving.control",
              "repro_torch.serving.control.controller",
              "repro_torch.serving.control.livebench",
              "repro_torch.serving.control.overload",
              "repro_torch.serving.control.stealing",
              "repro_torch.serving.control.supervisor",
              "repro_torch.launch", "repro_torch.launch.serve"):
        assert m in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['repro'] = None\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_name_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not offenders, offenders


def test_the_card_is_never_replaced_by_the_cpu():
    from repro_torch.core import cuda_devices
    if torch.cuda.is_available():
        assert cuda_devices()[0].torch_device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        cuda_devices()


def test_cells_and_the_launcher_refuse_to_run_without_a_card(tmp_path):
    from repro_torch.core import cuda_cells
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        cuda_cells(2)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--bench",
         "analytic", "--members", "1", "--port", "0", "--duration", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode != 0 and "serving" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
