#!/usr/bin/env python3
"""Device times of source variants of the scan kernel (``csrc/ssd_scan.cu``).

    python3 tools/ssd_variants.py

Copies ``ssd_scan.cu`` and its header into a temporary directory once per
variant, edits the copy, builds each with ``nvcc`` (all at once) into a
library of its own, and times its C entry at the mamba2 and hymba serving
shapes with ``chip_smoke.py``'s ``device_ms`` (20 calls in a CUDA graph)
and its largest error against a float64 scan, inputs from a fixed seed.
Prints one JSON line per (variant, shape) and the card's name and power
limit.  Variants:

- ``as_built``: the source as it is;
- ``tensor_cores_small_state``: the tensor-core route also for a state
  under 32 (it runs at hymba's N 16), the attempt the CUDA-core route beat;
- ``one_stage``: the cp.async ring cut to one stage;
- ``lo_rounded``: the low TF32 part of the split rounded, not truncated;
- ``four_pass``: the fourth product lo·lo added to the 3xTF32 three;
- ``lo_rounded_four_pass``: both;
- ``fadd_steps``: each step's three products summed from zero on the
  tensor cores and added to the accumulator by an f32 add.

Needs a CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
sys.path.insert(0, str(ROOT))

LO_TRUNC = "  lo = __float_as_uint(x - __uint_as_float(hi));"
LO_RNA = ("  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & "
          "0xffffe000u;")
THREE = "  mma(c, al, bh0, bh1);"
FOUR = "  mma(c, al, bl0, bl1);\n" + THREE
# (file, old, new) edits of each variant's copy
VARIANTS = {
    "as_built": [],
    "tensor_cores_small_state": [("ssd_scan.cu", "p.tc = n8 >= 32;",
                                  "p.tc = 1;")],
    "one_stage": [("ssd_scan.cu",
                   "p.stages = 4 * (2 * p.stage + cs) <= kMaxSmem ? 2",
                   "p.stages = false ? 2")],
    "lo_rounded": [("tf32_mma.cuh", LO_TRUNC, LO_RNA)],
    "four_pass": [("tf32_mma.cuh", THREE, FOUR)],
    "lo_rounded_four_pass": [("tf32_mma.cuh", LO_TRUNC, LO_RNA),
                             ("tf32_mma.cuh", THREE, FOUR)],
    "fadd_steps": [("tf32_mma.cuh", THREE + "\n  mma(c, ah, bl0, bl1);\n"
                    "  mma(d, ah, bh0, bh1);",
                    "  float s[4] = {0.f, 0.f, 0.f, 0.f};\n"
                    "  mma(s, al, bh0, bh1);\n  mma(s, ah, bl0, bl1);\n"
                    "  mma(s, ah, bh0, bh1);\n"
                    "  for (int e = 0; e < 4; ++e) d[e] += s[e];")],
}


def build(work: Path) -> dict:
    """One library per variant, built in parallel; {name: path}."""
    from repro_torch.kernels import _build
    procs = {}
    for name, edits in VARIANTS.items():
        d = work / name
        d.mkdir()
        for f in ("ssd_scan.cu", "tf32_mma.cuh"):
            shutil.copy(CSRC / f, d)
        for f, old, new in edits:
            text = (d / f).read_text()
            if old not in text:
                raise SystemExit(f"ssd_variants.py: {name}: {old!r} not in "
                                 f"{f}")
            (d / f).write_text(text.replace(old, new))
        cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", "-o", str(d / "lib.so"),
               str(d / "ssd_scan.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"ssd_variants.py: nvcc failed on {name}:\n{out}")
    return {name: work / name / "lib.so" for name in VARIANTS}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_variants.py: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (HYMBA_SSD, MAIN_SSD, device_ms, smi_line,
                            ssd_inputs)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(smi_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        for shape in (MAIN_SSD, HYMBA_SSD):
            b, s, h, p, n, chunk = shape
            x, dt, A, bm, cm = ssd_inputs(torch, gen, dev, b, s, h, p, n)
            y = torch.empty_like(x)
            scores = torch.empty(b * -(-s // chunk) * chunk * (chunk + h),
                                 device=dev)
            ptrs = [t.data_ptr() for t in (x, dt, A, bm, cm, scores, y)]
            want = ref.ssd_scan_ref(*(t.double() for t in (x, dt, A, bm, cm)),
                                    chunk=chunk)
            for name, path in libs.items():
                fn = ctypes.CDLL(str(path)).repro_ssd_scan
                fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
                               [ctypes.c_void_p])

                def call(fn=fn):
                    err = fn(*ptrs, b, s, h, p, n, chunk,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                call()
                err = (y.double() - want).abs().max().item()
                print(json.dumps({"variant": name, "shape": list(shape),
                                  "ms": device_ms(torch, call),
                                  "max_abs_err_vs_f64": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
