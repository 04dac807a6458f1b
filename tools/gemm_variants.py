#!/usr/bin/env python3
"""Device times of source variants of the 3xTF32 GEMM (``csrc/gemm_tf32x3.cu``).

    python3 tools/gemm_variants.py [--only name,name]

Copies ``gemm_tf32x3.cu`` and its headers into a temporary directory once
per variant, edits the copy (the main loop lies in ``wgmma_tf32.cuh``), builds each with ``nvcc`` (all at once) into a
library of its own, and times its C entry at mamba2-1.3b's four served
projection shapes (``chip_smoke.GEMM_SHAPES``) with ``chip_smoke.py``'s
``device_ms`` (20 calls in a CUDA graph), beside cuBLAS f32, with the
largest error against the float64 product of each.  Prints one JSON line
per (variant, shape) and the card's name and power limit.  Variants:

- ``as_built``: the source as it is;
- ``lockstep``: the stage's barrier after each warpgroup's wait and sum
  into f32, so that both warpgroups drain the tensor cores together;
- ``one_pass``: the hi·hi product alone (one TF32 pass: a third of the
  tensor-core work, and its error);
- ``no_promotion``: one accumulator over the whole of K on the tensor
  cores, no f32 sum a stage (the error that made the design sum a stage
  at a time);
- ``copies_before_fence``: each stage's copies issued before the split's
  proxy fence, whose memory barrier then waits for them to land;
- ``ahead_2``: copies two stages ahead, not three.

Probes, for time alone (their answers are wrong, and their errors are
printed as they come): ``probe_no_split`` skips the split of x into hi/lo
tiles after the first stage, ``probe_no_copies`` every copy after the
first three stages.  (A probe that drops the stage's add into f32 times
nothing: with the sum's result unread, ptxas drops wgmmas.)

Needs a CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
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

SUM = "    for (int i = 0; i < 64; ++i) acc[i] += part[i];\n"
THREE = ("      wgmma_n128(part, al[j], dh, j > 0);  // the stage's sum starts "
         "afresh\n      wgmma_n128(part, ah[j], dl, 1);\n"
         "      wgmma_n128(part, ah[j], dh, 1);\n")
# (old, new) edits of each variant's copy of gemm_tf32x3.cu or, where the
# text lies there, of wgmma_tf32.cuh
TAIL = ("    cp_async_wait_group<kAhead - 2>();    // stage kt+1 has landed\n"
        "    if (kt + 1 < stages) split_x(kt + 1);\n"
        "    fence_proxy_async();\n"
        "    load(kt + kAhead);\n")
VARIANTS = {
    "as_built": [],
    "lockstep": [("    __syncthreads();\n    wgmma_wait_all();",
                  "    wgmma_wait_all();"),
                 (SUM, SUM + "    __syncthreads();\n")],
    "one_pass": [(THREE, "      wgmma_n128(part, ah[j], dh, j > 0);\n")],
    "no_promotion": [("wgmma_n128(part, al[j], dh, j > 0)",
                      "wgmma_n128(part, al[j], dh, 1)"),
                     (SUM, "    for (int i = 0; i < 64; ++i) acc[i] = "
                           "part[i];\n"),
                     ("for (int i = 0; i < 64; ++i) acc[i] = 0.f;",
                      "for (int i = 0; i < 64; ++i) acc[i] = part[i] = "
                      "0.f;")],
    "copies_before_fence": [(TAIL, "    load(kt + kAhead);\n"
                             "    cp_async_wait_group<kAhead - 1>();\n"
                             "    if (kt + 1 < stages) split_x(kt + 1);\n"
                             "    fence_proxy_async();\n")],
    "ahead_2": [("constexpr int kAhead = 3;", "constexpr int kAhead = 2;")],
    "probe_no_split": [("    if (kt + 1 < stages) split_x(kt + 1);\n", "")],
    "probe_no_copies": [("    load(kt + kAhead);\n", "    cp_async_commit();\n")],
}


def build(work: Path, names) -> dict:
    """One library per variant, built in parallel; {name: path}."""
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        d = work / name
        d.mkdir()
        for f in ("gemm_tf32x3.cu", "wgmma_tf32.cuh", "tf32_mma.cuh"):
            shutil.copy(CSRC / f, d)
        src = d / "gemm_tf32x3.cu"
        for old, new in VARIANTS[name]:
            for f in (src, d / "wgmma_tf32.cuh"):
                text = f.read_text()
                if old in text:
                    f.write_text(text.replace(old, new))
                    break
            else:
                raise SystemExit(f"gemm_variants.py: {name}: {old!r} not in "
                                 f"gemm_tf32x3.cu or wgmma_tf32.cuh")
        cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
               str(d / "lib.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"gemm_variants.py: nvcc failed on {name}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln
                or "spill" in ln or "serialized" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    return {name: work / name / "lib.so" for name in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    import torch
    if not torch.cuda.is_available():
        print("gemm_variants.py: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import GEMM_SHAPES, device_ms, gemm_inputs, smi_line
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(smi_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), names)
        fns = {}
        for name, path in libs.items():
            fn = ctypes.CDLL(str(path)).repro_gemm_tf32x3
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fns[name] = fn
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        for m, k, n in GEMM_SHAPES:
            x, w = gemm_inputs(torch, gen, dev, m, k, n)
            out = torch.empty((m, n), device=dev)
            want = x.double() @ w.double()
            lib_err = ((x @ w).double() - want).abs().max().item()
            row = {"shape": [m, k, n],
                   "library_ms": device_ms(torch, lambda: x @ w),
                   "library_max_abs_err_vs_f64": lib_err,
                   "bound_ms": 3 * 2.0 * m * k * n / 495e12 * 1e3}
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k,
                             n, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                call()
                err = (out.double() - want).abs().max().item()
                print(json.dumps({"variant": name, **row,
                                  "ms": device_ms(torch, call),
                                  "max_abs_err_vs_f64": err}), flush=True)
            del x, w, out, want
    print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
