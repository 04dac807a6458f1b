#!/usr/bin/env python3
"""Device times of the decode kernel's ring depth and split counts.

    python3 tools/decode_variants.py

Builds ``csrc/decode_attention.cu`` twice into libraries of their own, as
it is (a ring of two stages) and with three stages, and times each C entry
at qwen3's last decode step (1088 valid slots of 2048) and hymba's full
window ring with the splits sized for one wave of 2, 3, 4, 6, 8 and 16
blocks per SM (the wrapper sizes them for the blocks that fit an SM), by ``chip_smoke.py``'s ``device_ms`` (20 calls in a CUDA
graph), inputs from a fixed seed.  Each result is held against the plain
version first.  Prints the card's name and power limit and one JSON line
per (variant, shape, blocks per SM).  Needs a CUDA card and the CUDA
toolkit.
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

STAGES = "constexpr int kStages = 2;"
VARIANTS = {"two_stages": None, "three_stages": "constexpr int kStages = 3;"}
BLOCKS_PER_SM = (2, 3, 4, 6, 8, 16)


def build(work: Path) -> dict:
    """One library per variant, built in parallel; {name: path}."""
    from repro_torch.kernels import _build
    procs = {}
    for name, stages in VARIANTS.items():
        d = work / name
        d.mkdir()
        shutil.copy(CSRC / "tf32_mma.cuh", d)
        text = (CSRC / "decode_attention.cu").read_text()
        if stages is not None:
            if STAGES not in text:
                raise SystemExit(f"decode_variants.py: {STAGES!r} not in "
                                 f"the source")
            text = text.replace(STAGES, stages)
        (d / "decode_attention.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", "-o", str(d / "lib.so"),
               str(d / "decode_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"decode_variants.py: nvcc failed on {name}:"
                             f"\n{out}")
    return {name: work / name / "lib.so" for name in VARIANTS}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_variants.py: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (DECODE_TIMED, close, decode_inputs, decode_valid,
                            device_ms, smi_line)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(smi_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        for (b, L, h, kv, hd), kind in DECODE_TIMED:
            qs, k, v = decode_inputs(torch, gen, dev, b, L, h, kv, hd,
                                     torch.float32)
            valid = decode_valid(torch, kind, L, gen, dev)
            want = ref.decode_attention_ref(qs, k, v, valid, scale=1.0)
            out = torch.empty_like(qs)
            for name, path in libs.items():
                fn = ctypes.CDLL(str(path)).repro_decode_attention
                fn.argtypes = da._ARGS
                for bps in BLOCKS_PER_SM:
                    gb, tps, nsplit = da.split_plan(b, L, h, kv, hd, sms,
                                                    blocks_per_sm=bps)
                    n = b * h * nsplit
                    part = torch.empty(n * (hd + 2), device=dev)
                    ptr = part.data_ptr()

                    def call(fn=fn, gb=gb, tps=tps, nsplit=nsplit, ptr=ptr,
                             n=n):
                        err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 valid.data_ptr(), ptr, ptr + 4 * n,
                                 ptr + 8 * n, out.data_ptr(), b, L, h, kv,
                                 hd, gb, tps, nsplit, 0,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")
                    call()
                    torch.cuda.synchronize()
                    err = close(torch, out, want, 2e-5)
                    print(json.dumps({
                        "variant": name, "shape": [b, L, h, kv, hd],
                        "valid": kind, "blocks_per_sm": bps,
                        "splits": nsplit, "ms": device_ms(torch, call),
                        "max_abs_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
