"""Roofline analysis: three terms per (arch x shape x mesh), from the
dry-run records in ``experiments/dryrun_torch/`` (the JAX package's
``launch/roofline.py``, with the H100's constants).

    compute term    = FLOPs per rank / peak FLOP/s
    memory term     = bytes accessed per rank / HBM bandwidth
    collective term = collective wire bytes per rank / link bandwidth

FLOPs and bytes are the dry-run's counts of the ops one rank runs
(``launch/hlo_analysis.py``): PyTorch's counts, not XLA's.  Collective bytes
are that rank's collective outputs, all-reduce weighted 2x (reduce-scatter
+ all-gather on the wire).  The constants are one NVIDIA H100 SXM5's, from
its data sheet: 989.4 TFLOP/s dense bf16 (the dry-run's params are bf16),
3.35 TB/s HBM3, 450 GB/s NVLink per direction.  They assume the card's full
700 W power limit.

Usage:
    python -m repro_torch.launch.roofline                  # every record
    python -m repro_torch.launch.roofline --mesh single --markdown
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.configs import INPUT_SHAPES, get_config

PEAK_FLOPS = 989.4e12        # bf16 dense / card (H100 SXM5 data sheet)
HBM_BW = 3.35e12             # bytes/s / card (HBM3)
LINK_BW = 450e9              # bytes/s / card, NVLink, one direction

# wire-traffic weight per collective type (ring algorithms, large N)
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "broadcast": 1.0}

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")


def model_flops(arch: str, shape: str) -> float:
    """Analytic MODEL_FLOPS: 6*N*D (train) / 2*N_active*D + attention
    (serve)."""
    cfg = get_config(arch)
    sh = INPUT_SHAPES[shape]
    b, s, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    if kind == "train":
        return 3.0 * cfg.flops_per_token(s) * b * s      # fwd+bwd = 3x fwd
    if kind == "prefill":
        return float(cfg.flops_per_token(s)) * b * s
    return float(cfg.flops_per_token(s)) * b             # decode: 1 tok/sample


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float          # the traced FLOPs of all ranks
    useful_ratio: float
    note: str
    variant: str = "baseline"

    def as_dict(self):
        return self.__dict__.copy()


def analyze_record(rec: dict) -> Optional[RooflineRow]:
    if not rec.get("ok"):
        return None
    chips = 1
    for v in rec["mesh_shape"].values():
        chips *= v
    flops = rec.get("flops_per_rank", 0.0)
    compute_s = flops / PEAK_FLOPS
    memory_s = rec.get("bytes_accessed_per_rank", 0.0) / HBM_BW
    coll = rec.get("collectives", {}).get("bytes", {})
    wire = sum(v * _WIRE_FACTOR.get(k, 1.0) for k, v in coll.items())
    collective_s = wire / LINK_BW          # bytes already per rank
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    total = flops * chips
    ratio = mf / total if total else 0.0
    return RooflineRow(rec["arch"], rec["shape"], rec["mesh"], chips,
                       compute_s, memory_s, collective_s, dominant, mf,
                       total, ratio, _note(rec, dominant, ratio),
                       variant=rec.get("variant", "baseline"))


def _note(rec: dict, dominant: str, ratio: float) -> str:
    coll = rec.get("collectives", {}).get("bytes", {})
    biggest_coll = max(coll, key=coll.get) if coll else "none"
    if dominant == "collective":
        return (f"dominated by {biggest_coll}; reshard to cut it "
                f"(e.g. keep activations model-sharded through the stack)")
    if dominant == "memory":
        if rec["shape"].startswith(("decode", "long")):
            return ("KV/state streaming bound; fuse cache read+attend "
                    "(decode kernel) or quantize cache to int8")
        return "activation traffic bound; fuse ops / remat less"
    if ratio < 0.5:
        return ("compute-bound but the ranks run >2x model FLOPs; cut "
                "replicated work, remat recompute or f32 upcasts")
    return "compute-bound near useful-FLOPs roofline; scale batch or chips"


def load_rows(mesh: Optional[str] = None, variant: str = "baseline",
              directory: str = DRYRUN_DIR) -> List[RooflineRow]:
    rows = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if mesh and rec.get("mesh") != mesh:
            continue
        if rec.get("variant", "baseline") != variant:
            continue
        row = analyze_record(rec)
        if row:
            rows.append(row)
    return rows


def markdown_table(rows: List[RooflineRow]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL/HLO | note |")
    sep = "|" + "---|" * 9
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.2e} | "
            f"{r.memory_s:.2e} | {r.collective_s:.2e} | **{r.dominant}** | "
            f"{r.useful_ratio:.2f} | {r.note} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--dir", default=DRYRUN_DIR,
                    help="the dry-run's JSON records")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = load_rows(args.mesh, args.variant, args.dir)
    if args.markdown:
        print(markdown_table(rows))
    else:
        for r in rows:
            print(f"{r.arch:24s} {r.shape:12s} {r.mesh:6s} "
                  f"C={r.compute_s:.2e} M={r.memory_s:.2e} "
                  f"X={r.collective_s:.2e} -> {r.dominant:10s} "
                  f"useful={r.useful_ratio:.2f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([r.as_dict() for r in rows], f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
