"""Helpers of the benchmark's tests: CPU-sized configurations and mixes."""
import copy
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CLOSED = {"kind": "closed", "clients": 2, "rows": 4, "warmup_rows": [4]}
# cells measured on the card and left out of BENCHMARK.json (PERF.md,
# Open questions), each run here as a listed cell of the same traffic with
# its own configuration
LEFT_OUT = {"hymba-pair.bulk": ("hymba-pair", "mamba2-pair.bulk")}

OPEN = {"kind": "open", "rate_rps": 20.0, "rows_min": 1, "rows_max": 8,
        "rows_alpha": 1.5, "order_seed": 3, "warmup_rows": [8, 1]}


def reduce_cfg(cfg: dict) -> dict:
    """A configuration at CPU size: every width cut, two and one layers."""
    cfg = copy.deepcopy(cfg)
    cfg.update(d_model=64, vocab_size=120, vocab_pad_to=8, max_seq=32,
               segment_size=8, allocation=[[4, 2]])
    cfg["ssm"].update(d_state=16, head_dim=16, chunk=16)
    if cfg["num_heads"]:
        cfg.update(num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96,
                   sliding_window=24)
    cfg["members"][0]["num_layers"] = 2
    cfg["members"][1]["num_layers"] = 1
    return cfg
