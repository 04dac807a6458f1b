"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of a served row and of a kernel call, computed from shapes.

Peaks are NVIDIA's H100 SXM data sheet (dense, at the 700 W limit).  The
served configurations compute in float32; no route on this card that keeps
float32 accuracy passes the TF32 tensor-core rate (a 3xTF32 product runs
on the tensor cores; the CUDA cores' float32 peak is 67 TFLOP/s), so that
is the peak a share of FLOP/s is taken against.

Operations are the algorithm's, counted once, whatever implements them: a
product of (m, k) by (k, n) is 2mkn; causal and windowed attention count
only the (query, key) pairs that are attended; the chunked SSD scan counts
the lower triangle of each chunk.  Bytes count each input read once and
each output written once.
"""
from __future__ import annotations

from harness import family

PEAK_TF32_FLOPS = 495e12        # TF32 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12
F32 = 4
ATTENTION = ("attn", "swa", "hybrid")   # layer kinds that run flash_call
SCAN = ("ssm", "hybrid")                # layer kinds that run ssd_call


def attn_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal attention over ``s`` positions attends,
    keys older than ``window`` (when > 0) left out."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def ssm_dims(cfg: dict):
    """(d_inner, state N, head dim P, heads H, conv width K)."""
    sc = cfg["ssm"]
    di = sc["expand"] * cfg["d_model"]
    return di, sc["d_state"], sc["head_dim"], di // sc["head_dim"], sc["d_conv"]


def ssd_call(b: int, s: int, h: int, p: int, n: int, chunk: int):
    """(bytes, ops) of one SSD scan call: x (B,S,H,P), dt (B,S,H), A (H,),
    B and C (B,S,N) read, y (B,S,H,P) written; ops of the chunked
    algorithm: per chunk the scores C.B^T and their gating on the lower
    triangle, the intra-chunk product, each chunk's state, the state
    carried to the next chunk, and the states' contribution to y."""
    nbytes = F32 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n)
    nc = -(-s // chunk)
    q = chunk
    tri = q * (q + 1) // 2
    per_head = tri + 2 * tri * p + 2 * q * n * p + 2 * p * n + \
        2 * q * n * p + q * p
    ops = b * nc * (2 * n * tri + h * per_head)
    return nbytes, ops


def flash_call(b: int, s: int, h: int, kv: int, hd: int, window: int):
    """(bytes, ops) of one causal attention call: q, k, v read, o written;
    QK^T and PV over the attended pairs."""
    nbytes = F32 * b * s * hd * (2 * h + 2 * kv)
    ops = 4 * b * h * hd * attn_pairs(s, window)
    return nbytes, ops


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes at HBM bandwidth or ops at
    the TF32 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_TF32_FLOPS)


def member_flops_per_row(cfg: dict, layers: int, s: int) -> float:
    """Model FLOPs of one row of ``s`` tokens through a member of
    ``layers`` layers: each layer's products and conv (its family
    module's ``layer_flops``), attention's and the scan's algorithmic ops,
    and the head on the last position only."""
    d = cfg["d_model"]
    pattern = cfg["pattern"]
    layer_flops = family.module(cfg).layer_flops
    total = 0.0
    for r in range(layers):
        kind = pattern[r % len(pattern)]
        total += layer_flops(cfg, kind, s)
        if kind in ATTENTION:
            h, kv = cfg["num_heads"], cfg["num_kv_heads"]
            hd = cfg["head_dim"] or d // h
            window = cfg["sliding_window"] if kind != "attn" else 0
            total += flash_call(1, s, h, kv, hd, window)[1]
        if kind in SCAN:
            _, n, p, h, _ = ssm_dims(cfg)
            total += ssd_call(1, s, h, p, n, cfg["ssm"]["chunk"])[1]
    return total + 2 * d * cfg["vocab_size"]                    # the head


def pair_flops_per_row(cfg: dict) -> float:
    """Model FLOPs of one served row through every member."""
    return sum(member_flops_per_row(cfg, m["num_layers"], cfg["max_seq"])
               for m in cfg["members"])


def kernel_layers(cfg: dict, layers: int, kinds) -> int:
    """Layers of a member whose kind is one of ``kinds``."""
    pattern = cfg["pattern"]
    return sum(pattern[r % len(pattern)] in kinds for r in range(layers))


def rows_from_launches(cfg: dict, launches: int, kinds) -> float:
    """Rows served, inferred from the launches of a kernel that runs once
    per layer of ``kinds`` per batch: every row visits every member once,
    and in a cell whose batches are all full a member of batch b launches
    it layers/b times a row."""
    per_row = sum(kernel_layers(cfg, m["num_layers"], kinds) / b
                  for m, b in zip(cfg["members"], cfg["allocation"][0]))
    return launches / per_row if per_row else 0.0
