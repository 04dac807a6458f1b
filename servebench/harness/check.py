"""The comparison that decides ``correct``: a sample of the answers served
in the window against the plain reference.

Each number compared:

* ``max_err``: the widest error of an answer element, over max(1, the
  largest |Y_ref|).  An int8 member's class score on a rounding edge may
  take the neighbouring code in the served forward, which moves that
  element by exactly one step (its combine weight times the row's scale);
  such an element's error is taken after that one step is removed, and an
  element that is off by more than one step keeps its whole error.
* ``flip_share``: the share of elements that took a neighbouring code.
* ``alt_share``, only where the reference names admissible alternates
  (``compare``): the share of rows nearest to an alternate.  A
  configuration whose reference names them sets its limit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

SAMPLE_ROWS = 128            # rows of served answers compared in a run


def sample(requests: Sequence, seed: int, rows: int = SAMPLE_ROWS) -> List:
    """Completed requests drawn from the seed until ``rows`` rows, the
    longest request always among them."""
    done = [r for r in requests if r.ok]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.rows, -r.idx))
    chosen, total = [longest], longest.rows
    rng = np.random.default_rng([seed % 2 ** 64, 7])
    for i in rng.permutation(len(done)):
        if total >= rows:
            break
        r = done[int(i)]
        if r is not longest:
            chosen.append(r)
            total += r.rows
    return chosen


def _errors(diff: torch.Tensor, step: Optional[torch.Tensor]):
    """(error, flipped) of each element of ``diff``; ``step`` (R, 1) is the
    int8 member's code step of each row, None where there is no single
    int8 member."""
    if step is None:
        step, k = torch.zeros_like(diff[:, :1]), torch.zeros_like(diff)
    else:
        k = torch.round(diff / step)
    one = k.abs() <= 1
    return (torch.where(one, (diff - k * step).abs(), diff.abs()),
            (k != 0) & one)


def _step(ref: Dict, scales: Dict, int8: List[int]):
    """The code step of each row: the int8 member's combine weight times
    its row scales ``scales``."""
    if len(int8) != 1:
        return None
    i = int8[0]
    return (ref["weights"][i] * scales[i]).double()[:, None]


def compare(Y: torch.Tensor, ref: Dict, members: Sequence[dict]) -> Dict:
    """``max_err`` and ``flip_share`` of answers ``Y`` (R, C) against the
    reference's ``combined`` result ``ref``.

    Where ``ref["alternates"]`` maps a row to the row's other admissible
    answers (each ``{"Y": (C,), "scales": {member: row scale}}``, the
    answer under another resolution of the reference's own rounding-level
    ties, such as a top-k near-tie), the row is measured against the
    nearest of its answers (the least widest element error, the reference
    answer on a tie), and ``alt_share`` is the share of rows whose nearest
    answer was an alternate."""
    Y_ref = ref["Y"]
    int8 = [i for i, m in enumerate(members) if m["dtype"] == "int8"]
    diff = Y.double() - Y_ref.double()
    err, flips = _errors(diff, _step(ref, ref["scales"], int8))
    alternates = ref.get("alternates")
    taken = 0
    for row, answers in (alternates or {}).items():
        best, alt = err[row].max(), False
        for a in answers:
            d = Y[row:row + 1].double() - a["Y"].double().reshape(1, -1)
            sc = {i: torch.as_tensor(v).reshape(1)
                  for i, v in a["scales"].items()}
            e, f = _errors(d, _step(ref, sc, int8))
            if e.max() < best:
                best, alt, err[row], flips[row] = e.max(), True, e[0], f[0]
        taken += alt
    scale = max(1.0, float(Y_ref.abs().max()))
    out = {"max_err": float(err.max()) / scale,
           "flip_share": float(flips.double().mean())}
    if alternates is not None:
        out["alt_share"] = taken / Y.shape[0]
    return out


def limits_hold(numbers: Dict, limits: Dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
