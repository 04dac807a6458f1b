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
"""
from __future__ import annotations

from typing import Dict, List, Sequence

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


def compare(Y: torch.Tensor, ref: Dict, members: Sequence[dict]) -> Dict:
    """``max_err`` and ``flip_share`` of answers ``Y`` (R, C) against the
    reference's ``combined`` result ``ref``."""
    Y_ref = ref["Y"]
    diff = Y.double() - Y_ref.double()
    int8 = [i for i, m in enumerate(members) if m["dtype"] == "int8"]
    if len(int8) == 1:
        i = int8[0]
        step = (ref["weights"][i] * ref["scales"][i]).double()[:, None]
        k = torch.round(diff / step)
    else:
        step, k = torch.zeros_like(diff[:, :1]), torch.zeros_like(diff)
    one = k.abs() <= 1
    err = torch.where(one, (diff - k * step).abs(), diff.abs())
    scale = max(1.0, float(Y_ref.abs().max()))
    return {"max_err": float(err.max()) / scale,
            "flip_share": float(((k != 0) & one).double().mean())}


def limits_hold(numbers: Dict, limits: Dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
