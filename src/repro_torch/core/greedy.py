"""Algorithm 2 — Bounded greedy optimization (paper §II.E.2).

Starts from Algorithm 1's matrix; each iteration scores at most
``max_neighs`` randomly drawn single-element neighbours and moves to the best
strictly-improving one; stops at ``max_iter`` or on a plateau.  Worst case it
returns the starting matrix (inherited greedy guarantee).  Neighbours are
drawn with ``random.Random(seed)`` in the JAX package's call sequence, so a
seed visits the same neighbours in both.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from repro_torch.core.allocation import DEFAULT_BATCH_SIZES, AllocationMatrix
from repro_torch.core.bench import Bench


@dataclass
class GreedyTrace:
    """History of one optimization run."""
    scores: List[float] = field(default_factory=list)
    evaluated: int = 0
    iterations: int = 0
    visited_rate: List[float] = field(default_factory=list)


def bounded_greedy(start: AllocationMatrix, bench: Bench, *,
                   max_iter: int = 10, max_neighs: int = 100,
                   batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
                   seed: int = 0) -> Tuple[AllocationMatrix, GreedyTrace]:
    rng = random.Random(seed)
    trace = GreedyTrace()

    # paper §III: when D - M > max_iter, give every device a chance to be used
    D, M = start.A.shape
    if D - M > max_iter:
        max_iter = D - M

    a = start.copy()
    a_speed = bench(a)
    trace.scores.append(a_speed)
    trace.evaluated += 1

    it = 0
    while it < max_iter:
        neighs = list(a.neighbors(batch_sizes))
        total = max(1, len(neighs))
        if len(neighs) > max_neighs:
            neighs = rng.sample(neighs, max_neighs)
        trace.visited_rate.append(len(neighs) / total)

        best_a, best_speed = None, a_speed
        for n in neighs:
            s = bench(n)
            trace.evaluated += 1
            if s > best_speed:
                best_a, best_speed = n, s

        if best_a is not None and best_speed > a_speed:
            a, a_speed = best_a, best_speed
            trace.scores.append(a_speed)
            it += 1
            trace.iterations = it
        else:
            break                      # local maximum (or plateau) detected
    return a, trace
