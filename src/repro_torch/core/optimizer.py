"""The allocation-matrix optimizer: Algorithm 1 → Algorithm 2 → disk cache
(paper §II.E: "the best matrix is cached to avoid recomputing it again when
the server will be restarted").  The cache is the JAX package's JSON file:
the same key, so either package reads the other's entries."""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocation import DEFAULT_BATCH_SIZES, AllocationMatrix
from repro_torch.core.bench import Bench, MemoBench
from repro_torch.core.devices import DeviceSpec
from repro_torch.core.greedy import GreedyTrace, bounded_greedy
from repro_torch.core.worst_fit import worst_fit_decreasing


@dataclass
class OptimizationResult:
    matrix: AllocationMatrix
    wfd_matrix: AllocationMatrix          # Algorithm-1-only (Table I "A1")
    wfd_score: float
    final_score: float
    trace: GreedyTrace
    from_cache: bool = False


class AllocationOptimizer:
    def __init__(self, cfgs: Sequence[ModelConfig], devices: List[DeviceSpec],
                 bench: Bench, *, batch_sizes=DEFAULT_BATCH_SIZES,
                 max_iter: int = 10, max_neighs: int = 100,
                 default_batch_size: int = 8, seq: int = 128,
                 cache_path: Optional[str] = None, seed: int = 0,
                 memoize: bool = True,
                 member_dtypes: Optional[Sequence[Optional[str]]] = None):
        self.cfgs = list(cfgs)
        self.devices = devices
        self.bench = MemoBench(bench) if memoize else bench
        self.batch_sizes = tuple(batch_sizes)
        self.max_iter = max_iter
        self.max_neighs = max_neighs
        self.default_batch_size = default_batch_size
        self.seq = seq
        self.cache_path = cache_path
        self.seed = seed
        self.member_dtypes = list(member_dtypes) if member_dtypes else None

    # ---- cache --------------------------------------------------------------
    def _cache_key(self) -> str:
        payload = {"models": [c.name for c in self.cfgs],
                   "devices": [d.key() for d in self.devices],
                   "batch_sizes": self.batch_sizes, "seq": self.seq,
                   "member_dtypes": self.member_dtypes}
        return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()

    def _load_cached(self) -> Optional[AllocationMatrix]:
        if not self.cache_path or not os.path.exists(self.cache_path):
            return None
        try:
            with open(self.cache_path) as f:
                entry = json.load(f).get(self._cache_key())
            if entry is None:
                return None
            return AllocationMatrix(self.devices, [c.name for c in self.cfgs],
                                    np.array(entry["A"]))
        except (json.JSONDecodeError, KeyError, ValueError):
            return None

    def _store_cached(self, alloc: AllocationMatrix) -> None:
        if not self.cache_path:
            return
        store = {}
        if os.path.exists(self.cache_path):
            try:
                with open(self.cache_path) as f:
                    store = json.load(f)
            except json.JSONDecodeError:
                store = {}
        store[self._cache_key()] = {"A": alloc.A.tolist()}
        os.makedirs(os.path.dirname(self.cache_path) or ".", exist_ok=True)
        with open(self.cache_path, "w") as f:
            json.dump(store, f)

    # ---- the procedure --------------------------------------------------------
    def optimize(self) -> OptimizationResult:
        cached = self._load_cached()
        if cached is not None:
            s = self.bench(cached)
            return OptimizationResult(cached, cached, s, s, GreedyTrace(),
                                      from_cache=True)
        wfd = worst_fit_decreasing(self.cfgs, self.devices,
                                   default_batch_size=self.default_batch_size,
                                   seq=self.seq,
                                   member_dtypes=self.member_dtypes)
        wfd_score = self.bench(wfd)
        best, trace = bounded_greedy(wfd, self.bench, max_iter=self.max_iter,
                                     max_neighs=self.max_neighs,
                                     batch_sizes=self.batch_sizes,
                                     seed=self.seed)
        final_score = self.bench(best)
        self._store_cached(best)
        return OptimizationResult(best, wfd, wfd_score, final_score, trace)
