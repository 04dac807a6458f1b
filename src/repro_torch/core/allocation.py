"""The allocation matrix — the paper's central data structure (§II.B).

``A`` is a (D devices × M models) integer matrix.  ``A[d, m] == 0`` means no
worker for model m on device d; any other value is that worker's batch size.
Several non-zeros in a row = co-localization; several non-zeros in a column =
data-parallelism.  All-zero columns are illegal (every ensemble member must be
served); all-zero rows are idle devices (legal).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.core.devices import DeviceSpec

DEFAULT_BATCH_SIZES = (8, 16, 32, 64, 128)     # §III "possible batch size values"


@dataclass
class AllocationMatrix:
    devices: List[DeviceSpec]
    model_names: List[str]
    A: np.ndarray                                 # (D, M) int

    def __post_init__(self):
        self.A = np.asarray(self.A, dtype=np.int64)
        if self.A.shape != (len(self.devices), len(self.model_names)):
            raise ValueError(f"A shape {self.A.shape} != "
                             f"({len(self.devices)}, {len(self.model_names)})")

    # ---- validity ---------------------------------------------------------
    def is_valid(self) -> bool:
        """No all-zero columns; non-negative entries."""
        if (self.A < 0).any():
            return False
        return bool((self.A.sum(axis=0) > 0).all())

    def validate(self) -> None:
        if not self.is_valid():
            empty = [self.model_names[m] for m in
                     np.where(self.A.sum(axis=0) == 0)[0]]
            raise ValueError(f"invalid allocation: unserved models {empty}")

    # ---- structure queries --------------------------------------------------
    def workers(self) -> List[Tuple[int, int, int]]:
        """All (device_idx, model_idx, batch_size) workers."""
        d_idx, m_idx = np.nonzero(self.A)
        return [(int(d), int(m), int(self.A[d, m])) for d, m in zip(d_idx, m_idx)]

    def colocated(self, d: int) -> List[int]:
        return [int(m) for m in np.nonzero(self.A[d])[0]]

    def instances(self, m: int) -> List[int]:
        return [int(d) for d in np.nonzero(self.A[:, m])[0]]

    def num_workers(self) -> int:
        return int((self.A > 0).sum())

    # ---- the decision space (paper Eq. 1 / Eq. 2) ---------------------------
    @staticmethod
    def total_matrices(D: int, M: int, B: int) -> int:
        """Eq. 1: ((B+1)^D - 1)^M."""
        return ((B + 1) ** D - 1) ** M

    def total_neighbors(self, batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES) -> int:
        """Eq. 2: (B+1)*(D*M) - F, with F the forbidden (invalid) moves."""
        B = len(batch_sizes)
        D, M = self.A.shape
        forbidden = 0
        for d, m in itertools.product(range(D), range(M)):
            if self.A[d, m] > 0 and len(self.instances(m)) == 1:
                forbidden += 1          # zeroing the sole instance is illegal
        return (B + 1) * D * M - forbidden

    def neighbors(self, batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES
                  ) -> Iterator["AllocationMatrix"]:
        """All valid matrices differing from self in exactly one element."""
        D, M = self.A.shape
        for d in range(D):
            for m in range(M):
                cur = self.A[d, m]
                for val in (0, *batch_sizes):
                    if val == cur:
                        continue
                    new = self.A.copy()
                    new[d, m] = val
                    cand = AllocationMatrix(self.devices, self.model_names, new)
                    if cand.is_valid():
                        yield cand

    # ---- identity / serialization -------------------------------------------
    def key(self) -> str:
        payload = {
            "devices": [d.key() for d in self.devices],
            "models": list(self.model_names),
            "A": self.A.tolist(),
        }
        return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()

    def to_json(self) -> str:
        return json.dumps({"models": self.model_names, "A": self.A.tolist(),
                           "devices": [d.name for d in self.devices]})

    def copy(self) -> "AllocationMatrix":
        return AllocationMatrix(self.devices, self.model_names, self.A.copy())

    def pretty(self) -> str:
        """Table II-style rendering."""
        w = max(len(n) for n in self.model_names) if self.model_names else 4
        w = min(w, 24)
        head = " " * 8 + " ".join(f"{n[:w]:>{w}}" for n in self.model_names)
        rows = [head]
        for d, dev in enumerate(self.devices):
            rows.append(f"{dev.name:>7} " +
                        " ".join(f"{int(v):>{w}}" for v in self.A[d]))
        return "\n".join(rows)


def zeros(devices: List[DeviceSpec], model_names: List[str]) -> AllocationMatrix:
    return AllocationMatrix(devices, model_names,
                            np.zeros((len(devices), len(model_names)), np.int64))
