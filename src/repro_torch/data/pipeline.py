"""Synthetic-but-learnable data pipeline for training and calibration.

Tasks:
  * "ngram": tokens follow a fixed random bigram table — a real learnable
    distribution (loss provably decreases toward the table's entropy).
  * "copy": second half of each sequence repeats the first half.
  * "uniform": i.i.d. tokens (calibration / benchmarking only).

The iterator yields host numpy batches, drawn exactly as the JAX package
draws them: the same seed gives both packages the same batches.
:func:`shard_batch` places a global host batch on a ``DeviceMesh`` for the
pod launcher, each rank keeping its slice.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, *, task: str = "ngram",
                 seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.task = task
        self.rng = np.random.default_rng(seed)
        if task == "ngram":
            # a dense (vocab, vocab) float64 table, as in the JAX package:
            # 184.7 GB at qwen3's 151936 classes, so full-vocabulary runs
            # train on tokenizer.TextCorpus instead
            # sparse-ish bigram table with temperature; rows sum to 1
            logits = self.rng.gumbel(size=(vocab, vocab)) * 2.0
            top = np.argsort(logits, axis=1)[:, -8:]          # 8 successors each
            probs = np.zeros((vocab, vocab), np.float64)
            rows = np.arange(vocab)[:, None]
            probs[rows, top] = self.rng.dirichlet(np.ones(8), size=vocab)
            self.table = probs

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        v, s = self.vocab, self.seq_len
        if self.task == "uniform":
            toks = self.rng.integers(0, v, (batch_size, s + 1))
        elif self.task == "copy":
            half = (s + 1) // 2 + 1
            first = self.rng.integers(0, v, (batch_size, half))
            toks = np.concatenate([first, first], axis=1)[:, :s + 1]
        elif self.task == "ngram":
            toks = np.empty((batch_size, s + 1), np.int64)
            toks[:, 0] = self.rng.integers(0, v, batch_size)
            cum = self.table.cumsum(axis=1)
            for t in range(1, s + 1):
                u = self.rng.random(batch_size)[:, None]
                toks[:, t] = (cum[toks[:, t - 1]] < u).sum(axis=1)
        else:
            raise ValueError(self.task)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iterator(self, batch_size: int, cfg: Optional[ModelConfig] = None
                 ) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch(batch_size)
            if cfg is not None and cfg.frontend_tokens:
                b["frontend"] = np.zeros(
                    (batch_size, cfg.frontend_tokens, cfg.fdim), np.float32)
            yield b


class PrefetchIterator:
    """Background-thread prefetch (double buffering) over a host iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        import queue
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        for item in self.it:
            if self._stop.is_set():
                return
            self.q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()



def shard_batch(batch: Dict[str, np.ndarray], mesh, batch_axes=("data",)):
    """A global host batch as DTensors with the leading dim sharded over
    ``batch_axes`` of ``mesh`` (a ``DeviceMesh``): every rank draws the same
    global batch from the same seed, and copies only its own slice to its
    device."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.collectives import contiguous_strides
    from repro_torch.parallel.sharding import P, local_slices, to_placements
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        pl = to_placements(P(tuple(batch_axes), *([None] * (v.ndim - 1))),
                           mesh)
        local = np.ascontiguousarray(v[local_slices(v.shape, mesh, pl)])
        shape = torch.Size(v.shape)
        out[k] = DTensor.from_local(
            torch.from_numpy(local).to(mesh.device_type), mesh, pl,
            run_check=False, shape=shape, stride=contiguous_strides(shape))
    return out
