"""Byte-level tokenizer: utf-8 bytes + BOS/EOS/PAD specials.

Vocab = 256 byte values + 3 specials = 259 (pad to the model's vocab via
modulo guard).  Enough substrate for real-text smoke training and for
serving text through the HTTP API without external deps.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

PAD, BOS, EOS = 256, 257, 258
VOCAB_SIZE = 259


def encode(text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
    ids = list(text.encode("utf-8"))
    if bos:
        ids = [BOS] + ids
    if eos:
        ids = ids + [EOS]
    return ids


def decode(ids: Iterable[int]) -> str:
    data = bytes(i for i in ids if 0 <= i < 256)
    return data.decode("utf-8", errors="replace")


def encode_batch(texts: Iterable[str], seq_len: int, *,
                 vocab_size: int = 0) -> np.ndarray:
    """(N, seq_len) int32, right-padded/truncated; ids clipped into the
    model's vocab when it is smaller than 259."""
    rows = []
    for t in texts:
        ids = encode(t)[:seq_len]
        ids = ids + [PAD] * (seq_len - len(ids))
        rows.append(ids)
    arr = np.asarray(rows, np.int32)
    if vocab_size and vocab_size < VOCAB_SIZE:
        arr = arr % vocab_size
    return arr


class TextCorpus:
    """Training iterator over a text corpus with the byte tokenizer."""

    def __init__(self, text: str, seq_len: int, *, seed: int = 0,
                 vocab_size: int = VOCAB_SIZE):
        ids = np.asarray(encode(text, bos=False), np.int32)
        if vocab_size < VOCAB_SIZE:
            ids = ids % vocab_size
        if len(ids) < seq_len + 2:
            reps = (seq_len + 2) // max(len(ids), 1) + 1
            ids = np.tile(ids, reps)
        self.ids = ids
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)

    def batch(self, batch_size: int):
        starts = self.rng.integers(0, len(self.ids) - self.seq_len - 1,
                                   batch_size)
        tok = np.stack([self.ids[s:s + self.seq_len] for s in starts])
        lab = np.stack([self.ids[s + 1:s + self.seq_len + 1] for s in starts])
        return {"tokens": tok.astype(np.int32), "labels": lab.astype(np.int32)}

    def iterator(self, batch_size: int):
        while True:
            yield self.batch(batch_size)
