"""Byte-level tokenizer (tokenizer-lite).

Deterministic, vocabulary = 256 bytes + specials.  Enough substrate for the
MapReduce text applications and for end-to-end text training demos without
external model files.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258
    vocab_size = 259

    def encode(self, text: str, bos: bool = True, eos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Iterable[int]) -> str:
        by = bytes(i for i in ids if 0 <= int(i) < 256)
        return by.decode("utf-8", errors="replace")

    def pad_batch(self, seqs: List[np.ndarray], length: int) -> np.ndarray:
        out = np.full((len(seqs), length), self.PAD, dtype=np.int32)
        for i, s in enumerate(seqs):
            out[i, : min(len(s), length)] = s[:length]
        return out
