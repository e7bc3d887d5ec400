"""Token-batch pipeline: synthetic corpus stream with doc packing.

A copy of ``repro/training/data.py`` (numpy only): the same seed gives the
same batches in both packages."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class TokenStream:
    """Deterministic synthetic corpus: zipf-ish unigram documents packed
    into fixed-length training sequences (next-token labels)."""

    def __init__(self, vocab: int, *, seed: int = 0, doc_mean: int = 512):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.doc_mean = doc_mean
        self._buf: list = []

    def _doc(self) -> np.ndarray:
        n = max(int(self.rng.exponential(self.doc_mean)), 16)
        # zipf-like skew, clipped to vocab
        toks = self.rng.zipf(1.3, n) % self.vocab
        return toks.astype(np.int32)

    def batches(self, batch: int, seq: int,
                mm_dim: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        need = batch * (seq + 1)
        while True:
            while len(self._buf) < need:
                self._buf.extend(self._doc().tolist())
            flat = np.array(self._buf[:need], np.int32).reshape(batch, seq + 1)
            self._buf = self._buf[need:]
            out = {"tokens": flat[:, :-1], "labels": flat[:, 1:]}
            if mm_dim:
                out["mm_embeds"] = self.rng.normal(
                    0, 1, (batch, 16, mm_dim)).astype(np.float32)
            yield out
