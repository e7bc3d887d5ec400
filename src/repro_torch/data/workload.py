"""Synthetic workloads mirroring the paper's datasets (§7.1, Table 1).

Online  (ShareGPT-like): short prompts (~hundreds of tokens), <5% sharing.
Offline (LooGLE-like):  long document contexts shared by several questions
                        per document (>85% prefix sharing), submitted all at
                        once in a batch.
Token ids are drawn from a small vocab; content only matters for block
hashing and model execution, not semantics.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import SLO, Request, TaskType


def _tokens(rng, n: int, vocab: int) -> Tuple[int, ...]:
    return tuple(int(x) for x in rng.integers(0, vocab, n))


def make_online_requests(arrivals: Sequence[float], *,
                         prompt_mean: int = 64, prompt_std: int = 32,
                         max_new_mean: int = 32, vocab: int = 256,
                         slo: Optional[SLO] = None,
                         seed: int = 1) -> List[Request]:
    rng = np.random.default_rng(seed)
    slo = slo or SLO()
    out = []
    for t in arrivals:
        plen = max(int(rng.normal(prompt_mean, prompt_std)), 8)
        mnt = max(int(rng.exponential(max_new_mean)), 4)
        out.append(Request(prompt=_tokens(rng, plen, vocab),
                           max_new_tokens=mnt, task_type=TaskType.ONLINE,
                           arrival_time=float(t), slo=slo))
    return out


def make_offline_corpus(n_docs: int = 8, questions_per_doc: int = 8, *,
                        doc_len: int = 256, question_len: int = 24,
                        max_new: int = 16, vocab: int = 256,
                        arrival_time: float = 0.0, shuffle: bool = True,
                        seed: int = 2) -> List[Request]:
    """LooGLE-style: each document is a shared prefix for its questions.
    Prefix sharing rate ~= doc_len / (doc_len + question_len).

    By default the submission order is shuffled (batch-API submissions
    interleave users/documents) — FCFS baselines therefore lose prefix
    locality, which is exactly what Echo's KV-aware reordering restores.
    """
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n_docs):
        doc = _tokens(rng, doc_len, vocab)
        for q in range(questions_per_doc):
            question = _tokens(rng, question_len, vocab)
            out.append(Request(prompt=doc + question, max_new_tokens=max_new,
                               task_type=TaskType.OFFLINE,
                               arrival_time=arrival_time))
    if shuffle:
        rng.shuffle(out)
    # FCFS order == submission order: epsilon-increasing arrival times
    for i, r in enumerate(out):
        r.arrival_time = arrival_time + i * 1e-6
    return out


def sharing_rate(reqs: Sequence[Request], block_size: int = 16) -> float:
    """Fraction of prompt blocks shared with at least one other request
    (Table 1's 'Shared Rate' metric, block-granular)."""
    from collections import Counter
    from repro_torch.core.block_manager import chain_hash
    counts: Counter = Counter()
    total = 0
    chains = []
    for r in reqs:
        prev = 0
        chain = []
        for i in range(len(r.prompt) // block_size):
            prev = chain_hash(prev, tuple(r.prompt[i * block_size:(i + 1) * block_size]))
            chain.append(prev)
            counts[prev] += 1
        chains.append(chain)
        total += len(chain)
    if total == 0:
        return 0.0
    shared = sum(1 for chain in chains for h in chain if counts[h] > 1)
    return shared / total
