"""One general generator for every traffic mix (``traffic/<mix>.json``).

The sizes of a mix (prompt and output lengths, inter-arrival gaps, document,
question and answer lengths) are drawn once from the mix's own
``sizes_seed``, so every run seed serves the same set of sizes and gaps;
the run seed only orders them and draws the token ids (over the whole
vocabulary) and the offline submission order. The same seed gives the same
inputs.

Online: an open loop of independent users, Poisson arrivals at ``rate_per_s``
(the gaps are exponential), prompts and outputs lognormal. Offline: a
document-QA backlog (LooGLE-like): ``docs`` documents, each asked
``questions_per_doc`` questions; a prompt is its document followed by its
question, so all but the question is a prefix shared with the document's
other questions. The backlog is one shuffled batch, as a batch API takes it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class OnlineSpec:
    due_s: float                  # seconds after the ramp starts
    prompt: Tuple[int, ...]
    max_new: int


@dataclass
class OfflineSpec:
    prompt: Tuple[int, ...]
    max_new: int


def sizes(rng: np.random.Generator, dist: dict, n: int) -> np.ndarray:
    """``n`` whole sizes from ``dist``: {"dist": "lognormal", "mean",
    "sigma", "min", "max"} (``mean`` is the mean before clipping) or
    {"dist": "uniform", "min", "max"} (both ends included)."""
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "lognormal":
        sigma = float(dist["sigma"])
        mu = math.log(float(dist["mean"])) - sigma * sigma / 2
        x = np.rint(rng.lognormal(mu, sigma, n))
    elif dist["dist"] == "uniform":
        x = rng.integers(lo, hi + 1, n)
    else:
        raise ValueError(f"unknown size distribution {dist['dist']!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def make_online(mix: dict, vocab: int, seed: int, seconds: float,
                rate_per_s: float = None) -> List[OnlineSpec]:
    """The online stream, ordered by due time, over the ramp, a window of
    ``seconds`` and the drain. ``rate_per_s`` overrides the mix's rate (the
    rate sweep only: a cell's rate is fixed in its file)."""
    on = mix["online"]
    rate = float(rate_per_s if rate_per_s is not None else on["rate_per_s"])
    if on["arrival"] != "poisson":
        raise ValueError(f"unknown arrival process {on['arrival']!r}")
    horizon = float(mix["ramp_s"]) + float(seconds) + float(mix["drain_s"])
    n = int(math.ceil(rate * horizon)) + 1
    fixed = np.random.default_rng(int(mix["sizes_seed"]))
    plen = sizes(fixed, on["prompt"], n)
    olen = sizes(fixed, on["output"], n)
    gaps = fixed.exponential(1.0 / rate, n)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    gaps = gaps[rng.permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    out = []
    for t, i in zip(due, order):
        toks = rng.integers(0, vocab, int(plen[i]))
        out.append(OnlineSpec(float(t), tuple(toks.tolist()), int(olen[i])))
    return out


def make_offline(mix: dict, vocab: int, seed: int) -> List[OfflineSpec]:
    """The backlog in submission order (shuffled). The token ids of a
    document are one tuple shared by its prompts' prefixes."""
    off = mix["offline"]
    nd, nq = int(off["docs"]), int(off["questions_per_doc"])
    fixed = np.random.default_rng(int(mix["sizes_seed"]) + 1)
    dlen = sizes(fixed, off["doc"], nd)
    qlen = sizes(fixed, off["question"], nd * nq)
    alen = sizes(fixed, off["answer"], nd * nq)
    rng = np.random.default_rng(seed + 1)
    dlen = dlen[rng.permutation(nd)]
    pairs = rng.permutation(nd * nq)
    out = []
    for d in range(nd):
        doc = tuple(rng.integers(0, vocab, int(dlen[d])).tolist())
        for j in range(nq):
            k = pairs[d * nq + j]
            q = tuple(rng.integers(0, vocab, int(qlen[k])).tolist())
            out.append(OfflineSpec(doc + q, int(alen[k])))
    order = rng.permutation(len(out))
    return [out[i] for i in order]
