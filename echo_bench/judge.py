"""Whether what the timed path served is correct.

Once the window has closed, the peak memory has been read and the engine
is dropped, a sample of the requests the run finished is drawn from the
seed, with these always in it: the request that was served the most
tokens, the longest offline request whose whole prompt was prefilled, over
several chunks, and the longest offline request whose document prefix came
from another request's KV (its first chunk started past position 0). More
are drawn until the sample holds ``min_served`` served tokens and
``min_requests`` requests, within ``max_ref_tokens`` tokens of reference
work. The plain float32 reference (``reference.py``) runs once over each
prompt with its served tokens; the number compared is the widest gap by
which a served (greedy) token's reference logit lies below the
reference's best at its position.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from echo_bench import reference


@dataclass
class Sampled:
    rid: int
    prompt: Sequence[int]
    served: Sequence[int]
    why: str


def draw(finished, first_ctx: dict, chunks: dict, seed: int, rule: dict) -> List[Sampled]:
    done = sorted((r for r in finished if r.output_tokens), key=lambda r: r.rid)
    picked: List[Sampled] = []
    budget = int(rule["max_ref_tokens"])

    def add(r, why) -> bool:
        nonlocal budget
        if r is None or any(p.rid == r.rid for p in picked):
            return False
        n = r.prompt_len + r.n_output
        if n > budget:
            return False
        budget -= n
        picked.append(Sampled(r.rid, r.prompt, tuple(r.output_tokens), why))
        return True

    def longest(cands):
        return max(cands, key=lambda r: (r.prompt_len, r.rid), default=None)

    offline = [r for r in done if not r.is_online]
    add(max(done, key=lambda r: (r.n_output, r.rid), default=None), "most served tokens")
    add(longest([r for r in offline if chunks.get(r.rid, 0) >= 2
                 and first_ctx.get(r.rid, 0) == 0]), "prefill over several chunks")
    add(longest([r for r in offline if first_ctx.get(r.rid, 0) > 0]),
        "document prefix from another request's KV")
    rng = np.random.default_rng(seed + 2)
    for k in rng.permutation(len(done)):
        if (sum(len(p.served) for p in picked) >= rule["min_served"]
                and len(picked) >= rule["min_requests"]):
            break
        add(done[int(k)], "drawn")
    return picked


@dataclass
class Verdict:
    max_gap: float
    served: int
    requests: int
    hit: bool
    multi: bool
    control_gap: Optional[float] = None


def judge(model: dict, params, sample: List[Sampled], control: bool = False) -> Verdict:
    """The widest reference-logit gap of the served tokens; with
    ``control`` also that of the tokens the fp8 reference puts first at the
    same positions."""
    seqs = [tuple(s.prompt) + tuple(s.served[:-1]) for s in sample]
    rows = [range(len(s.prompt) - 1, len(s.prompt) - 1 + len(s.served)) for s in sample]
    ref = reference.logits_at(model, params, seqs, rows)
    dev = ref[0].device
    gap = max(float(reference.gaps(r, torch.as_tensor(s.served, device=dev)).max())
              for r, s in zip(ref, sample))
    out = Verdict(max_gap=gap, served=sum(len(s.served) for s in sample),
                  requests=len(sample), hit=any(s.why.startswith("document") for s in sample),
                  multi=any(s.why.startswith("prefill") for s in sample))
    if control:
        ctl = reference.logits_at(model, params, seqs, rows, quant="fp8")
        out.control_gap = max(float(reference.gaps(r, c.argmax(-1)).max())
                              for r, c in zip(ref, ctl))
    return out
