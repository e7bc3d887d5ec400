"""Multi-tenant cluster workload: several bursty online streams with
distinct SLOs plus a shared-prefix offline corpus per tenant.

Each tenant gets its own BurstyTrace (independent tidal phase/burst seed),
its own SLO class (e.g. an interactive chat tenant vs. a relaxed API
tenant), and a LooGLE-like offline corpus whose documents are private to
the tenant — so prefix sharing exists *within* a tenant but not across
tenants. Offline submissions are interleaved across tenants (batch-API
mixing), which is exactly what scatters document groups under round-robin
dispatch and what a prefix-affinity router must undo.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.request import SLO, Request
from repro_torch.data.trace import BurstyTrace
from repro_torch.data.workload import make_offline_corpus, make_online_requests


@dataclass(frozen=True)
class TenantSpec:
    name: str
    online_rate: float = 1.0            # arrivals / s at the tidal mean
    slo: SLO = SLO(1.0, 0.1)
    prompt_mean: int = 96
    max_new_mean: int = 24
    burst_rate: float = 4.0
    burst_prob: float = 0.02
    burst_len: float = 10.0
    n_docs: int = 4                     # offline corpus: docs private to tenant
    questions_per_doc: int = 24
    doc_len: int = 256
    question_len: int = 24
    offline_new: int = 8


def default_tenants(n: int = 3) -> Tuple[TenantSpec, ...]:
    """An interactive chat tenant (tight SLO), an assistant tenant, and a
    relaxed API tenant — cycled if more are requested."""
    archetypes = (
        TenantSpec("chat", online_rate=1.5, slo=SLO(0.8, 0.08),
                   prompt_mean=96, max_new_mean=24),
        TenantSpec("assist", online_rate=1.0, slo=SLO(1.2, 0.12),
                   prompt_mean=160, max_new_mean=32),
        TenantSpec("api", online_rate=0.6, slo=SLO(2.0, 0.2),
                   prompt_mean=64, max_new_mean=16),
    )
    out = []
    for i in range(n):
        base = archetypes[i % len(archetypes)]
        name = base.name if i < len(archetypes) else f"{base.name}{i}"
        out.append(dataclasses.replace(base, name=name))
    return tuple(out)


def make_multi_tenant_workload(
        tenants: Sequence[TenantSpec], duration: float, *,
        vocab: int = 256, seed: int = 0,
        tidal_period: Optional[float] = None,
        ) -> Tuple[List[Request], List[Request]]:
    """Returns (online, offline): online merged across tenants sorted by
    arrival, offline interleaved across tenants with epsilon-increasing
    arrival times (FCFS order == mixed submission order)."""
    online: List[Request] = []
    offline: List[Request] = []
    for i, t in enumerate(tenants):
        s = seed + 101 * i
        trace = BurstyTrace(base_rate=t.online_rate,
                            tidal_period=tidal_period or 2 * duration,
                            burst_rate=t.burst_rate, burst_prob=t.burst_prob,
                            burst_len=t.burst_len, seed=s + 1)
        arrivals = trace.sample(0.0, duration)
        online.extend(make_online_requests(
            arrivals, prompt_mean=t.prompt_mean,
            prompt_std=max(t.prompt_mean // 4, 1),
            max_new_mean=t.max_new_mean, vocab=vocab, slo=t.slo, seed=s + 2))
        offline.extend(make_offline_corpus(
            t.n_docs, t.questions_per_doc, doc_len=t.doc_len,
            question_len=t.question_len, max_new=t.offline_new, vocab=vocab,
            arrival_time=0.0, shuffle=True, seed=s + 3))
    online.sort(key=lambda r: (r.arrival_time, r.rid))
    rng = np.random.default_rng(seed + 7)
    rng.shuffle(offline)
    for i, r in enumerate(offline):
        r.arrival_time = i * 1e-6
    return online, offline
