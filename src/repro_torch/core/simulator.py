"""§5.4 resource & throughput simulation for system deployers.

Step 1: enumerate resources (KV blocks ≈ GPU memory) smallest→largest over
a short peak-workload window until online SLOs are met.
Step 2: with chosen resources, simulate an extended period to estimate the
maximum offline throughput.

Both replay the *actual* scheduler + KV manager (EchoEngine with
model=None), clocked by the calibrated time model — exactly the paper's
methodology.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.engine import EchoEngine, EngineStats
from repro_torch.core.estimator import TimeModel
from repro_torch.core.policies import ECHO, PolicyConfig
from repro_torch.core.request import Request


def clone_requests(reqs: Sequence[Request],
                   preserve_rid: bool = False) -> List[Request]:
    """Fresh, unstarted copies — requests mutate as they run, so every
    simulation must get its own. ``preserve_rid=True`` keeps the template
    rids, making two simulations of the same workload bit-identical (the
    simulator fabricates tokens per-rid); only safe when each clone set runs
    in its own engine/cluster, since rids must stay unique within one."""
    out = []
    for r in reqs:
        kw = {"rid": r.rid} if preserve_rid else {}
        out.append(Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                           task_type=r.task_type, arrival_time=r.arrival_time,
                           slo=r.slo, **kw))
    return out


def simulate(online: Sequence[Request], offline: Sequence[Request],
             time_model: TimeModel, num_blocks: int, *,
             policy: PolicyConfig = ECHO, block_size: int = 16,
             chunk_size: int = 64, clock_model=None,
             duration: Optional[float] = None,
             max_iters: int = 20_000) -> EngineStats:
    """``clock_model`` (optional) is the ground-truth clock when it differs
    from the scheduler's ``time_model`` estimate — §5 calibration studies."""
    eng = EchoEngine(None, None, policy, num_blocks=num_blocks,
                     block_size=block_size, chunk_size=chunk_size,
                     time_model=time_model, clock_model=clock_model)
    for r in clone_requests(online) + clone_requests(offline):
        eng.submit(r)
    return eng.run(max_iters=max_iters, until_time=duration)


@dataclass
class CapacityReport:
    min_blocks_for_slo: Optional[int]
    slo_by_blocks: List[Tuple[int, float]]
    offline_throughput: Optional[float] = None


def estimate_capacity(online_peak: Sequence[Request],
                      offline: Sequence[Request],
                      time_model: TimeModel, *,
                      candidate_blocks: Sequence[int] = (64, 128, 256, 512, 1024),
                      slo_target: float = 0.9,
                      policy: PolicyConfig = ECHO,
                      block_size: int = 16,
                      duration: Optional[float] = None) -> CapacityReport:
    """Step 1 (+ Step 2 at the chosen size)."""
    tried = []
    chosen = None
    for nb in sorted(candidate_blocks):
        stats = simulate(online_peak, [], time_model, nb, policy=policy,
                         block_size=block_size, duration=duration)
        att = min(stats.slo_attainment("ttft"), stats.slo_attainment("tpot"))
        tried.append((nb, att))
        if att >= slo_target and chosen is None:
            chosen = nb
            break
    report = CapacityReport(min_blocks_for_slo=chosen, slo_by_blocks=tried)
    if chosen is not None:
        stats = simulate(online_peak, offline, time_model, chosen,
                         policy=policy, block_size=block_size,
                         duration=duration)
        report.offline_throughput = stats.offline_throughput()
    return report
