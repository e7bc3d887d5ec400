"""FleetPlanner: §5.4 capacity estimation lifted to a replicated fleet.

The single-GPU planner answers "min KV blocks for the SLO"; the fleet
planner answers "min replicas × blocks for a target online SLO *and* a
target offline throughput", replaying the peak window through the full
cluster (router + work stealing + per-replica scheduler/KV manager) on the
virtual clock. The search walks replica counts smallest→largest and, per
count, block budgets smallest→largest — the first configuration meeting
both targets is the recommended fleet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.cluster.simulator import ClusterSimulator, ClusterStats
from repro_torch.core.block_io import BlockIOSpec, paged_spec
from repro_torch.core.estimator import TimeModel
from repro_torch.core.policies import ECHO, PolicyConfig
from repro_torch.core.request import Request
from repro_torch.core.simulator import clone_requests


@dataclass
class FleetReport:
    min_replicas: Optional[int]
    blocks_per_replica: Optional[int]
    # every probed (replicas, blocks) -> min(TTFT, TPOT) attainment
    slo_by_config: List[Tuple[int, int, float]] = field(default_factory=list)
    # offline throughput of SLO-feasible configs:
    # (replicas, blocks, host_blocks, tok/s)
    throughput_by_config: List[Tuple[int, int, int, float]] = \
        field(default_factory=list)
    offline_throughput: Optional[float] = None
    host_blocks_per_replica: int = 0      # §5.4 extended: host-tier sizing
    host_bytes_per_replica: int = 0       # the same tier in link/RAM bytes


class FleetPlanner:
    def __init__(self, time_model: TimeModel, *,
                 policy: PolicyConfig = ECHO,
                 router_policy: str = "affinity",
                 clock_models: Optional[Sequence] = None,
                 block_size: int = 16, chunk_size: int = 64,
                 max_running: int = 64, seed: int = 0,
                 io_spec: Optional[BlockIOSpec] = None):
        """``clock_models``: per-replica ground-truth hardware profiles
        (cycled across the fleet) — plan over a *mixed-hardware* fleet, e.g.
        ``[TimeModel.a100(), TimeModel.h100()]``, while every replica's
        scheduler starts from the same ``time_model`` estimate (pair with a
        calibrating policy so each replica learns its own hardware).
        ``io_spec`` sets the fleet's block I/O family; host-tier budgets are
        priced through it (a host gigabyte holds far more state snapshots
        than paged KV pages)."""
        self.tm = time_model
        self.policy = policy
        self.router_policy = router_policy
        self.clock_models = list(clock_models) if clock_models else None
        self.block_size = block_size
        self.chunk_size = chunk_size
        self.max_running = max_running
        self.seed = seed
        self.io = io_spec or paged_spec()

    def host_blocks_for_bytes(self, n_bytes: float) -> int:
        """Host-tier slots a byte budget buys under this fleet's family:
        one slot parks one block's payload — ``io.block_bytes(block_size)``
        bytes of KV pages, or one fixed-size snapshot."""
        slot = max(self.io.block_bytes(self.block_size), 1)
        return int(n_bytes // slot)

    # ------------------------------------------------------------- probes
    def simulate(self, online: Sequence[Request], offline: Sequence[Request],
                 n_replicas: int, num_blocks: int, *,
                 host_blocks: int = 0,
                 duration: Optional[float] = None,
                 max_iters: int = 200_000) -> ClusterStats:
        sim = ClusterSimulator(n_replicas, self.policy,
                               router_policy=self.router_policy,
                               num_blocks=num_blocks,
                               block_size=self.block_size,
                               chunk_size=self.chunk_size,
                               max_running=self.max_running, seed=self.seed,
                               time_model=self.tm,
                               clock_models=self.clock_models,
                               host_kv_blocks=host_blocks,
                               io_spec=self.io)
        sim.submit_all(clone_requests(online) + clone_requests(offline))
        return sim.run(max_iters=max_iters, until_time=duration)

    def probe(self, online: Sequence[Request], offline: Sequence[Request],
              n_replicas: int, num_blocks: int, *, host_blocks: int = 0,
              duration: Optional[float] = None) -> Tuple[float, float]:
        """One configuration probe — THE shared sweep primitive under
        ``attainment_curve``, ``plan`` and the autoscaler's sizing oracle:
        replay the workload through a fleet of this shape and return
        (min(TTFT, TPOT) attainment, offline tok/s)."""
        stats = self.simulate(online, offline, n_replicas, num_blocks,
                              host_blocks=host_blocks, duration=duration)
        att = min(stats.slo_attainment("ttft"),
                  stats.slo_attainment("tpot"))
        return att, stats.offline_throughput()

    def attainment_curve(self, online: Sequence[Request], *,
                         candidate_replicas: Sequence[int] = (1, 2, 4),
                         num_blocks: int = 256,
                         duration: Optional[float] = None
                         ) -> List[Tuple[int, float]]:
        """min(TTFT, TPOT) attainment of the online peak vs. replica count
        at a fixed per-replica block budget (monotone non-decreasing: more
        replicas only ever dilute load)."""
        return [(n, self.probe(online, [], n, num_blocks,
                               duration=duration)[0])
                for n in sorted(candidate_replicas)]

    # ------------------------------------------------------------- planning
    def plan(self, online_peak: Sequence[Request],
             offline: Sequence[Request], *,
             candidate_replicas: Sequence[int] = (1, 2, 4),
             candidate_blocks: Sequence[int] = (64, 128, 256),
             candidate_host_blocks: Sequence[int] = (0,),
             candidate_host_bytes: Optional[Sequence[float]] = None,
             slo_target: float = 0.9,
             offline_target: Optional[float] = None,
             duration: Optional[float] = None) -> FleetReport:
        """Step 1: smallest fleet whose online attainment meets the target.
        Step 2: at each SLO-feasible config, measure co-served offline
        throughput; require ``offline_target`` too when given.

        ``candidate_host_blocks`` extends the §5.4 search to the host swap
        tier (replicas x device blocks x host blocks): host memory is far
        cheaper than HBM, so the planner prefers the smallest host tier that
        lifts a device-feasible config over the offline target before
        growing device blocks or the fleet.

        ``candidate_host_bytes`` states the same budgets in RAM bytes and
        overrides ``candidate_host_blocks``: each budget is converted to
        slots through the fleet's I/O family, so the identical byte ladder
        yields many more slots on a state-snapshot fleet than a paged one."""
        if candidate_host_bytes is not None:
            candidate_host_blocks = [self.host_blocks_for_bytes(b)
                                     for b in candidate_host_bytes]
        report = FleetReport(None, None)
        for n in sorted(candidate_replicas):
            for nb in sorted(candidate_blocks):
                att, _ = self.probe(online_peak, [], n, nb,
                                    duration=duration)
                report.slo_by_config.append((n, nb, att))
                if att < slo_target:
                    continue
                for hb in sorted(candidate_host_blocks):
                    _, tput = self.probe(online_peak, offline, n, nb,
                                         host_blocks=hb, duration=duration)
                    report.throughput_by_config.append((n, nb, hb, tput))
                    if offline_target is not None and tput < offline_target:
                        continue    # bigger cache/host tier may lift it
                    report.min_replicas = n
                    report.blocks_per_replica = nb
                    report.host_blocks_per_replica = hb
                    report.host_bytes_per_replica = \
                        hb * self.io.block_bytes(self.block_size)
                    report.offline_throughput = tput
                    return report
        return report
