"""FleetController: predictive autoscaling over the elastic fleet.

The controller closes the loop between §5.3's RatePredictor and the dynamic
membership operations: each tick it predicts the near-term online arrival
rate (mu + k·sigma over a sliding window), converts it into a desired
replica count through a per-replica capacity figure, and adds JOINING
replicas or drains the idlest one. The capacity figure comes from the same
sweep oracle the offline FleetPlanner uses (``FleetPlanner.probe``): replay
a single-replica peak and find the highest rate one replica sustains at the
SLO target — autoscaling is just capacity planning run continuously.

A reactive backstop rides the predictor: when the mean routable online
queue depth crosses ``queue_high`` the controller scales up even if the
predicted rate says otherwise (predictors lag bursts; queues do not).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.cluster.replica import ReplicaState
from repro_torch.core.estimator import RatePredictor
from repro_torch.core.request import Request


@dataclass
class FleetController:
    """Attach via ``ClusterSimulator(..., autoscaler=FleetController(...))``;
    the simulator schedules a tick every ``interval`` virtual seconds and
    feeds every online arrival into the predictor at dispatch time."""
    min_replicas: int = 1
    max_replicas: int = 4
    rate_per_replica: Optional[float] = None   # req/s one replica sustains
    interval: float = 5.0          # seconds between control ticks
    headroom: float = 1.2          # provision for 20% above predicted rate
    cooldown: float = 10.0         # min seconds between membership changes
    queue_high: int = 4            # reactive backstop: mean online queue
    window: float = 120.0          # predictor sliding window
    k_sigma: float = 2.0
    bin_s: float = 5.0             # predictor bin (match control cadence)
    decisions: List[Tuple[float, str, int]] = field(default_factory=list)
    rate_pred: RatePredictor = field(init=False)

    def __post_init__(self) -> None:
        self.rate_pred = RatePredictor(window=self.window,
                                       k_sigma=self.k_sigma)
        self._sim = None
        self._last_change = -math.inf

    # ------------------------------------------------------------- wiring
    def bind(self, sim) -> None:
        self._sim = sim

    def observe_arrival(self, t: float) -> None:
        self.rate_pred.observe(t)

    # ------------------------------------------------------------- sizing
    def calibrate(self, planner, online_sample: Sequence[Request], *,
                  num_blocks: int = 256, slo_target: float = 0.9,
                  duration: Optional[float] = None) -> float:
        """Derive ``rate_per_replica`` from the planner's sweep oracle:
        replay the sample through ONE replica (``FleetPlanner.probe``) and
        take its arrival rate if the SLO held, else scale it down by how
        many replicas ``plan`` says the sample needs. Returns the figure."""
        arrivals = sorted(r.arrival_time for r in online_sample)
        span = max(arrivals[-1] - arrivals[0], 1e-9) if len(arrivals) > 1 \
            else 1.0
        rate = len(arrivals) / span
        att, _ = planner.probe(online_sample, [], 1, num_blocks,
                               duration=duration)
        if att >= slo_target:
            self.rate_per_replica = rate
        else:
            report = planner.plan(
                online_sample, [],
                candidate_replicas=tuple(
                    range(1, max(self.max_replicas, 2) + 1)),
                candidate_blocks=(num_blocks,), slo_target=slo_target,
                duration=duration)
            need = report.min_replicas or self.max_replicas
            self.rate_per_replica = rate / max(need, 1)
        return self.rate_per_replica

    def desired_replicas(self, now: float) -> int:
        rate = self.rate_pred.predict_rate(now, bin_s=self.bin_s)
        if not self.rate_per_replica or self.rate_per_replica <= 0:
            return self.min_replicas
        need = math.ceil(rate * self.headroom / self.rate_per_replica)
        return max(self.min_replicas, min(need, self.max_replicas))

    # ------------------------------------------------------------- control
    def tick(self, now: float) -> None:
        sim = self._sim
        if sim is None:
            return
        live = [r for r in sim.replicas
                if r.routable or r.state == ReplicaState.JOINING]
        n = len(live)
        want = self.desired_replicas(now)
        routable = sim.router.routable()
        if routable:
            qdepth = sum(r.online_queue_depth() for r in routable) \
                / len(routable)
            if qdepth > self.queue_high:
                want = max(want, min(n + 1, self.max_replicas))
        if now - self._last_change < self.cooldown or want == n:
            return
        if want > n:
            for _ in range(want - n):
                sim.add_replica(now)
            self.decisions.append((now, "add", want - n))
            self._last_change = now
        else:
            # drain only truly idle replicas — never cut a queue loose
            idle = [r for r in routable
                    if r.online_queue_depth() == 0 and not r.has_work()]
            idle.sort(key=lambda r: (r.offline_backlog(), -r.id))
            dropped = 0
            for rep in idle[:n - want]:
                if sim.drain_replica(rep.id, now):
                    dropped += 1
            if dropped:
                self.decisions.append((now, "drain", dropped))
                self._last_change = now

    # ------------------------------------------------------------- results
    @property
    def n_added(self) -> int:
        return sum(k for _, op, k in self.decisions if op == "add")

    @property
    def n_drained(self) -> int:
        return sum(k for _, op, k in self.decisions if op == "drain")
