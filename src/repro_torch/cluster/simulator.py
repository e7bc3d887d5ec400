"""ClusterSimulator: a dynamic fleet of EchoEngine replicas on one shared
virtual clock.

Event loop (deterministic): the next event is the earliest of (a) a pending
arrival — dispatched through the Router using replica load at that instant —
(b) a step of the busy replica with the smallest virtual ``now`` (ties broken
by replica id), or (c) a scheduled *fleet event*: a chaos kill/degrade, a
JOINING replica becoming ready, or an autoscaler tick. Each replica's
iteration advances its own clock by the calibrated TimeModel, exactly the
§5.4 single-engine methodology (core/simulator.py) lifted fleet-wide;
periodic ``rebalance`` calls let the router shed offline work off replicas
whose online load spiked.

Membership is dynamic (elastic-fleet refactor): ``add_replica`` provisions a
JOINING replica that comes UP after ``join_delay``; ``drain_replica``
re-dispatches the victim's queued work (shipping parked prefixes over the
fabric) and lets it finish its running batch before going DOWN;
``kill_replica`` evacuates *everything* — KV is lost, so re-dispatched
requests recompute at their new home (online first, offline back through the
router into a surviving pool). ``ChaosConfig`` schedules kills and straggler
degradations; ``ClusterStats`` grows the recovery accounting the elasticity
benchmark gates on.
"""
from __future__ import annotations

import copy
import dataclasses
import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.replica import Replica, ReplicaState
from repro_torch.cluster.router import Router, RouterStats
from repro_torch.core.block_io import BlockIOSpec
from repro_torch.core.engine import MAX_STALLS, EngineStats
from repro_torch.core.estimator import PerturbedTimeModel, TimeModel
from repro_torch.core.policies import ECHO, PolicyConfig
from repro_torch.core.request import Request, RequestState


@dataclass
class ChaosConfig:
    """Failure/straggler injection schedule for a cluster run.

    ``kills``: (t, replica_id) — the replica dies at t; its in-flight
    requests are re-dispatched (recompute semantics, KV lost).
    ``degrades``: (t, replica_id, slowdown, duration) — the replica's
    ground-truth clock runs ``slowdown``x slower for ``duration`` seconds,
    then restores. Explicit schedules keep runs deterministic; ``sample``
    draws one from seeded rates."""
    kills: List[Tuple[float, int]] = field(default_factory=list)
    degrades: List[Tuple[float, int, float, float]] = \
        field(default_factory=list)
    seed: int = 0

    @classmethod
    def sample(cls, n_replicas: int, duration: float, *, seed: int = 0,
               kill_prob: float = 0.0, degrade_prob: float = 0.0,
               slowdown: float = 3.0,
               degrade_duration: float = 10.0) -> "ChaosConfig":
        """Draw a schedule: each replica independently suffers at most one
        kill (probability ``kill_prob``) or one degradation episode
        (``degrade_prob``), at a uniform instant within the run."""
        rng = np.random.default_rng(seed)
        kills, degrades = [], []
        for i in range(n_replicas):
            u = rng.random()
            t = float(rng.uniform(0.1 * duration, 0.9 * duration))
            if u < kill_prob:
                kills.append((t, i))
            elif u < kill_prob + degrade_prob:
                degrades.append((t, i, slowdown, degrade_duration))
        return cls(kills=kills, degrades=degrades, seed=seed)


@dataclass
class KillRecord:
    """Recovery accounting for one replica kill."""
    t: float
    replica_id: int
    redispatched_online: int
    redispatched_offline: int
    lost_tokens: int               # computed KV tokens discarded at the kill
    rids: List[int] = field(default_factory=list)


@dataclass
class ClusterStats:
    """Fleet-wide aggregate over per-replica EngineStats."""
    replicas: List[EngineStats] = field(default_factory=list)
    router: RouterStats = field(default_factory=RouterStats)
    aborted_undispatched: List[Request] = field(default_factory=list)
    kills: List[KillRecord] = field(default_factory=list)
    lifecycle: List[Tuple[float, int, str]] = field(default_factory=list)
    replica_seconds: float = 0.0   # fleet cost: sum of UP..DOWN spans
    _merged: Optional[EngineStats] = field(default=None, init=False,
                                           repr=False, compare=False)

    def merged(self) -> EngineStats:
        if self._merged is None:
            m = EngineStats()
            for st in self.replicas:
                m.iterations.extend(st.iterations)
                m.finished.extend(st.finished)
                m.aborted.extend(st.aborted)
            m.aborted.extend(self.aborted_undispatched)
            m.iterations.sort(key=lambda rec: rec.t)
            self._merged = m
        return self._merged

    def offline_throughput(self) -> float:
        """Fleet offline throughput: completed offline tokens over the
        offline makespan across all replicas."""
        return self.merged().offline_throughput()

    def slo_attainment(self, kind: str = "ttft") -> float:
        return self.merged().slo_attainment(kind)

    def swap_hidden_frac(self) -> float:
        """Fleet-wide fraction of PCIe swap traffic hidden under compute
        (0.0 when serial or swap-free; see EngineStats.swap_hidden_frac)."""
        return self.merged().swap_hidden_frac()

    def finished_counts(self) -> Tuple[int, int]:
        m = self.merged()
        on = sum(1 for r in m.finished if r.is_online)
        off = len(m.finished) - on
        return on, off

    def per_replica_offline_tokens(self) -> List[int]:
        return [sum(r.prompt_len + r.n_output
                    for r in st.finished if not r.is_online)
                for st in self.replicas]

    # -------------------------------------------------------- recovery
    @property
    def redispatched_online(self) -> int:
        return sum(k.redispatched_online for k in self.kills)

    @property
    def redispatched_offline(self) -> int:
        return sum(k.redispatched_offline for k in self.kills)

    @property
    def lost_tokens(self) -> int:
        return sum(k.lost_tokens for k in self.kills)

    def recovery_latencies(self) -> List[float]:
        """Kill-to-finish seconds of every re-dispatched request that did
        finish — the tail of these is what a mid-run failure costs."""
        by_rid = {r.rid: r for r in self.merged().finished}
        out: List[float] = []
        for k in self.kills:
            for rid in k.rids:
                r = by_rid.get(rid)
                if r is not None and r.finish_time is not None:
                    out.append(r.finish_time - k.t)
        return out


class ClusterSimulator:
    def __init__(self, n_replicas: int, policy: PolicyConfig = ECHO, *,
                 router_policy: str = "affinity",
                 num_blocks: int = 256, block_size: int = 16,
                 chunk_size: int = 64,
                 time_model: Optional[TimeModel] = None,
                 clock_models: Optional[Sequence] = None,
                 max_batch_tokens: int = 2048, max_running: int = 64,
                 host_kv_blocks: int = 0,
                 io_spec: Optional[BlockIOSpec] = None,
                 seed: int = 0, steal_queue_depth: int = 4,
                 steal_batch: int = 8, rebalance_every: int = 8,
                 chaos: Optional[ChaosConfig] = None,
                 autoscaler=None, join_delay: float = 1.0,
                 migrate: bool = True):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        tm = time_model or TimeModel()
        # Each replica owns a *copy* of the estimate model: with online
        # calibration the estimates drift apart per replica (heterogeneous
        # fleets), and even without it a shared mutable model would couple
        # replicas. ``clock_models`` (cycled when shorter than the fleet)
        # sets per-replica ground-truth hardware profiles; None keeps the
        # classic perfect-estimate simulator. The factory parameters are
        # kept so ``add_replica`` can provision identical members later.
        self._policy = policy
        self._tm_template = tm
        self._clock_models = clock_models
        self._factory_kw = dict(num_blocks=num_blocks, block_size=block_size,
                                chunk_size=chunk_size,
                                max_batch_tokens=max_batch_tokens,
                                max_running=max_running,
                                host_kv_blocks=host_kv_blocks,
                                io_spec=io_spec)
        self._seed = seed
        self.replicas = [self._make_replica(i) for i in range(n_replicas)]
        self._next_id = n_replicas
        self.migrate = migrate
        self.join_delay = join_delay
        self.router = Router(self.replicas, policy=router_policy, seed=seed,
                             steal_queue_depth=steal_queue_depth,
                             steal_batch=steal_batch, migrate=migrate)
        self.rebalance_every = rebalance_every
        self._pending: List[Tuple[float, int, Request]] = []   # arrival heap
        self.aborted_undispatched: List[Request] = []
        self._steps = 0
        self.now = 0.0                 # latest event instant processed
        # fleet events: (t, seq, kind, payload) — chaos kills/degrades,
        # join-ready transitions, autoscaler ticks
        self._events: List[Tuple[float, int, str, tuple]] = []
        self._eseq = itertools.count()
        self.kills: List[KillRecord] = []
        self.lifecycle_log: List[Tuple[float, int, str]] = []
        # observability tap (repro_torch.obs.trace sets this): every lifecycle
        # transition as (replica_id, state_name, t)
        self.on_lifecycle: Optional[Callable[[int, str, float], None]] = None
        self.chaos = chaos
        if chaos is not None:
            for t, rid in chaos.kills:
                self._push_event(t, "kill", (rid,))
            for t, rid, factor, dur in chaos.degrades:
                self._push_event(t, "degrade", (rid, factor))
                self._push_event(t + dur, "restore", (rid,))
        self.autoscaler = autoscaler
        if autoscaler is not None:
            autoscaler.bind(self)
            self._push_event(autoscaler.interval, "autoscale", ())

    def _make_replica(self, i: int,
                      state: ReplicaState = ReplicaState.UP) -> Replica:
        def clock_for(idx: int):
            if not self._clock_models:
                return None
            cm = self._clock_models[idx % len(self._clock_models)]
            if isinstance(cm, PerturbedTimeModel):
                # independent noise streams even when profiles are cycled
                cm = dataclasses.replace(cm, seed=cm.seed + idx)
            return cm

        return Replica.simulated(i, self._policy,
                                 time_model=copy.deepcopy(self._tm_template),
                                 clock_model=clock_for(i),
                                 seed=self._seed + i, state=state,
                                 **self._factory_kw)

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        heapq.heappush(self._pending, (req.arrival_time, req.rid, req))

    def submit_all(self, reqs: Sequence[Request]) -> None:
        for r in reqs:
            self.submit(r)

    # --------------------------------------------------------- membership
    def _lifecycle(self, rep: Replica, t: float) -> None:
        self.lifecycle_log.append((t, rep.id, rep.state.value))
        if self.on_lifecycle is not None:
            self.on_lifecycle(rep.id, rep.state.value, t)

    def _by_id(self, replica_id: int) -> Replica:
        for rep in self.replicas:
            if rep.id == replica_id:
                return rep
        raise KeyError(f"no replica {replica_id} in the fleet")

    def _push_event(self, t: float, kind: str, payload: tuple) -> None:
        heapq.heappush(self._events, (t, next(self._eseq), kind, payload))

    def add_replica(self, now: Optional[float] = None) -> Replica:
        """Provision a new JOINING replica; it becomes UP (routable) after
        ``join_delay`` seconds of cluster time."""
        now = self.now if now is None else now
        rep = self._make_replica(self._next_id, state=ReplicaState.JOINING)
        self._next_id += 1
        rep.engine.now = now
        rep.ready_time = now + self.join_delay
        self.replicas.append(rep)        # the router holds this same list
        self._push_event(rep.ready_time, "join_ready", (rep.id,))
        self._lifecycle(rep, now)
        return rep

    def drain_replica(self, replica_id: int,
                      now: Optional[float] = None) -> bool:
        """Gracefully remove a replica: it takes no new work, its *queued*
        requests are re-dispatched through the router (parked prefixes
        shipped over the fabric when ``migrate``), its running batch
        finishes locally, and the event loop marks it DOWN once empty.
        Refuses (returns False) when it is the last routable replica."""
        rep = self._by_id(replica_id)
        if not rep.routable and rep.state != ReplicaState.JOINING:
            return False
        live = self.router.routable()
        if len(live) <= 1 and rep in live:
            return False                 # never drain the last home of work
        now = self.now if now is None else now
        rep.restore()                    # unwrap any straggler clock
        rep.begin_drain()
        self._lifecycle(rep, now)
        for req in rep.evacuate(include_running=False):
            target = self.router.dispatch(req)
            if self.migrate and not req.is_online and target is not rep:
                self.router.migrate_prefix(rep, target, req)
        return True

    def kill_replica(self, replica_id: int,
                     now: Optional[float] = None) -> Optional[KillRecord]:
        """Fail a replica abruptly: its KV (device and host tier) is lost
        and every in-flight request is re-dispatched with recompute
        semantics — online first through SLO-aware placement, offline back
        into a surviving pool. With no routable survivor the requests
        re-enter the arrival heap and dispatch when a JOINING replica comes
        up. Returns the recovery record (None if already DOWN)."""
        rep = self._by_id(replica_id)
        if rep.state == ReplicaState.DOWN:
            return None
        now = self.now if now is None else now
        lost = sum(r.computed_tokens
                   for r in rep.inflight_requests(include_running=True))
        evacuated = rep.evacuate(include_running=True)
        rep.mark_down(now)
        self._lifecycle(rep, now)
        n_online = sum(1 for r in evacuated if r.is_online)
        record = KillRecord(t=now, replica_id=rep.id,
                            redispatched_online=n_online,
                            redispatched_offline=len(evacuated) - n_online,
                            lost_tokens=lost,
                            rids=[r.rid for r in evacuated])
        self.kills.append(record)
        if self.router.routable():
            for req in evacuated:        # online first (evacuate's order)
                self.router.dispatch(req)
        else:
            for req in evacuated:
                heapq.heappush(self._pending,
                               (max(req.arrival_time, now), req.rid, req))
        return record

    def degrade_replica(self, replica_id: int, slowdown: float,
                        now: Optional[float] = None) -> None:
        rep = self._by_id(replica_id)
        if rep.state == ReplicaState.DOWN:
            return
        now = self.now if now is None else now
        rep.degrade(slowdown)
        self._lifecycle(rep, now)

    def restore_replica(self, replica_id: int,
                        now: Optional[float] = None) -> None:
        rep = self._by_id(replica_id)
        if rep.state != ReplicaState.DEGRADED:
            return
        now = self.now if now is None else now
        rep.restore()
        self._lifecycle(rep, now)

    def _apply_event(self, t: float, kind: str, payload: tuple) -> None:
        if kind == "kill":
            self.kill_replica(payload[0], t)
        elif kind == "degrade":
            self.degrade_replica(payload[0], payload[1], t)
        elif kind == "restore":
            self.restore_replica(payload[0], t)
        elif kind == "join_ready":
            rep = self._by_id(payload[0])
            if rep.state == ReplicaState.JOINING:
                rep.mark_up(t)
                self._lifecycle(rep, t)
        elif kind == "autoscale":
            if self.autoscaler is not None:
                self.autoscaler.tick(t)
                self._push_event(t + self.autoscaler.interval,
                                 "autoscale", ())

    # ------------------------------------------------------------- loop
    def _busy(self) -> List[Replica]:
        return [r for r in self.replicas
                if r.state != ReplicaState.DOWN
                and r.has_work() and r.stalls <= MAX_STALLS]

    def _sweep_drained(self) -> None:
        for rep in self.replicas:
            if rep.state == ReplicaState.DRAINING and not rep.has_work():
                rep.engine.flush_swaps()
                rep.mark_down(max(rep.engine.now, self.now))
                self._lifecycle(rep, rep.t_down)

    def step_event(self, until_time: Optional[float] = None) -> bool:
        """Advance the cluster by ONE event — dispatch the earliest pending
        arrival, apply the earliest fleet event (chaos / join / autoscale
        tick), or step the busy replica with the smallest virtual clock.
        Returns False when nothing is left to do (or the next event lies past
        ``until_time``). ``run`` is a loop over this; the serving facade uses
        it as the cluster's low-level stepping primitive."""
        self._sweep_drained()
        busy = self._busy()
        t_arr = self._pending[0][0] if self._pending else None
        if not busy and t_arr is None:
            # fleet events alone cannot create work: nothing left to do
            return False
        t_busy = min((r.engine.now for r in busy), default=float("inf"))
        t_evt = self._events[0][0] if self._events else float("inf")
        t_next = min(t_busy, t_evt) if t_arr is None \
            else min(t_busy, t_evt, t_arr)
        if until_time is not None and t_next >= until_time:
            return False
        self.now = max(self.now, t_next)
        if t_evt <= t_busy and (t_arr is None or t_evt <= t_arr):
            t, _, kind, payload = heapq.heappop(self._events)
            self._apply_event(t, kind, payload)
            return True
        if t_arr is not None and t_arr <= t_busy:
            if not self.router.routable():
                # hold the arrival: a pending fleet event may bring a
                # JOINING replica up, and draining replicas still need to
                # finish — otherwise the fleet is dead and we stop
                if self._events:
                    return self._pop_apply_event()
                if busy:
                    return self._step_busy(busy)
                return False
            _, _, req = heapq.heappop(self._pending)
            if self.autoscaler is not None and req.is_online:
                self.autoscaler.observe_arrival(req.arrival_time)
            self.router.dispatch(req)
            return True
        return self._step_busy(busy)

    def _pop_apply_event(self) -> bool:
        t, _, kind, payload = heapq.heappop(self._events)
        self.now = max(self.now, t)
        self._apply_event(t, kind, payload)
        return True

    def _step_busy(self, busy: List[Replica]) -> bool:
        if not busy:
            return False
        rep = min(busy, key=lambda r: (r.engine.now, r.id))
        before = rep.engine.now
        rec = rep.engine.step()
        if rec is None and not rep.engine.pending \
                and rep.engine.now <= before:
            rep.stalls += 1             # unschedulable backlog: back off
        else:
            rep.stalls = 0
        self.now = max(self.now, rep.engine.now)
        self._steps += 1
        if self._steps % self.rebalance_every == 0:
            self.router.rebalance()
        return True

    def abort(self, req: Request) -> bool:
        """Cancel a request wherever it lives: still undispatched in the
        arrival heap, or inside whichever replica the router placed it on."""
        for i, (_, _, r) in enumerate(self._pending):
            if r is req:
                self._pending.pop(i)
                heapq.heapify(self._pending)
                req.state = RequestState.ABORTED
                self.aborted_undispatched.append(req)
                return True
        return any(rep.engine.abort(req) for rep in self.replicas)

    def run(self, max_iters: int = 200_000,
            until_time: Optional[float] = None) -> ClusterStats:
        for _ in range(max_iters):
            if not self.step_event(until_time):
                break
        self._sweep_drained()
        return self.stats()

    # ------------------------------------------------------------- results
    def fleet_now(self) -> float:
        """Latest instant the cluster has reached."""
        return max([self.now] + [r.engine.now for r in self.replicas])

    def replica_seconds(self) -> float:
        now = self.fleet_now()
        return sum(rep.replica_seconds(now) for rep in self.replicas)

    def stats(self) -> ClusterStats:
        return ClusterStats(replicas=[r.engine.stats for r in self.replicas],
                            router=self.router.stats,
                            aborted_undispatched=list(
                                self.aborted_undispatched),
                            kills=list(self.kills),
                            lifecycle=list(self.lifecycle_log),
                            replica_seconds=self.replica_seconds())
