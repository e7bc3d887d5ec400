"""Replica: one EchoEngine plus the load signals a cluster router reads.

A replica exports four signal families (ISSUE: cluster-scale co-serving):
  * online pressure     — queue depth + TimeModel-predicted added latency
  * memory headroom     — free KV blocks and eviction-threshold slack
  * offline backlog     — pooled + pending + running offline work
  * prefix locality     — the OfflinePool radix summary merged with what the
                          BlockManager actually holds cached, keyed by the
                          first-block chain hash of each document group

Replicas carry an explicit lifecycle (elastic-fleet refactor):

    JOINING -> UP <-> DEGRADED
                 \\-> DRAINING -> DOWN       (and UP/DEGRADED -> DOWN on kill)

Only UP/DEGRADED replicas are *routable*. DEGRADED wraps the ground-truth
clock in a ``DegradedClock`` slowdown (a straggler) without touching the
scheduler's estimate — the damage surfaces as clock skew, which the
router's ``predicted_added_latency`` already penalizes. DRAINING replicas
take no new work and go DOWN once empty; a killed replica's in-flight
requests are evacuated (KV reset) for re-dispatch elsewhere.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.block_io import BlockIOSpec
from repro_torch.core.block_manager import chain_hash, prefix_chain
from repro_torch.core.engine import EchoEngine
from repro_torch.core.estimator import DegradedClock, TimeModel
from repro_torch.core.policies import ECHO, PolicyConfig
from repro_torch.core.request import Request, RequestState


class ReplicaState(enum.Enum):
    JOINING = "joining"        # provisioning; not routable yet
    UP = "up"                  # healthy, routable
    DEGRADED = "degraded"      # straggler: routable, clock runs slow
    DRAINING = "draining"      # no new work; finishes what it holds
    DOWN = "down"              # out of the fleet (drained or killed)


def first_block_hash(req: Request, block_size: int) -> Optional[int]:
    """Top-level radix group key of a request (None if under one block)."""
    if len(req.prompt) < block_size:
        return None
    return chain_hash(0, tuple(req.prompt[:block_size]))


@dataclass
class ReplicaLoad:
    """Point-in-time snapshot of one replica's signals (for reporting)."""
    replica_id: int
    now: float
    online_queue: int
    running_online: int
    running_offline: int
    offline_backlog: int
    free_blocks: int
    threshold_headroom: int
    prefix_groups: Dict[int, int] = field(default_factory=dict)


class Replica:
    def __init__(self, replica_id: int, engine: EchoEngine,
                 state: "ReplicaState" = ReplicaState.UP):
        self.id = replica_id
        self.engine = engine
        self.stalls = 0            # consecutive no-progress steps (see sim)
        self.stolen_in = 0
        self.stolen_out = 0
        self.state = state
        self.slowdown = 1.0        # DEGRADED clock factor (1.0 = healthy)
        self.ready_time: Optional[float] = None   # JOINING -> UP instant
        self.t_up: Optional[float] = (0.0 if state == ReplicaState.UP
                                      else None)
        self.t_down: Optional[float] = None

    # ------------------------------------------------------------ lifecycle
    @property
    def routable(self) -> bool:
        """May the router place new work here? (UP or DEGRADED only —
        JOINING replicas are not ready, DRAINING/DOWN take no new work.)"""
        return self.state in (ReplicaState.UP, ReplicaState.DEGRADED)

    def mark_up(self, now: float) -> None:
        """JOINING -> UP: the replica's cold engine starts at cluster time
        (its virtual clock cannot lag the fleet it just joined)."""
        self.state = ReplicaState.UP
        self.ready_time = None
        if self.t_up is None:
            self.t_up = now
        self.engine.now = max(self.engine.now, now)

    def degrade(self, factor: float) -> None:
        """UP -> DEGRADED (or re-degrade): wrap the ground-truth clock so
        every observed iteration runs ``factor``x slower. The scheduler's
        estimate is untouched — a straggler does not know it is one."""
        if factor <= 1.0:
            self.restore()
            return
        base = self.engine.clock_model
        if isinstance(base, DegradedClock):
            base = base.base
        self.engine.clock_model = DegradedClock(base, slowdown=factor)
        self.slowdown = factor
        if self.state == ReplicaState.UP:
            self.state = ReplicaState.DEGRADED

    def restore(self) -> None:
        """DEGRADED -> UP: unwrap the slowdown."""
        if isinstance(self.engine.clock_model, DegradedClock):
            self.engine.clock_model = self.engine.clock_model.base
        self.slowdown = 1.0
        if self.state == ReplicaState.DEGRADED:
            self.state = ReplicaState.UP

    def begin_drain(self) -> None:
        """UP/DEGRADED -> DRAINING: no new dispatches; the replica keeps
        stepping until it holds no work, then the simulator marks it DOWN."""
        if self.state in (ReplicaState.UP, ReplicaState.DEGRADED,
                          ReplicaState.JOINING):
            self.state = ReplicaState.DRAINING

    def mark_down(self, now: float) -> None:
        self.state = ReplicaState.DOWN
        if self.t_down is None:
            self.t_down = now

    def replica_seconds(self, now: float) -> float:
        """Seconds this replica has been serving (UP instant to DOWN instant
        or ``now``) — the cost side of the autoscaling benchmark."""
        if self.t_up is None:
            return 0.0
        end = self.t_down if self.t_down is not None else now
        return max(end - self.t_up, 0.0)

    # ----------------------------------------------------------- evacuation
    def inflight_requests(self, include_running: bool = True
                          ) -> List[Request]:
        """Every unfinished request this replica is responsible for, online
        first (the re-dispatch order): scheduler queue, pending intake,
        radix pool, and — when ``include_running`` — the running batch."""
        eng = self.engine
        sched = eng.scheduler
        online: List[Request] = list(sched.online_queue)
        online += [r for r in eng.pending if r.is_online]
        offline: List[Request] = [r for r in eng.pending if not r.is_online]
        offline += list(self.engine.pool.requests())
        if include_running:
            online += [r for r in sched.running if r.is_online]
            offline += [r for r in sched.running if not r.is_online]
        return online + offline

    def evacuate(self, include_running: bool = True) -> List[Request]:
        """Pull unfinished requests out of this replica for re-dispatch
        elsewhere, releasing every resource they held here (KV blocks,
        owner pins, pool membership, runner state) and resetting their
        compute progress — exactly recompute-preemption semantics, so
        generated tokens are kept and re-prefilled at the new home and
        ``_fabricate``'s (rid, n_output) seeding continues deterministically.
        Online requests come first. With ``include_running=False`` (drain)
        the running batch stays and finishes here."""
        eng = self.engine
        sched = eng.scheduler
        out = self.inflight_requests(include_running)
        for req in out:
            if req in sched.online_queue:
                sched.online_queue.remove(req)
            if req in eng.pending:
                eng.pending.remove(req)
            if req in eng.pool:
                eng.pool.remove(req)
            if req in sched.running:
                sched.running.remove(req)
            if req.block_ids:
                eng.bm.free_request(req, eng.now, finished=True)
            eng.bm.release_owner_pins(req)
            if eng.runner is not None:
                eng.runner.release(req.rid)
            req.computed_tokens = 0
            req.prefill_target_len = 0
            req.state = RequestState.WAITING
        return out

    @classmethod
    def simulated(cls, replica_id: int, policy: PolicyConfig = ECHO, *,
                  num_blocks: int = 256, block_size: int = 16,
                  chunk_size: int = 64, time_model: Optional[TimeModel] = None,
                  clock_model=None,
                  max_batch_tokens: int = 2048, max_running: int = 64,
                  host_kv_blocks: int = 0, seed: int = 0,
                  io_spec: Optional[BlockIOSpec] = None,
                  state: "ReplicaState" = ReplicaState.UP) -> "Replica":
        """``time_model`` is this replica's *estimate* (what its scheduler
        believes); ``clock_model`` its ground-truth hardware profile — pass
        different ones per replica for a heterogeneous/miscalibrated fleet.
        ``host_kv_blocks`` sizes this replica's host KV swap tier and
        ``io_spec`` sets its block I/O family (paged KV pages vs. fixed-size
        state snapshots) — transfers are priced by the family's bytes."""
        eng = EchoEngine(None, None, policy, num_blocks=num_blocks,
                         block_size=block_size, chunk_size=chunk_size,
                         time_model=time_model, clock_model=clock_model,
                         clock="virtual",
                         seed=seed, max_batch_tokens=max_batch_tokens,
                         max_running=max_running,
                         host_kv_blocks=host_kv_blocks, io_spec=io_spec)
        return cls(replica_id, eng, state=state)

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        self.engine.submit(req)
        self.stalls = 0            # new work can unblock a drained replica

    # ------------------------------------------------------------- signals
    # (accounting lives on the engine — shared with serving backends)
    def has_work(self) -> bool:
        return self.engine.has_work()

    def online_queue_depth(self) -> int:
        return self.engine.online_queue_depth()

    def offline_backlog(self) -> int:
        return self.engine.offline_backlog()

    def threshold_headroom(self) -> int:
        bm = self.engine.bm
        return max(bm.threshold_blocks - bm.running_blocks, 0)

    def prefix_summary(self) -> Dict[int, int]:
        return self.engine.pool.prefix_summary()

    def host_prefix_blocks(self, req: Request,
                           chain: Optional[List[int]] = None) -> int:
        """Blocks of ``req``'s leading prefix parked on this replica's HOST
        tier beyond what is device-resident — prefix locality that survives
        an online burst flushing the device cache, restorable over PCIe
        instead of recomputed. A routing signal the device-only probe
        misses entirely. The router precomputes the request's hash
        ``chain`` once and shares it across replicas (the hashes are
        replica-independent; only residency differs)."""
        bm = self.engine.bm
        if bm.host is None or not bm.host.blocks:
            return 0
        if chain is None:
            chain = prefix_chain(req.full_tokens, bm.block_size)
        return bm.host_chain_blocks(chain, bm.device_chain_blocks(chain))

    def host_prefix_bytes(self, req: Request,
                          chain: Optional[List[int]] = None) -> int:
        """Link bytes to restore ``req``'s host-parked prefix, priced by
        this replica's block I/O family: a paged replica uploads every
        token's KV pages, a state-family replica uploads one fixed-size
        snapshot regardless of prefix depth (restore_last_only). The router
        uses this as a cost tie-break — equal block counts parked on a
        paged and a state replica are NOT equal link traffic."""
        bm = self.engine.bm
        blocks = self.host_prefix_blocks(req, chain)
        if blocks <= 0:
            return 0
        return bm.io.restore_bytes(blocks * bm.block_size, bm.block_size)

    def affinity(self, group_hash: Optional[int],
                 req: Optional[Request] = None,
                 chain: Optional[List[int]] = None) -> int:
        """How much of this document group the replica already holds:
        pooled members + in-flight members + the request's prefix blocks
        resident in the KV tiers. Given the candidate ``req`` itself, both
        tiers are counted *symmetrically at 1 per block* — device-cached
        blocks (reusable for free) and host-parked blocks (restorable over
        PCIe), device first in the chain walk, so a replica holding the
        document in device cache always scores at least as high as one
        that would have to swap it back in. Work stealing and the router
        thus steer work toward held KV wherever it lives. Without ``req``
        (legacy single-signal probe) the first block contributes +1 per
        tier it is resident in."""
        if group_hash is None:
            return 0
        eng = self.engine
        bs = eng.bm.block_size
        n = eng.pool.group_count(group_hash)
        for r in eng.pending:
            if not r.is_online and first_block_hash(r, bs) == group_hash:
                n += 1
        for r in eng.scheduler.running:
            if not r.is_online and first_block_hash(r, bs) == group_hash:
                n += 1
        if req is not None:
            if chain is None:
                chain = prefix_chain(req.full_tokens, bs)
            dev = eng.bm.device_chain_blocks(chain)
            n += dev + eng.bm.host_chain_blocks(chain, dev)
        else:
            if group_hash in eng.bm.hash_to_bid:
                n += 1
            if eng.bm.host is not None and group_hash in eng.bm.host:
                n += 1                 # first block parked host-side
        return n

    def predicted_added_latency(self, req: Request) -> float:
        """Replica-local time to this request's first token if placed here
        (see ``EchoEngine.predicted_first_token_latency``). Uses this
        replica's own — possibly online-calibrated — estimate model, so a
        slower (or drifted) replica correctly reports longer predicted
        latency to the router."""
        return self.engine.predicted_first_token_latency(req)

    def load(self) -> ReplicaLoad:
        sched = self.engine.scheduler
        return ReplicaLoad(
            replica_id=self.id,
            now=self.engine.now,
            online_queue=self.online_queue_depth(),
            running_online=sum(1 for r in sched.running if r.is_online),
            running_offline=sum(1 for r in sched.running if not r.is_online),
            offline_backlog=self.offline_backlog(),
            free_blocks=self.engine.bm.free_blocks,
            threshold_headroom=self.threshold_headroom(),
            prefix_groups=self.prefix_summary(),
        )

    # ------------------------------------------------------------- stealing
    def steal_offline(self, max_n: int) -> List[Request]:
        """Yield up to ``max_n`` pooled (not yet admitted) offline requests,
        whole loner groups first so the locality damage is minimal — the
        groups this replica holds most of stay home."""
        pool = self.engine.pool
        bs = self.engine.bm.block_size
        groups: Dict[int, List[Request]] = {}
        for req in pool.requests():
            key = pool.group_of(req)
            groups.setdefault(key if key is not None else -req.rid,
                              []).append(req)
        for req in self.engine.pending:           # dispatched, not yet pulled
            if not req.is_online:
                key = first_block_hash(req, bs)
                groups.setdefault(key if key is not None else -req.rid,
                                  []).append(req)
        out: List[Request] = []
        order = sorted(groups.values(),
                       key=lambda rs: (len(rs), min(r.rid for r in rs)))
        for reqs in order:
            for req in reqs:
                if len(out) >= max_n:
                    break
                if req in self.engine.pending:
                    self.engine.pending.remove(req)
                else:
                    pool.remove(req)
                out.append(req)
            if len(out) >= max_n:
                break
        self.stolen_out += len(out)
        return out
