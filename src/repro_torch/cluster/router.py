"""Cluster router: SLO-aware online placement + prefix-affinity offline
dispatch + work-stealing rebalancing.

Online requests always go to the replica with the lowest TimeModel-predicted
added latency (least-loaded in SLO terms) — online placement never degrades
to serve offline locality. Offline tasks are dispatched by the configured
policy:

  affinity     — route to the replica already holding the request's document
                 group (pooled peers, in-flight peers, or the cached prefix
                 itself); new groups go to the least-backlogged replica.
  round_robin  — cycle over replicas (the scatter baseline).
  random       — uniform random replica (seeded).

When a replica's online load spikes, ``rebalance`` sheds pooled offline work
(whole loner groups first) to the calmest replica — HyGen-style elastic
co-location: offline flows to wherever online load is momentarily low.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.cluster.replica import Replica, first_block_hash
from repro_torch.core.block_manager import prefix_chain
from repro_torch.core.request import Request

ROUTER_POLICIES = ("affinity", "round_robin", "random")


@dataclass
class RouterStats:
    online_dispatched: int = 0
    offline_dispatched: int = 0
    affinity_hits: int = 0         # offline dispatches that found a home group
    steals: int = 0                # rebalance events
    stolen_requests: int = 0
    steal_affinity_hits: int = 0   # stolen requests placed onto held KV
    migrations: int = 0            # cross-replica prefix shipments
    migrated_blocks: int = 0
    migrated_bytes: int = 0        # fabric bytes actually admitted
    per_replica_online: dict = field(default_factory=dict)
    per_replica_offline: dict = field(default_factory=dict)


class Router:
    def __init__(self, replicas: Sequence[Replica], *,
                 policy: str = "affinity", seed: int = 0,
                 steal_queue_depth: int = 4, steal_batch: int = 8,
                 migrate: bool = True):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"expected one of {ROUTER_POLICIES}")
        # membership is LIVE: the simulator owns (and mutates) this list as
        # replicas join and leave, so keep the caller's list object instead
        # of snapshotting it
        self.replicas = replicas if isinstance(replicas, list) \
            else list(replicas)
        self.policy = policy
        self.steal_queue_depth = steal_queue_depth
        self.steal_batch = steal_batch
        self.migrate = migrate     # ship parked prefixes on steal
        self._rng = np.random.default_rng(seed)
        self._rr = 0
        self.stats = RouterStats()
        self._block_size = self.replicas[0].engine.bm.block_size
        # observability taps (repro_torch.obs sets these): called per placement /
        # per stolen request with the engine-clock timestamp of the move
        self.on_dispatch = None   # (req, replica_id, t)
        self.on_steal = None      # (req, from_id, to_id, t)

    # ---------------------------------------------------------- membership
    def routable(self) -> list:
        """Replicas that may take new work (UP/DEGRADED)."""
        return [r for r in self.replicas if r.routable]

    # ------------------------------------------------------------- dispatch
    def dispatch(self, req: Request) -> Replica:
        if not self.routable():
            raise RuntimeError("no routable replica in the fleet "
                               "(all JOINING/DRAINING/DOWN)")
        if req.is_online:
            rep = self._place_online(req)
            self.stats.online_dispatched += 1
            self.stats.per_replica_online[rep.id] = \
                self.stats.per_replica_online.get(rep.id, 0) + 1
        else:
            rep = self._place_offline(req)
            self.stats.offline_dispatched += 1
            self.stats.per_replica_offline[rep.id] = \
                self.stats.per_replica_offline.get(rep.id, 0) + 1
        rep.submit(req)
        if self.on_dispatch is not None:
            self.on_dispatch(req, rep.id, rep.engine.now)
        return rep

    def _place_online(self, req: Request) -> Replica:
        return min(self.routable(),
                   key=lambda r: (r.predicted_added_latency(req), r.id))

    def _place_offline(self, req: Request) -> Replica:
        live = self.routable()
        if self.policy == "round_robin":
            rep = live[self._rr % len(live)]
            self._rr += 1
            return rep
        if self.policy == "random":
            return live[int(self._rng.integers(len(live)))]
        group = first_block_hash(req, self._block_size)
        # the affinity term sees pooled/in-flight peers, the device-cached
        # prefix, AND the host swap tier: a replica whose device cache was
        # flushed by a burst but whose host tier still parks the document
        # keeps attracting its group (restore over PCIe beats recompute).
        # The hash chain is replica-independent: compute it once per
        # dispatch, probe residency per replica.
        chain = (prefix_chain(req.full_tokens, self._block_size)
                 if group is not None else None)
        scored = [(rep.affinity(group, req, chain), rep)
                  for rep in live]
        best_aff = max(aff for aff, _ in scored)
        if best_aff > 0:
            self.stats.affinity_hits += 1
            # family-aware cost tie-break: at equal affinity and backlog,
            # prefer the replica whose parked prefix is cheapest to restore
            # (a state-family snapshot is one fixed upload; paged KV pays
            # per token — equal block counts are not equal link traffic)
            return min((rep for aff, rep in scored if aff == best_aff),
                       key=lambda r: (r.offline_backlog(),
                                      r.host_prefix_bytes(req, chain), r.id))
        # unseen group: open its home on the least-backlogged replica
        return min(live, key=lambda r: (r.offline_backlog(), r.id))

    # ------------------------------------------------------------ migration
    def _group_left_behind(self, rep: Replica, req: Request) -> bool:
        """Does ``rep`` still hold pooled / in-flight members of ``req``'s
        document group? If so its cached prefix must stay home."""
        group = first_block_hash(req, self._block_size)
        if group is None:
            return False
        eng = rep.engine
        if eng.pool.group_count(group) > 0:
            return True
        bs = self._block_size
        for r in eng.pending:
            if not r.is_online and first_block_hash(r, bs) == group:
                return True
        for r in eng.scheduler.running:
            if not r.is_online and first_block_hash(r, bs) == group:
                return True
        return False

    def migrate_prefix(self, frm: Replica, to: Replica, req: Request) -> int:
        """Ship ``req``'s parked prefix from ``frm`` to ``to`` over the
        inter-node fabric: the source exports the leading cached blocks
        (host tier or idle device copies) and the destination lands them in
        its host tier, where the ordinary swap-in path restores them instead
        of recomputing the prefix. The destination engine is charged
        ``migrate_time`` on its next iteration. Returns fabric bytes
        admitted; 0 when the destination has no host tier (nothing is
        exported, so nothing is lost)."""
        if to.engine.bm.host is None:
            return 0
        hbs, _ = frm.engine.export_prefix(req.full_tokens)
        if not hbs:
            return 0
        admitted = to.engine.import_prefix(hbs)
        self.stats.migrations += 1
        self.stats.migrated_blocks += len(hbs)
        self.stats.migrated_bytes += admitted
        return admitted

    # ------------------------------------------------------------- stealing
    def rebalance(self) -> int:
        """Shed pooled offline work from replicas whose online queue has
        spiked to calm replicas. Each stolen request is re-placed by host-
        tier-aware affinity — stealing moves work *toward* parked KV (a calm
        replica whose swap tier already holds the document's prefix wins
        over the merely least-loaded one), falling back to the calmest
        replica for groups nobody holds. When a steal empties a group at the
        source, the group's parked prefix is migrated to the target over the
        fabric (``migrate=True``) so the stolen work restores instead of
        recomputing. Only routable replicas participate. Returns requests
        moved."""
        moved_total = 0
        for rep in self.routable():
            if rep.online_queue_depth() < self.steal_queue_depth:
                continue
            if rep.offline_backlog() == 0:
                continue
            targets = [o for o in self.routable() if o is not rep
                       and o.online_queue_depth() < self.steal_queue_depth]
            if not targets:
                continue
            moved = rep.steal_offline(self.steal_batch)
            if not moved:
                continue
            calmest = min(targets, key=lambda o: (o.online_queue_depth(),
                                                  o.offline_backlog(), o.id))
            for req in moved:
                group = first_block_hash(req, self._block_size)
                chain = (prefix_chain(req.full_tokens, self._block_size)
                         if group is not None else None)
                scored = [(o.affinity(group, req, chain), o)
                          for o in targets]
                best_aff = max(aff for aff, _ in scored)
                if best_aff > 0:
                    target = min((o for aff, o in scored if aff == best_aff),
                                 key=lambda o: (o.online_queue_depth(),
                                                o.offline_backlog(),
                                                o.host_prefix_bytes(req,
                                                                    chain),
                                                o.id))
                    self.stats.steal_affinity_hits += 1
                else:
                    target = calmest
                target.submit(req)
                target.stolen_in += 1
                if self.migrate and target is not rep \
                        and not self._group_left_behind(rep, req):
                    self.migrate_prefix(rep, target, req)
                if self.on_steal is not None:
                    self.on_steal(req, rep.id, target.id, target.engine.now)
            self.stats.steals += 1
            self.stats.stolen_requests += len(moved)
            moved_total += len(moved)
        return moved_total
