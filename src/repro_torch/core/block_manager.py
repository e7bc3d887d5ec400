"""Task-aware paged KV cache manager (paper §4.2) with a host swap tier.

Block-granular KV cache with hash-based automatic prefix caching (vLLM APC
style) and *priority + LRU* eviction:

  running online tokens        priority = +inf   (ref'd: never evictable)
  preempted online tokens      priority = 1e9
  offline tokens, rc > 0       priority = rc     (future reuse; includes the
                                                  unfinished owner itself)
  finished online tokens       priority = 0.5
  offline tokens, rc == 0      priority = 0

plus a *threshold* capping the blocks held by running requests, reserving
headroom for bursty online arrivals (set by the memory predictor, §5.3).
With ``task_aware=False`` the manager degenerates to vLLM's plain LRU free
table (the BS baseline).

The optional **host tier** (``HostTier``) is a bounded, hash-addressed,
CPU-resident second level: blocks whose priority justifies it (future reuse
rc > 0, or a preempted online owner that will return) are *swapped out* on
eviction instead of dropped, and ``swap_in`` restores a leading prefix over
PCIe instead of recomputing it. The manager only does the bookkeeping and
journals (bid, hash) swap events; the engine stages the actual payloads
against the runner (``drain_swap_events``) and the scheduler decides
swap-in vs. recompute per candidate using the TimeModel's transfer terms.

The manager is runner-family agnostic: a ``BlockIOSpec`` prices what a
block's payload weighs in bytes (paged KV pages scale with tokens; a
recurrent-state snapshot is one fixed-size pytree per boundary), and for
``restore_last_only`` families ``swap_in`` uploads only the last boundary's
snapshot — earlier blocks re-register as ``"in_lazy"`` journal events whose
payload lands host-side without touching the PCIe link.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.block_io import BlockIOSpec, paged_spec
from repro_torch.core.request import Request, TaskType

ONLINE_PREEMPTED_PRIORITY = 1e9
ONLINE_FINISHED_PRIORITY = 0.5
SWAP_MIN_PRIORITY = 1.0       # swap out only blocks with forward reuse


def chain_hash(prev: int, tokens: Tuple[int, ...]) -> int:
    return hash((prev, tokens))


def prefix_chain(tokens: Sequence[int], block_size: int) -> List[int]:
    """Cumulative chain hashes of every full block of ``tokens``. Computed
    once per request and shared across residency probes — the cluster
    router scores one request against every replica, and rehashing the
    same prefix per replica made affinity O(replicas x prompt-blocks)."""
    prev = 0
    out: List[int] = []
    for bi in range(len(tokens) // block_size):
        prev = chain_hash(prev,
                          tuple(tokens[bi * block_size:(bi + 1) * block_size]))
        out.append(prev)
    return out


@dataclass
class Block:
    bid: int
    hash: Optional[int] = None           # set once full & committed
    ref: int = 0
    lat: float = 0.0                     # last access time
    task_type: TaskType = TaskType.OFFLINE
    unfinished_owners: int = 0           # preempted owners that will return
    n_tokens: int = 0                    # valid tokens in this block


@dataclass
class HostBlock:
    """One hash-addressed KV block resident in host memory. ``payload`` is
    the per-layer KV content on the real-runner path (staged by the engine
    via ``PagedRunner.read_block``); None on the virtual path."""
    hash: int
    n_tokens: int
    task_type: TaskType
    unfinished_owners: int = 0
    lat: float = 0.0
    payload: Optional[object] = None
    n_bytes: int = 0                     # link weight per the family's io spec


class HostTier:
    """Bounded host-memory swap space, hash-addressed, priority-evicted.

    Mirrors the device tier's lazy-heap (priority, LAT) eviction order so
    the least valuable host block is dropped first when the tier overflows.
    ``reserve`` slots are kept clear of low-priority (non-preempted-online)
    blocks — the memory predictor sizes this headroom so a predicted online
    burst can always swap its preempted KV out instead of losing it.
    """

    def __init__(self, capacity_blocks: int,
                 priority_of: Optional[Callable[["HostBlock"], float]] = None):
        self.capacity = capacity_blocks
        self.priority_of = priority_of or (lambda hb: 1.0)
        self.blocks: Dict[int, HostBlock] = {}
        self._heap: List[Tuple[float, float, int, int]] = []  # lazy entries
        self._seq = itertools.count()
        self.reserve = 0                 # slots kept free for bursty swaps

    def __len__(self) -> int:
        return len(self.blocks)

    def __contains__(self, h: int) -> bool:
        return h in self.blocks

    def get(self, h: int) -> Optional[HostBlock]:
        return self.blocks.get(h)

    def _push(self, hb: HostBlock) -> None:
        heapq.heappush(self._heap, (self.priority_of(hb), hb.lat,
                                    next(self._seq), hb.hash))

    def _evict_one(self) -> Optional[HostBlock]:
        while self._heap:
            prio, lat, _, h = heapq.heappop(self._heap)
            hb = self.blocks.get(h)
            if hb is None:
                continue                                  # stale entry
            cur = (self.priority_of(hb), hb.lat)
            if (prio, lat) != cur:                        # stale meta: refresh
                self._push(hb)
                continue
            del self.blocks[h]
            return hb
        return None

    def admit(self, hb: HostBlock) -> bool:
        """Insert ``hb``, evicting lower-(priority, LAT) residents if full.
        Returns False when the candidate itself is the least valuable (it
        bounces) or the tier has no capacity. Low-priority candidates may
        only fill ``capacity - reserve`` slots."""
        cap = self.capacity
        if self.priority_of(hb) < ONLINE_PREEMPTED_PRIORITY:
            cap = max(cap - self.reserve, 0)
        if cap <= 0:
            return False
        key = (self.priority_of(hb), hb.lat)
        while len(self.blocks) >= cap:
            victim = self._evict_one()
            if victim is None:
                break
            if (self.priority_of(victim), victim.lat) > key:
                self.blocks[victim.hash] = victim         # keep; hb bounces
                self._push(victim)
                return False
        old = self.blocks.get(hb.hash)
        if old is not None:
            hb.unfinished_owners += old.unfinished_owners
        self.blocks[hb.hash] = hb
        self._push(hb)
        return True

    def pop(self, h: int) -> Optional[HostBlock]:
        return self.blocks.pop(h, None)                   # heap entry lazies


@dataclass
class BlockManagerMetrics:
    hit_blocks: int = 0
    lookup_blocks: int = 0
    offline_hit_blocks: int = 0
    offline_lookup_blocks: int = 0
    evictions: int = 0
    punished_tokens: int = 0             # evicted tokens needed in the future
    swapped_out_blocks: int = 0
    swapped_out_tokens: int = 0
    swapped_out_bytes: int = 0           # PCIe traffic parked to the host
    swapped_in_blocks: int = 0
    swapped_in_tokens: int = 0           # recompute avoided via host tier
    swapped_in_bytes: int = 0            # PCIe traffic restored (lazy = free)
    host_bounced_blocks: int = 0         # refused by the full host tier
    migrated_out_blocks: int = 0         # shipped to another replica
    migrated_out_bytes: int = 0
    migrated_in_blocks: int = 0          # received from another replica
    migrated_in_bytes: int = 0
    migrate_bounced_blocks: int = 0      # arrivals refused by the host tier

    @property
    def hit_rate(self) -> float:
        return self.hit_blocks / self.lookup_blocks if self.lookup_blocks else 0.0

    @property
    def offline_hit_rate(self) -> float:
        """Fig.9's metric: prefix-cache hit ratio of offline prefills."""
        if not self.offline_lookup_blocks:
            return 0.0
        return self.offline_hit_blocks / self.offline_lookup_blocks


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int, *,
                 task_aware: bool = True,
                 rc_provider: Optional[Callable[[int], int]] = None,
                 host_blocks: int = 0,
                 io: Optional[BlockIOSpec] = None):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.io = io or paged_spec()
        self.task_aware = task_aware
        self.rc_provider = rc_provider or (lambda h: 0)
        self.blocks: List[Block] = [Block(i) for i in range(num_blocks)]
        self.free: List[int] = list(range(num_blocks))   # never-used / cleared
        self.hash_to_bid: Dict[int, int] = {}
        self._heap: List[Tuple[float, float, int, int]] = []  # lazy entries
        self._seq = itertools.count()
        self.threshold_blocks = num_blocks               # running-KV cap
        self.metrics = BlockManagerMetrics()
        self.host: Optional[HostTier] = (
            HostTier(host_blocks, self._host_priority)
            if host_blocks > 0 else None)
        # journal of ("out"|"in", bid, HostBlock) in decision order; the
        # engine drains it after scheduling, before the runner writes any
        # pages, staging payloads on the journaled HostBlock objects
        self._swap_events: List[Tuple[str, int, HostBlock]] = []

    # ------------------------------------------------------------- stats
    @property
    def running_blocks(self) -> int:
        return sum(1 for b in self.blocks if b.ref > 0)

    @property
    def cached_blocks(self) -> int:
        return sum(1 for b in self.blocks if b.ref == 0 and b.hash is not None)

    @property
    def free_blocks(self) -> int:
        return len(self.free)

    def usage_breakdown(self) -> Dict[str, int]:
        """For the Fig.10 memory-occupancy benchmark."""
        out = {"running_online": 0, "running_offline": 0,
               "free_online": 0, "free_offline": 0, "unused": len(self.free)}
        for b in self.blocks:
            if b.ref > 0:
                key = "running_online" if b.task_type == TaskType.ONLINE else "running_offline"
                out[key] += 1
            elif b.hash is not None:
                key = "free_online" if b.task_type == TaskType.ONLINE else "free_offline"
                out[key] += 1
        return out

    def occupancy_snapshot(self) -> Dict[str, int]:
        """Gauge-friendly occupancy view for the observability probes:
        device free / running / cached block counts, the §5.3 running-KV
        cap, and the host tier's fill (zero capacity when no tier)."""
        return {
            "free": len(self.free),
            "running": self.running_blocks,
            "cached": self.cached_blocks,
            "threshold": self.threshold_blocks,
            "total": self.num_blocks,
            "host_used": len(self.host) if self.host is not None else 0,
            "host_capacity": (self.host.capacity
                              if self.host is not None else 0),
            "host_reserve": (self.host.reserve
                             if self.host is not None else 0),
        }

    # ------------------------------------------------------------- priority
    def _priority(self, blk: Block) -> float:
        if not self.task_aware:
            return 0.0                                    # pure LRU
        rc = self.rc_provider(blk.hash) + blk.unfinished_owners if blk.hash is not None else 0
        if blk.task_type == TaskType.ONLINE:
            if blk.unfinished_owners:
                return ONLINE_PREEMPTED_PRIORITY
            return ONLINE_FINISHED_PRIORITY
        return float(rc)

    def _host_priority(self, hb: HostBlock) -> float:
        """HostBlock analogue of ``_priority`` (shared rc provider)."""
        rc = self.rc_provider(hb.hash) + hb.unfinished_owners
        if hb.task_type == TaskType.ONLINE:
            if hb.unfinished_owners:
                return ONLINE_PREEMPTED_PRIORITY
            return ONLINE_FINISHED_PRIORITY
        return float(rc)

    def _push_evictable(self, blk: Block) -> None:
        heapq.heappush(self._heap, (self._priority(blk), blk.lat,
                                    next(self._seq), blk.bid))

    # ------------------------------------------------------------- probing
    def probe_prefix(self, tokens: Sequence[int]) -> int:
        """Longest cached full-block prefix (in tokens). Read-only."""
        n, prev, cached = 0, 0, 0
        bs = self.block_size
        while n + bs <= len(tokens):
            h = chain_hash(prev, tuple(tokens[n: n + bs]))
            if h not in self.hash_to_bid:
                break
            prev = h
            n += bs
            cached += bs
        return cached

    def device_chain_blocks(self, chain: Sequence[int]) -> int:
        """Leading blocks of a precomputed hash chain resident on device
        (``probe_prefix`` in block units, minus the rehash). Read-only."""
        n = 0
        for h in chain:
            if h not in self.hash_to_bid:
                break
            n += 1
        return n

    def host_chain_blocks(self, chain: Sequence[int],
                          start_block: int) -> int:
        """Blocks of a precomputed chain restorable by swap-in from
        ``start_block``: resident in the host tier but NOT on device
        (``probe_host_prefix`` in block units, minus the rehash)."""
        if self.host is None or not self.host.blocks:
            return 0
        n = 0
        for h in chain[start_block:]:
            if h in self.hash_to_bid or h not in self.host:
                break
            n += 1
        return n

    def probe_host_prefix(self, tokens: Sequence[int], start_tokens: int) -> int:
        """Tokens restorable by swap-in: the longest run of consecutive full
        blocks starting at ``start_tokens`` (block-aligned) that are resident
        in the host tier but NOT on device. Read-only — the scheduler uses
        this to price swap-in vs. recompute before committing."""
        if self.host is None or not self.host.blocks:
            return 0                 # cold tier: skip the chain rehash
        bs = self.block_size
        if start_tokens % bs != 0:
            return 0
        prev = 0
        for bi in range(start_tokens // bs):
            if (bi + 1) * bs > len(tokens):
                return 0
            prev = chain_hash(prev, tuple(tokens[bi * bs:(bi + 1) * bs]))
        n = start_tokens
        restorable = 0
        while n + bs <= len(tokens):
            h = chain_hash(prev, tuple(tokens[n: n + bs]))
            if h in self.hash_to_bid or h not in self.host:
                break
            prev = h
            n += bs
            restorable += bs
        return restorable

    def swap_in(self, req: Request, tokens: Sequence[int], now: float,
                max_tokens: int, *, respect_threshold: bool = True) -> int:
        """Restore up to ``max_tokens`` (whole blocks) of ``req``'s leading
        prefix from the host tier onto device, referencing them to ``req``
        like cache hits. Journals an "in" event per block for the engine to
        stage payloads. Returns the tokens restored (0 on memory pressure).
        The caller advances ``req.computed_tokens`` and charges
        ``TimeModel.swap_time`` — KV becomes resident without compute.
        Restored blocks count against the §4.2 running-KV threshold exactly
        like freshly computed ones (swap-in is not a loophole around the
        burst headroom).

        For a ``restore_last_only`` family (recurrent-state snapshots) only
        the *last* restored boundary's payload must cross the link — the
        recurrence resumes from it — so every earlier event of this call is
        re-journaled as ``"in_lazy"``: the engine re-registers its payload
        with the runner host-side, costing zero transfer time."""
        if self.host is None or max_tokens < self.block_size:
            return 0
        bs = self.block_size
        start = len(req.block_ids) * bs
        prev = self._chain_up_to(req, len(req.block_ids), tokens)
        first_event = len(self._swap_events)
        restored = 0
        while restored + bs <= max_tokens:
            n = start + restored
            if n + bs > len(tokens):
                break
            h = chain_hash(prev, tuple(tokens[n: n + bs]))
            hb = self.host.get(h)
            if hb is None or h in self.hash_to_bid:
                break
            if respect_threshold and self.task_aware and \
                    self.running_blocks + 1 > self.threshold_blocks:
                break
            bid = self._get_free_block()
            if bid is None:
                break
            self.host.pop(h)
            blk = self.blocks[bid]
            blk.hash = h
            blk.ref = 1
            blk.lat = now
            blk.task_type = hb.task_type
            blk.n_tokens = hb.n_tokens
            blk.unfinished_owners = hb.unfinished_owners
            if blk.unfinished_owners > 0:                 # owner came back
                blk.unfinished_owners -= 1
                if h in req.owner_pins:
                    req.owner_pins.remove(h)
            self.hash_to_bid[h] = bid
            req.block_ids.append(bid)
            self._swap_events.append(("in", bid, hb))
            self.metrics.swapped_in_blocks += 1
            self.metrics.swapped_in_tokens += hb.n_tokens
            prev = h
            restored += bs
        if restored and self.io.restore_last_only:
            for i in range(first_event, len(self._swap_events) - 1):
                kind, bid, hb = self._swap_events[i]
                if kind == "in":
                    self._swap_events[i] = ("in_lazy", bid, hb)
        for kind, _, hb in self._swap_events[first_event:]:
            if kind == "in":
                self.metrics.swapped_in_bytes += hb.n_bytes
        return restored

    def pending_swap_out_tokens(self) -> int:
        """Undrained swap-OUT traffic journaled by the current scheduling
        pass — the estimator charges it against the SLO budget alongside
        planned swap-ins, since the engine will clock both directions."""
        return sum(hb.n_tokens for kind, _, hb in self._swap_events
                   if kind == "out")

    def pending_swap_out_bytes(self) -> int:
        """``pending_swap_out_tokens`` in link units — what the journaled
        swap-OUTs will actually put on the PCIe link, per the family's io
        spec (bytes are priced at eviction time into ``HostBlock.n_bytes``)."""
        return sum(hb.n_bytes for kind, _, hb in self._swap_events
                   if kind == "out")

    def drain_swap_events(self) -> List[Tuple[str, int, HostBlock]]:
        """Swap decisions since the last drain, in order. The engine must
        process these before the runner writes any pages this iteration —
        an "out" bid's device pages are still intact until then, and an
        "in" whose block was swapped out this same iteration reads the
        payload staged by its earlier "out" entry (same HostBlock object).
        "in_lazy" entries (restore_last_only families) re-register the host
        payload with the runner without an upload — zero link traffic."""
        out, self._swap_events = self._swap_events, []
        return out

    # ------------------------------------------------------------ migration
    def export_block(self, h: int,
                     payload_reader: Optional[Callable[[int], object]] = None
                     ) -> Optional[HostBlock]:
        """Pull block ``h`` out of this manager as a ``HostBlock`` ready to
        ship to another replica — the source side of cross-replica KV
        migration. A host-tier copy is popped directly; an idle (ref == 0)
        device copy is materialized through ``payload_reader`` (the runner's
        ``read_block`` on the real path) and its device slot freed. Returns
        None — and exports nothing — when the hash is absent from both tiers
        or the device copy is still referenced."""
        if self.host is not None:
            hb = self.host.pop(h)
            if hb is not None:
                self.metrics.migrated_out_blocks += 1
                self.metrics.migrated_out_bytes += hb.n_bytes
                return hb
        bid = self.hash_to_bid.get(h)
        if bid is None:
            return None
        blk = self.blocks[bid]
        if blk.ref > 0:
            return None
        hb = HostBlock(hash=h, n_tokens=blk.n_tokens,
                       task_type=blk.task_type,
                       unfinished_owners=blk.unfinished_owners,
                       lat=blk.lat,
                       payload=(payload_reader(bid)
                                if payload_reader is not None else None),
                       n_bytes=self.io.block_bytes(blk.n_tokens))
        del self.hash_to_bid[h]
        blk.hash = None
        blk.unfinished_owners = 0
        blk.n_tokens = 0
        self.free.append(bid)            # stale heap entries skip hash=None
        self.metrics.migrated_out_blocks += 1
        self.metrics.migrated_out_bytes += hb.n_bytes
        return hb

    def import_host_block(self, hb: HostBlock, now: float) -> bool:
        """Land a migrated ``HostBlock`` in this manager's host tier — the
        destination side of cross-replica KV migration. The block becomes
        restorable by the ordinary ``swap_in`` path (it is indistinguishable
        from a locally parked prefix). Returns False when the hash is
        already resident on either tier (no bytes moved) or the host tier
        refuses it (full of more valuable blocks, or absent)."""
        if hb.hash in self.hash_to_bid:
            return False
        if self.host is None:
            self.metrics.migrate_bounced_blocks += 1
            return False
        if hb.hash in self.host:
            return False
        hb.lat = now
        if not self.host.admit(hb):
            self.metrics.migrate_bounced_blocks += 1
            return False
        self.metrics.migrated_in_blocks += 1
        self.metrics.migrated_in_bytes += hb.n_bytes
        return True

    def release_owner_pins(self, req: Request) -> None:
        """Drop the unfinished-owner pins an aborted request left on blocks
        it no longer references (committed blocks released at preemption
        carry ``unfinished_owners`` for the owner's return — an aborted
        owner never returns). Covers both tiers; the lazy heaps re-rank the
        blocks on their next pop.

        Pins are resolved by content hash, matching the rest of the owner
        accounting (an ``allocate`` hit by ANY same-content request already
        counts as "the owner came back"): if this request's pinned hash was
        dropped and later re-pinned by a different request, the release may
        discharge that pin instead — a priority imprecision, never a
        correctness issue."""
        for h in req.owner_pins:
            bid = self.hash_to_bid.get(h)
            if bid is not None:
                blk = self.blocks[bid]
                if blk.unfinished_owners > 0:
                    blk.unfinished_owners -= 1
                continue
            hb = self.host.get(h) if self.host is not None else None
            if hb is not None and hb.unfinished_owners > 0:
                hb.unfinished_owners -= 1
        req.owner_pins.clear()

    def evictable_count(self) -> int:
        return sum(1 for b in self.blocks if b.ref == 0 and b.hash is not None)

    def clean_evictable_count(self) -> int:
        """Evictable blocks whose eviction carries no punishment (priority
        < 1: dead offline, finished online) — plus never-used free blocks."""
        n = len(self.free)
        for b in self.blocks:
            if b.ref == 0 and b.hash is not None and self._priority(b) < 1.0:
                n += 1
        return n

    def can_allocate(self, n_new: int, *, respect_threshold: bool = True) -> bool:
        if len(self.free) + self.evictable_count() < n_new:
            return False
        if respect_threshold and self.task_aware:
            if self.running_blocks + n_new > self.threshold_blocks:
                return False
        return True

    # ------------------------------------------------------------- eviction
    def would_swap(self, priority: float) -> bool:
        """Swap-out policy: a block is worth the PCIe round trip only when
        someone will come back for it — rc > 0 offline (future prefix reuse)
        or a preempted online owner. Dead offline / finished online blocks
        are dropped for free exactly as before."""
        return self.host is not None and priority >= SWAP_MIN_PRIORITY

    def _evict_one(self) -> Optional[int]:
        while self._heap:
            prio, lat, _, bid = heapq.heappop(self._heap)
            blk = self.blocks[bid]
            if blk.ref > 0 or blk.hash is None:
                continue                                  # stale entry
            cur = (self._priority(blk), blk.lat)
            if (prio, lat) != cur:                        # stale meta: refresh
                self._push_evictable(blk)
                continue
            # evict — swapping to the host tier if the block has a future
            rc = self.rc_provider(blk.hash) + blk.unfinished_owners
            swapped = False
            if rc > 0 and self.would_swap(prio):
                hb = HostBlock(hash=blk.hash, n_tokens=blk.n_tokens,
                               task_type=blk.task_type,
                               unfinished_owners=blk.unfinished_owners,
                               lat=blk.lat,
                               n_bytes=self.io.block_bytes(blk.n_tokens))
                swapped = self.host.admit(hb)
                if swapped:
                    self._swap_events.append(("out", bid, hb))
                    self.metrics.swapped_out_blocks += 1
                    self.metrics.swapped_out_tokens += blk.n_tokens
                    self.metrics.swapped_out_bytes += hb.n_bytes
                else:
                    self.metrics.host_bounced_blocks += 1
            if rc > 0 and not swapped:
                self.metrics.punished_tokens += blk.n_tokens
            del self.hash_to_bid[blk.hash]
            blk.hash = None
            blk.unfinished_owners = 0
            blk.n_tokens = 0
            self.metrics.evictions += 1
            return bid
        return None

    def peek_eviction_order(self, n: int) -> List[Block]:
        """The next ``n`` blocks ``_evict_one`` would realize, WITHOUT
        mutating anything — the single source of truth for the scheduler's
        expected-punishment peek (previously an independent sort that could
        disagree with the heap's realized order). Replays the lazy-heap
        discipline against a copy: stale entries are skipped/refreshed
        exactly as eviction would."""
        if n <= 0:
            return []
        heap = list(self._heap)
        heapq.heapify(heap)
        seen: set = set()
        out: List[Block] = []
        while heap and len(out) < n:
            prio, lat, _, bid = heapq.heappop(heap)
            blk = self.blocks[bid]
            if blk.ref > 0 or blk.hash is None or bid in seen:
                continue
            if (prio, lat) != (self._priority(blk), blk.lat):
                heapq.heappush(heap, (self._priority(blk), blk.lat,
                                      next(self._seq), bid))
                continue
            seen.add(bid)
            out.append(blk)
        return out

    def _get_free_block(self) -> Optional[int]:
        if self.free:
            return self.free.pop()
        return self._evict_one()

    # ------------------------------------------------------------- alloc
    def allocate(self, req: Request, target_len: int, tokens: Sequence[int],
                 now: float, *, respect_threshold: bool = True) -> Optional[int]:
        """Ensure ``req`` owns blocks covering ``target_len`` token slots.

        ``tokens`` is the known token content (prompt + generated so far);
        full blocks within it are prefix-matched against the cache.
        Returns the number of *leading consecutive cache-hit tokens* among
        the newly covered blocks (0 if none), or None if memory is
        insufficient (partial-progress refs rolled back).
        """
        bs = self.block_size
        have = len(req.block_ids)
        need_blocks = (target_len + bs - 1) // bs
        if need_blocks <= have:
            return 0
        newly = []
        leading_hits = 0
        leading = True
        prev = self._chain_up_to(req, have, tokens)
        ok = True
        matching = True                  # only a *leading* prefix may hit
        for bi in range(have, need_blocks):
            start = bi * bs
            full = start + bs <= len(tokens)
            h = (chain_hash(prev, tuple(tokens[start: start + bs]))
                 if (full and matching) else None)
            offline = req.task_type == TaskType.OFFLINE
            if full:
                self.metrics.lookup_blocks += 1
                if offline:
                    self.metrics.offline_lookup_blocks += 1
            if h is not None and h in self.hash_to_bid:
                bid = self.hash_to_bid[h]
                blk = self.blocks[bid]
                blk.ref += 1
                blk.lat = now
                if blk.unfinished_owners > 0:
                    blk.unfinished_owners -= 1            # owner came back
                    if h in req.owner_pins:
                        req.owner_pins.remove(h)
                self.metrics.hit_blocks += 1
                if offline:
                    self.metrics.offline_hit_blocks += 1
                prev = h
                if leading:
                    leading_hits += bs
            else:
                matching = False
                leading = False
                if respect_threshold and self.task_aware and \
                        self.running_blocks + 1 > self.threshold_blocks:
                    ok = False
                bid = self._get_free_block() if ok else None
                if bid is None:
                    ok = False
                    break
                blk = self.blocks[bid]
                blk.ref = 1
                blk.lat = now
                blk.task_type = req.task_type
                blk.hash = None
                blk.n_tokens = 0
            newly.append(bid)
            req.block_ids.append(bid)
        if not ok:
            for bid in newly:
                self._release_block(bid, now)
                req.block_ids.pop()
            return None
        return leading_hits

    def _chain_up_to(self, req: Request, n_blocks: int, tokens: Sequence[int]) -> int:
        prev = 0
        bs = self.block_size
        for bi in range(n_blocks):
            if (bi + 1) * bs <= len(tokens):
                prev = chain_hash(prev, tuple(tokens[bi * bs: (bi + 1) * bs]))
        return prev

    def commit(self, req: Request, tokens: Sequence[int], now: float) -> None:
        """Register hashes for req's now-full computed blocks (content known)."""
        bs = self.block_size
        prev = 0
        covered = min(len(tokens), req.total_len)
        n_full = covered // bs
        # track valid tokens in the trailing partial block (for punishment).
        # The slot can alias a COMMITTED full block (a deeper-prefix peer's
        # block hash-hit at allocate): its content — and the payload an
        # eviction would move — is still the full block; don't relabel it.
        if n_full < len(req.block_ids) and covered % bs:
            blk = self.blocks[req.block_ids[n_full]]
            if blk.hash is None:
                blk.n_tokens = covered % bs
        for bi in range(n_full):
            chunk = tuple(tokens[bi * bs: (bi + 1) * bs])
            h = chain_hash(prev, chunk)
            prev = h
            if bi >= len(req.block_ids):
                break
            blk = self.blocks[req.block_ids[bi]]
            blk.lat = now
            blk.n_tokens = bs
            if blk.hash is None and h not in self.hash_to_bid:
                blk.hash = h
                blk.task_type = req.task_type if blk.ref <= 1 else blk.task_type
                self.hash_to_bid[h] = blk.bid
                if self.host is not None:
                    # the content was recomputed rather than swapped back:
                    # the host copy is now redundant — absorb it so the
                    # tiers stay disjoint, moving its owner pins onto the
                    # (fresher) device block
                    hb = self.host.pop(h)
                    if hb is not None:
                        blk.unfinished_owners += hb.unfinished_owners

    # ------------------------------------------------------------- free
    def _release_block(self, bid: int, now: float,
                       unfinished: bool = False) -> Optional[int]:
        """Returns the block's hash iff this release pinned an
        unfinished-owner on it (so the owner can track — and on abort
        release — its pins)."""
        blk = self.blocks[bid]
        blk.ref -= 1
        blk.lat = now
        if blk.ref == 0:
            if unfinished:
                blk.unfinished_owners += 1
            if blk.hash is None:
                if unfinished:                            # lost work: re-prefill
                    self.metrics.punished_tokens += blk.n_tokens
                blk.n_tokens = 0
                blk.unfinished_owners = 0
                self.free.append(bid)                     # uncommitted: discard
            else:
                self._push_evictable(blk)
                if unfinished:
                    return blk.hash
        return None

    def free_request(self, req: Request, now: float, *, finished: bool) -> None:
        for bid in req.block_ids:
            pinned = self._release_block(bid, now, unfinished=not finished)
            if pinned is not None:
                req.owner_pins.append(pinned)
        req.block_ids.clear()

    def trim_request(self, req: Request, keep_tokens: int, now: float) -> None:
        """Release blocks beyond the ``keep_tokens`` boundary — allocated for
        a planned chunk that was then shed before computing anything, so no
        work is lost: fresh blocks return to the free list, cache-hit blocks
        just drop the extra reference and stay cached."""
        keep = (keep_tokens + self.block_size - 1) // self.block_size
        while len(req.block_ids) > keep:
            self._release_block(req.block_ids.pop(), now)

    def touch(self, req: Request, now: float) -> None:
        for bid in req.block_ids:
            self.blocks[bid].lat = now
