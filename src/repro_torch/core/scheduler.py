"""KV-cache-aware task scheduler (paper §4.1).

Per iteration the *plan generator* derives candidate batch configurations by
incremental edits to the last iteration's batch (the paper's search-space
collapse): continue running work, admit queued online requests FCFS
(preempting offline if needed), then — only once the online queue is fully
admitted (§6) — try offline admissions chosen by prefix-cache affinity and
length regularity. The *plan selector* scores candidates by
(Benefit - Punishment) / EstimatedTime (Eq.4) under the SLO (Eq. in §5.1)
and memory/threshold constraints, and commits the winner's allocations.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple

from repro_torch.core.block_manager import BlockManager
from repro_torch.core.estimator import TimeModel
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.radix_pool import OfflinePool
from repro_torch.core.request import Request, RequestState, TaskType


@dataclass
class Plan:
    prefills: List[Tuple[Request, int]] = field(default_factory=list)  # (req, chunk)
    decodes: List[Request] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)
    swap_ins: List[Tuple[Request, int]] = field(default_factory=list)  # (req, tokens)
    admitted: List[Request] = field(default_factory=list)  # newly running
    est_time: float = 0.0
    benefit: float = 0.0
    punishment: float = 0.0

    @property
    def swap_in_tokens(self) -> int:
        return sum(n for _, n in self.swap_ins)

    @property
    def reward(self) -> float:
        if self.est_time <= 0:
            return 0.0
        return (self.benefit - self.punishment) / self.est_time

    @property
    def n_scheduled(self) -> int:
        return len(self.prefills) + len(self.decodes)


@dataclass
class _Candidate:
    """A tentative offline admission evaluated by the plan selector."""
    req: Request
    chunk: int
    cached: int                 # reusable prefix: device hits + host swap-in
    host_take: int              # tokens of ``cached`` restored over PCIe
    new_blocks: int
    punishment: float
    d_benefit: float
    d_time: float

    def score(self) -> float:
        # marginal reward per marginal second (Eq.4 on the increment)
        return (self.d_benefit - self.punishment) / max(self.d_time, 1e-9)


class Scheduler:
    def __init__(self, bm: BlockManager, pool: OfflinePool, tm: TimeModel,
                 policy: PolicyConfig, *,
                 chunk_size: int = 256,
                 max_batch_tokens: int = 2048,
                 max_running: int = 64,
                 offline_admit_per_iter: int = 1,   # §4.1: add the best ONE
                 slo_slack_factor: float = 0.9):
        self.bm = bm
        self.pool = pool
        self.tm = tm
        self.policy = policy
        self.chunk_size = chunk_size
        self.max_batch_tokens = max_batch_tokens
        self.max_running = max_running
        self.offline_admit_per_iter = offline_admit_per_iter
        self.slo_slack_factor = slo_slack_factor

        self.online_queue: Deque[Request] = deque()
        self.running: List[Request] = []
        self.last_plan: Optional[Plan] = None

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        if req.task_type == TaskType.ONLINE:
            self.online_queue.append(req)
        else:
            self.pool.add(req)

    # ------------------------------------------------------------- helpers
    def _blocks_for(self, req: Request, target_len: int) -> int:
        bs = self.bm.block_size
        have = len(req.block_ids)
        return max((target_len + bs - 1) // bs - have, 0)

    def _alloc(self, req: Request, target_len: int, now: float,
               respect_threshold: bool) -> bool:
        res = self.bm.allocate(req, target_len, req.full_tokens, now,
                               respect_threshold=respect_threshold)
        return res is not None

    def _restore_bytes(self, n_tokens: int) -> int:
        """Link bytes ONE swap-in entry of ``n_tokens`` puts on the PCIe
        stream, per the family's io spec: every restored KV page for paged
        attention, a single fixed-size snapshot (the last boundary) for
        restore_last_only state families."""
        return self.bm.io.restore_bytes(n_tokens, self.bm.block_size)

    def _swap_in_bytes(self, plan: Plan) -> int:
        """Byte weight of a plan's swap-in traffic. Priced per entry — each
        ``swap_ins`` element is one ``BlockManager.swap_in`` call, which
        journals exactly one non-lazy upload for a restore_last_only family
        — so this matches the engine's journal accounting 1:1."""
        return sum(self._restore_bytes(n) for _, n in plan.swap_ins)

    def _plan_transfer_time(self, swap_in_bytes: int) -> float:
        """Total PCIe seconds a plan carrying ``swap_in_bytes`` of swap-in
        traffic puts on the copy stream — including the swap-outs this
        scheduling pass already journaled (the engine clocks both
        directions)."""
        # NOTE: ``is not None`` — HostTier defines __len__, so a merely
        # *empty* tier is falsy while its journal can still carry undrained
        # swap-out events from this very scheduling pass
        out_bytes = (self.bm.pending_swap_out_bytes()
                     if self.bm.host is not None else 0)
        t = 0.0
        if swap_in_bytes:
            t += self.tm.swap_time(swap_in_bytes)
        if out_bytes:
            t += self.tm.swap_time(out_bytes)
        return t

    def _plan_time(self, spans, dlens, swap_in_bytes: int) -> float:
        """Iteration-time estimate for a (spans, decodes, swap-in) shape:
        compute overlapped with the plan's PCIe traffic — under overlap only
        the exposed transfer tail (plus the launch overhead) is charged on
        top of compute; with ``swap_overlap=False`` the serial sum."""
        compute = self.tm.batch_time(spans, dlens)
        return self.tm.overlapped_iteration_time(
            compute, self._plan_transfer_time(swap_in_bytes))

    def _swap_in_worthwhile(self, start: int, n_tokens: int,
                            plan: Optional[Plan] = None) -> bool:
        """The per-candidate transfer-vs-recompute decision: restoring
        ``n_tokens`` of cached state at context depth ``start`` over PCIe
        must beat re-prefilling the same span (Eq.6 increment). Priced in
        bytes through the family's io spec: with the default coefficients a
        paged-KV swap wins by ~20x on linear cost — but a deep-context
        span's quadratic term can tip either way — and a fixed-size state
        snapshot wins by orders of magnitude more, since its link cost does
        not grow with the restored span at all.

        Under swap/compute overlap a transfer that LOSES the raw seconds
        race gets a second chance at its *marginal iteration time*: hidden
        under the plan's compute it costs only the exposed tail, while
        recompute always grows the compute leg. The discount applies only
        when the restore displaces nothing (free blocks cover it): an
        eviction-funded restore churns future-needed blocks through the
        tier, and that displacement cost is real even when the link time is
        hidden — measured on the §7.1 burst scenario, undiscounted
        eviction-funded restores erase the entire overlap win."""
        serial_wins = (self.tm.swap_time(self._restore_bytes(n_tokens))
                       < self.tm.prefill_time([(start, start + n_tokens)]))
        if serial_wins or plan is None or not self.tm.swap_overlap:
            return serial_wins
        blocks = (n_tokens + self.bm.block_size - 1) // self.bm.block_size
        if self.bm.free_blocks < blocks:
            return False
        spans = [(r.computed_tokens, r.computed_tokens + c)
                 for r, c in plan.prefills]
        dlens = [r.total_len + 1 for r in plan.decodes]
        in_bytes = self._swap_in_bytes(plan)
        t_swap = self._plan_time(spans, dlens,
                                 in_bytes + self._restore_bytes(n_tokens))
        t_recompute = self._plan_time(spans + [(start, start + n_tokens)],
                                      dlens, in_bytes)
        return t_swap < t_recompute

    def _try_swap_in(self, req: Request, now: float, limit: int,
                     plan: Optional[Plan], respect_threshold: bool) -> int:
        """Restore a leading host-resident prefix instead of recomputing it.
        Returns tokens restored (0 if the tier is cold, the transfer would
        lose to recompute, or memory is exhausted). The restored span is
        charged as ``swap_time`` on the plan — it competes for the same SLO
        budget as compute."""
        if plan is None or self.bm.host is None:
            return 0
        bs = self.bm.block_size
        avail = self.bm.probe_host_prefix(req.full_tokens, req.computed_tokens)
        # keep >= 1 token to compute (logits for the next token), block-aligned
        avail = min(avail, limit - 1 - req.computed_tokens) // bs * bs
        if avail < bs:
            return 0
        if not self._swap_in_worthwhile(req.computed_tokens, avail, plan):
            return 0
        got = self.bm.swap_in(req, req.full_tokens, now, avail,
                              respect_threshold=respect_threshold)
        if got > 0:
            plan.swap_ins.append((req, got))
            req.computed_tokens += got
            req.swapped_in_tokens += got
        return got

    def _plan_prefill_chunk(self, req: Request, now: float,
                            respect_threshold: bool,
                            plan: Optional[Plan] = None) -> Optional[int]:
        """Allocate blocks for the next prefill chunk, skipping over blocks
        that turn out cached (leader/follower stagger: a same-prefix peer
        admitted one chunk behind hits every block its leader committed) and
        swapping in host-resident blocks when the transfer beats recompute.
        Returns the chunk length to compute (>=1) or None on memory failure.
        """
        limit = req.prefill_target_len
        bs = self.bm.block_size
        while True:
            if req.computed_tokens >= limit:
                return 0
            aligned = req.computed_tokens == len(req.block_ids) * bs
            if aligned and self._try_swap_in(req, now, limit, plan,
                                             respect_threshold) > 0:
                continue
            target = min(req.computed_tokens + self.chunk_size, limit)
            hits = self.bm.allocate(req, target, req.full_tokens, now,
                                    respect_threshold=respect_threshold)
            if hits is None:
                return None
            skip = min(hits, limit - 1 - req.computed_tokens) if aligned else 0
            if 0 < skip < hits:
                # fully-cached prompt: keep the resume point block-aligned
                # (state-snapshot runners resume only at block boundaries)
                skip = (req.computed_tokens + skip) // bs * bs \
                    - req.computed_tokens
            if skip > 0:
                req.computed_tokens += skip
                continue
            if self.policy.kv_aware_sched and \
                    self._leader_covers(req, req.computed_tokens, target):
                return 0          # a peer is computing this span: wait a turn
            return target - req.computed_tokens

    def _leader_covers(self, req: Request, start: int, end: int) -> bool:
        """True if another running request shares req's tokens on [start,end)
        and is about to compute that span itself — the follower should wait
        one iteration and then reuse the committed blocks instead of
        duplicating the prefix compute."""
        if req.task_type != TaskType.OFFLINE:
            return False
        toks = req.full_tokens
        for r2 in self.running:
            if r2 is req or r2.task_type != TaskType.OFFLINE or r2.prefill_done:
                continue
            c2 = r2.computed_tokens
            if not (start <= c2 < end):
                continue
            if c2 == start and r2.rid > req.rid:
                continue                      # tie: smaller rid leads
            span = min(end, len(r2.full_tokens))
            if span > start and r2.full_tokens[start:span] == toks[start:span]:
                return True
        return False

    def _preempt_request(self, victim: Request, now: float, plan: Plan) -> None:
        victim.n_preemptions += 1
        victim.state = RequestState.WAITING
        victim.computed_tokens = 0
        self.bm.free_request(victim, now, finished=False)
        if victim in self.running:
            self.running.remove(victim)
        plan.preempted.append(victim)
        plan.decodes = [r for r in plan.decodes if r is not victim]
        plan.prefills = [(r, c) for (r, c) in plan.prefills if r is not victim]
        # plan.swap_ins deliberately keeps the victim's entries: the PCIe
        # transfer already executed (blocks restored, journal staged), so
        # its time must still be charged; the restored blocks stay cached
        # for the victim's return
        self.pool.add(victim)                     # recompute mode: back to pool

    def _preempt_one_offline(self, now: float, plan: Plan) -> bool:
        """Evict the most-recently-admitted running offline request."""
        victims = [r for r in self.running
                   if r.task_type == TaskType.OFFLINE and r not in plan.preempted]
        if not victims:
            return False
        self._preempt_request(victims[-1], now, plan)
        return True

    def _preempt_one_online(self, now: float, plan: Plan,
                            exclude: Request) -> bool:
        """Memory-full fallback (vLLM recompute preemption): the latest
        arrived running online request yields so earlier ones can progress;
        it returns to the online queue head group by arrival order."""
        victims = [r for r in self.running
                   if r.is_online and r is not exclude and r not in plan.preempted]
        if not victims:
            return False
        victim = max(victims, key=lambda r: (r.arrival_time, r.rid))
        victim.n_preemptions += 1
        victim.state = RequestState.WAITING
        victim.computed_tokens = 0
        self.bm.free_request(victim, now, finished=False)
        self.running.remove(victim)
        plan.preempted.append(victim)
        plan.decodes = [r for r in plan.decodes if r is not victim]
        plan.prefills = [(r, c) for (r, c) in plan.prefills if r is not victim]
        self.online_queue.appendleft(victim)
        return True

    def _slo_budget(self, now: float, plan: Plan) -> float:
        budget = float("inf")
        for req in plan.decodes + [r for r, _ in plan.prefills]:
            if req.is_online:
                b = req.latency_budget(now)
                if b <= 0 and req.slo is not None:
                    # already late: the deadline is sunk — pace at TPOT so
                    # the batch keeps moving instead of starving forever
                    b = req.slo.tpot
                budget = min(budget, b)
        return budget * self.slo_slack_factor

    def _expected_punishment(self, n_evictions: int) -> float:
        """Expected cost (in recompute-token units) of the next n evictions.

        Uses ``BlockManager.peek_eviction_order`` — the same lazy-heap
        discipline eviction realizes — instead of an independent sort that
        could disagree with it. A future-needed block the host tier will
        absorb is punished at its (much cheaper) swap-round-trip equivalent,
        never more than the full recompute it replaces."""
        if n_evictions <= 0:
            return 0.0
        if not self.policy.task_aware_kv and not self.policy.kv_aware_sched:
            return 0.0
        pun = 0.0
        for b in self.bm.peek_eviction_order(n_evictions):
            rc = self.bm.rc_provider(b.hash) + b.unfinished_owners
            if rc > 0:
                if self.bm.would_swap(self.bm._priority(b)):
                    # round trip priced in the block's actual link weight
                    # (KV pages or one fixed-size snapshot), capped at the
                    # full recompute the host tier saves
                    pun += min(self.tm.swap_equiv_tokens(
                        self.bm.io.block_bytes(b.n_tokens)),
                        float(b.n_tokens))
                else:
                    pun += b.n_tokens
        return pun

    def _plan_tokens(self, plan: Plan) -> int:
        return sum(c for _, c in plan.prefills) + len(plan.decodes)

    def _estimate(self, plan: Plan) -> float:
        # PCIe traffic competes for the SLO budget — but under overlap only
        # its exposed tail does; ``_plan_time`` charges planned swap-ins and
        # already-journaled swap-outs either way
        spans = [(r.computed_tokens, r.computed_tokens + c)
                 for r, c in plan.prefills]
        dlens = [r.total_len + 1 for r in plan.decodes]
        return self._plan_time(spans, dlens, self._swap_in_bytes(plan))

    # ------------------------------------------------------------- schedule
    def schedule(self, now: float) -> Plan:
        plan = Plan()

        # 1. base plan = last batch, minus finished: continue decodes/prefills
        self.running = [r for r in self.running
                        if r.state == RequestState.RUNNING]
        for req in list(self.running):
            if req.prefill_done:
                if not req.done:
                    plan.decodes.append(req)
            else:
                chunk = self._plan_prefill_chunk(
                    req, now, respect_threshold=not req.is_online, plan=plan)
                while chunk is None and req.is_online and \
                        self._preempt_one_offline(now, plan):
                    chunk = self._plan_prefill_chunk(req, now,
                                                     respect_threshold=False,
                                                     plan=plan)
                if chunk is None:
                    if req.task_type == TaskType.OFFLINE:
                        self._preempt_request(req, now, plan)
                    continue
                if chunk > 0:
                    plan.prefills.append((req, chunk))
                elif req.prefill_done and not req.done:  # fully cached: decode
                    plan.decodes.append(req)
                # else: waiting on a leader to commit the shared span

        # 2. admit online FCFS, preempting offline on memory pressure
        while self.online_queue:
            req = self.online_queue[0]
            if len(self.running) >= self.max_running:
                # slots full: offline yields its seat to online (priority)
                if not self._preempt_one_offline(now, plan):
                    break
                continue
            req.admit(now)
            chunk = self._plan_prefill_chunk(req, now, respect_threshold=False,
                                             plan=plan)
            while chunk is None and self._preempt_one_offline(now, plan):
                chunk = self._plan_prefill_chunk(req, now,
                                                 respect_threshold=False,
                                                 plan=plan)
            if chunk is None:
                req.state = RequestState.WAITING
                self.bm.free_request(req, now, finished=False)
                req.computed_tokens = 0
                break
            # §6: online admission is also SLO-gated — adding this prefill
            # must not blow the batch budget of already-running requests
            # (the queued request's own TTFT slack covers the wait)
            if self.policy.use_estimator and chunk > 0 and plan.n_scheduled:
                trial = Plan(prefills=plan.prefills + [(req, chunk)],
                             decodes=plan.decodes, swap_ins=plan.swap_ins)
                if self._estimate(trial) > self._slo_budget(now, trial):
                    req.state = RequestState.WAITING
                    self.bm.free_request(req, now, finished=False)
                    req.computed_tokens = 0
                    break
            self.online_queue.popleft()
            self.running.append(req)
            plan.admitted.append(req)
            if chunk > 0:
                plan.prefills.append((req, chunk))

        # decode slots for continuing decodes (may preempt offline, then —
        # memory-full fallback — later-arrived online)
        kept = []
        for req in plan.decodes:
            ok = self._alloc(req, req.total_len + 1, now,
                             respect_threshold=not req.is_online)
            while not ok and req.is_online and (
                    self._preempt_one_offline(now, plan)
                    or self._preempt_one_online(now, plan, req)):
                ok = self._alloc(req, req.total_len + 1, now,
                                 respect_threshold=False)
            if ok:
                kept.append(req)
            elif req.task_type == TaskType.OFFLINE:
                # cannot grow: preempt it (frees its own blocks)
                req.n_preemptions += 1
                req.state = RequestState.WAITING
                req.computed_tokens = 0
                self.bm.free_request(req, now, finished=False)
                self.running.remove(req)
                plan.preempted.append(req)
                self.pool.add(req)
        # a later decode's alloc may have preempted an EARLIER one already
        # moved into ``kept`` — restoring it here would emit a ghost token
        # for a request whose blocks are freed and that sits back in the
        # queue (it could even "finish" there and later finish again)
        plan.decodes = [r for r in kept if r not in plan.preempted]

        # 3. SLO feasibility of the mandatory part: shed offline work.
        # Shedding removes the chunk from the plan AND rolls its freshly
        # allocated blocks back to the computed-token boundary — otherwise
        # the request keeps holding blocks for work it won't do this
        # iteration, inflating running_blocks/depleting free memory for
        # same-iteration offline admission.
        budget = self._slo_budget(now, plan)
        if self.policy.use_estimator:
            while self._estimate(plan) > budget:
                off_pf = [(r, c) for r, c in plan.prefills
                          if r.task_type == TaskType.OFFLINE]
                if off_pf:
                    r, c = off_pf[-1]
                    plan.prefills.remove((r, c))
                    self.bm.trim_request(r, r.computed_tokens, now)
                    continue
                off_dec = [r for r in plan.decodes
                           if r.task_type == TaskType.OFFLINE]
                if off_dec:
                    r = off_dec[-1]
                    plan.decodes.remove(r)             # skip this iteration
                    self.bm.trim_request(r, r.computed_tokens, now)
                    continue
                break

        # 4. offline admission (only when the online queue is drained, §6)
        if not self.online_queue:
            self._admit_offline(now, plan, budget)

        # 5. finalize
        plan.benefit = float(self._plan_tokens(plan))
        plan.est_time = self._estimate(plan)
        self.last_plan = plan
        return plan

    # ------------------------------------------------------------- offline
    def _offline_candidates(self, now: float) -> List[Request]:
        if not self.policy.kv_aware_sched:
            head = self.pool.fcfs_head()
            return [head] if head is not None else []
        return list(self.pool.candidates())

    def _evaluate_candidate(self, req: Request, plan: Plan) -> _Candidate:
        tokens = req.full_tokens
        bs = self.bm.block_size
        dev_cached = self.bm.probe_prefix(tokens)
        # swap-in-vs-recompute, priced per candidate: a host-resident prefix
        # extends the reusable prefix at PCIe cost instead of compute cost
        host_take = 0
        host_avail = self.bm.probe_host_prefix(tokens, dev_cached)
        if host_avail:
            cap = max(len(tokens) - 1 - dev_cached, 0) // bs * bs
            host_take = min(host_avail, cap)
            if host_take and not self._swap_in_worthwhile(dev_cached,
                                                          host_take, plan):
                host_take = 0
        cached = min(dev_cached + host_take, max(len(tokens) - 1, 0))
        chunk = min(len(tokens) - cached, self.chunk_size)
        new_blocks = self._blocks_for(req, cached + chunk)
        free = self.bm.free_blocks
        evictions = max(new_blocks - free, 0)
        pun = self._expected_punishment(evictions)
        base_spans = [(r.computed_tokens, r.computed_tokens + c)
                      for r, c in plan.prefills]
        dlens = [r.total_len + 1 for r in plan.decodes]
        t0 = self.tm.batch_time(base_spans, dlens)
        t1 = self.tm.batch_time(base_spans + [(cached, cached + chunk)], dlens)
        # Eq.4's denominator is resource occupancy, not latency: the
        # host_take's transfer holds the PCIe link for its full serial time
        # even when the clock hides it under compute, so candidate scoring
        # charges it undiscounted — otherwise hidden restores score near
        # infinity, crowd out cache-hit admissions, and the eviction churn
        # costs more than the hidden seconds saved. The overlap discount
        # lives where latency is the question: ``est_time``/the SLO budget
        # (``_estimate``) and the execution clock.
        d_time = t1 - t0 + self.tm.swap_time(self._restore_bytes(host_take))
        # benefit counts the *progress* incl. reused prefix (recompute avoided)
        d_benefit = float(chunk + cached) if req.computed_tokens == 0 else float(chunk)
        return _Candidate(req, chunk, cached, host_take, new_blocks, pun,
                          d_benefit, d_time)

    def _first_hash(self, req: Request) -> Optional[int]:
        from repro_torch.core.block_manager import chain_hash
        bs = self.bm.block_size
        if len(req.prompt) < bs:
            return None
        return chain_hash(0, tuple(req.prompt[:bs]))

    def _admit_offline(self, now: float, plan: Plan, budget: float) -> None:
        admitted = 0
        # prefix groups whose leader was JUST admitted (nothing committed
        # yet): a peer admitted in the same iteration would recompute the
        # prefix in parallel. Once the leader has committed >= 1 block,
        # followers trail it chunk-by-chunk and reuse its blocks (§4.1
        # Fig.4b stagger).
        bs = self.bm.block_size
        shadow = {self._first_hash(r) for r in self.running
                  if r.task_type == TaskType.OFFLINE and not r.prefill_done
                  and r.computed_tokens < bs}
        shadow.discard(None)
        while admitted < self.offline_admit_per_iter and len(self.pool):
            if len(self.running) >= self.max_running:
                break
            if self._plan_tokens(plan) >= self.max_batch_tokens:
                break
            pool_cands = list(self._offline_candidates(now))
            if self.policy.kv_aware_sched and shadow:
                unshadowed = [r for r in pool_cands
                              if self._first_hash(r) not in shadow]
                if unshadowed or plan.prefills:
                    pool_cands = unshadowed
            cands = [self._evaluate_candidate(r, plan) for r in pool_cands]
            cands = [c for c in cands if c.chunk > 0]
            if not cands:
                break
            if self.policy.kv_aware_sched:
                # regularity tie-break: prefer candidates whose length matches
                # the batch's running mean (paper §4.1 "balanced length")
                cands.sort(key=lambda c: -c.score())
            best = cands[0]
            req = best.req
            # constraints: memory (threshold-respecting) + SLO — including
            # the PCIe time of any swap-in the candidate's plan relies on
            trial_spans = ([(r.computed_tokens, r.computed_tokens + c)
                            for r, c in plan.prefills]
                           + [(best.cached, best.cached + best.chunk)])
            dlens = [r.total_len + 1 for r in plan.decodes]
            t_new = self._plan_time(
                trial_spans, dlens,
                self._swap_in_bytes(plan) + self._restore_bytes(best.host_take))
            if self.policy.use_estimator and t_new > budget:
                break
            req.admit(now)
            chunk = self._plan_prefill_chunk(req, now, respect_threshold=True,
                                             plan=plan)
            if chunk is None:
                req.state = RequestState.WAITING
                self.bm.free_request(req, now, finished=False)
                req.computed_tokens = 0
                break
            self.pool.remove(req)
            self.running.append(req)
            plan.admitted.append(req)
            if chunk > 0:
                plan.prefills.append((req, chunk))
                if not req.prefill_done:
                    shadow.add(self._first_hash(req))   # new prefix leader
            elif req.prefill_done:
                plan.decodes.append(req)
            plan.punishment += best.punishment
            admitted += 1
