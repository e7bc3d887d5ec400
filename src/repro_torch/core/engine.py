"""Echo serving engine: executes scheduler plans on a real PyTorch model.

Continuous-batching loop (vLLM-style): each iteration the scheduler emits a
plan (prefill chunks + decode batch + preemptions); the engine executes it
on the paged runner, advances the clock, feeds the estimators, and records
metrics. The clock is either a ground-truth ``clock_model`` ("virtual" —
used by the SLO benchmarks; deterministic, exactly the paper's simulator
methodology) or wall time ("wall"). The scheduler's ``time_model`` is only
an *estimate* of that clock: pass a different (or perturbed) ``clock_model``
to study miscalibration, and an ``OnlineCalibrator`` (``policy.calibrate``)
to refit the estimate from the observed iteration times (§5).

Host-tier KV staging overlaps with compute (``TimeModel.swap_overlap``):
the virtual clock charges ``max(compute, transfer) + launch`` and on the
wall path a single-worker copy stream (``_SwapStager``) double-buffers
payload staging against the runner, with per-block completion fences
before any page a plan reads or writes.
"""
from __future__ import annotations

import bisect
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.block_io import BlockIOSpec, io_spec_for_model, paged_spec
from repro_torch.core.block_manager import BlockManager, HostBlock, prefix_chain
from repro_torch.core.calibration import OnlineCalibrator
from repro_torch.core.estimator import MemoryPredictor, TimeModel
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.radix_pool import OfflinePool
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import Scheduler
from repro_torch.models.model import Model

MAX_STALLS = 3      # consecutive no-progress iterations before giving up


@dataclass
class IterationRecord:
    t: float
    n_prefill: int
    n_decode: int
    n_online: int
    n_offline: int
    iter_time: float
    offline_tokens: int
    online_tokens: int
    usage: Dict[str, int] = field(default_factory=dict)
    hit_rate: float = 0.0
    threshold_blocks: int = 0
    swap_in_tokens: int = 0        # tokens restored from the host tier
    swap_out_tokens: int = 0       # tokens parked on the host tier
    swap_in_bytes: int = 0         # PCIe bytes of the restores (lazy = 0)
    swap_out_bytes: int = 0        # PCIe bytes of the parks
    host_blocks: int = 0           # host-tier occupancy at iteration end
    swap_transfer_time: float = 0.0  # PCIe seconds put on the copy stream
    swap_exposed_time: float = 0.0   # the tail NOT hidden under compute
    migrate_in_bytes: int = 0      # fabric bytes received from other replicas


@dataclass
class IterationDetail:
    """What the observability layer needs beyond ``IterationRecord``: the
    plan's shape and the estimate it was scored with. Built only when a
    listener overrides ``on_iteration`` — the plain serving path never
    pays for it."""
    t_start: float
    t_end: float
    schedule_wall: float           # wall seconds spent in scheduler.schedule
    compute_time: float            # the clock's compute leg (no transfers)
    predicted_time: float          # scheduler estimate of the iteration
    admitted: List[Request]        # newly admitted to the running batch
    prefill_spans: List[Tuple[Request, int, int]]   # (req, start, end)
    decodes: List[Request]


class EngineListener:
    """Engine-level lifecycle hooks, called synchronously from ``step()``.

    The serving layer (``repro.serving``) subscribes one of these per engine
    to stream token/preempt/finish events live instead of scraping
    ``EngineStats`` after the fact. All methods are no-ops by default so a
    listener overrides only what it needs. Callbacks run at iteration end
    (after the plan executed), so aborting requests from inside one is safe.
    """

    def on_token(self, req: Request, tok: int, t: float) -> None: ...

    def on_preempt(self, req: Request, t: float) -> None: ...

    def on_finish(self, req: Request, t: float) -> None: ...

    def on_swap_in(self, req: Request, n_tokens: int, t: float) -> None: ...

    def on_swap_out(self, n_tokens: int, t: float) -> None: ...

    def on_swap_overlap(self, transfer_s: float, exposed_s: float,
                        t: float) -> None: ...

    def on_iteration(self, rec: "IterationRecord",
                     detail: "IterationDetail") -> None:
        """Per-iteration observability hook (tracing + estimator-drift
        probes). The engine only builds ``detail`` when some attached
        listener overrides this method."""
        ...


class _SwapStager:
    """One async copy "stream" for host<->device KV staging (wall path).

    Split-phase contract with the runner:
      * swap-out — the device-side page slice is dispatched on the engine
        thread at launch (dispatch order sequences it before any later
        compute overwrites the page); the blocking D2H materialization runs
        on the worker.
      * swap-in — the worker uploads the payload H2D off-thread; the cheap
        donated scatter into the page pool stays with the engine thread and
        applies at fence time (the pool is single-owner state).

    ``fence(bids)`` MUST run before the runner reads or writes any of
    ``bids``. Entries stay tracked until fenced — a swapped-in block whose
    owner was preempted and whose page is only touched many iterations
    later still gets its payload applied before first use. ``launch``
    fences a bid that is being re-purposed while a previous transfer is
    still in flight, preserving journal order per page."""

    def __init__(self, runner):
        self.runner = runner
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="kv-stage")
        self._inflight: Dict[int, Tuple[str, Future]] = {}
        self.staged_wall = 0.0      # seconds of staging done on the worker
        self.exposed_wall = 0.0     # seconds the engine blocked in fences
        # (bytes, worker seconds) per transfer, for swap-term calibration;
        # bounded so a virtual-clock run that never drains cannot grow it.
        # The lock serializes worker appends against the engine's drain.
        self._samples: List[Tuple[int, float]] = []
        self._samples_lock = threading.Lock()

    def launch(self, events) -> None:
        for kind, bid, hb in events:
            if bid in self._inflight:
                self.fence([bid])
            if kind == "out":
                snap = self.runner.snapshot_block(bid)
                fut = self._pool.submit(self._stage_out, hb, snap)
            elif kind == "in_lazy":
                # restore_last_only families: the payload re-registers
                # host-side without an upload — but it must still ride the
                # worker FIFO so an "out" of the same content earlier this
                # iteration has produced the payload before we hand it over
                fut = self._pool.submit(self._stage_lazy, hb)
            else:
                fut = self._pool.submit(self._stage_in, hb)
            self._inflight[bid] = (kind, fut)

    def _stage_out(self, hb, snap):
        t0 = time.perf_counter()
        hb.payload = self.runner.materialize(snap)
        self._account(hb.n_bytes, time.perf_counter() - t0)
        return None

    def _stage_in(self, hb):
        # single-worker FIFO: the "out" that produced this payload (possibly
        # this very iteration) has already run by the time we get here
        assert hb.payload is not None, \
            f"swap-in of block hash {hb.hash} with no staged payload"
        t0 = time.perf_counter()
        staged = self.runner.stage_payload(hb.payload)
        self._account(hb.n_bytes, time.perf_counter() - t0)
        return staged

    def _stage_lazy(self, hb):
        # no link traffic and no calibration sample: a lazy restore only
        # hands the (already host-resident) payload back to the runner
        assert hb.payload is not None, \
            f"lazy swap-in of block hash {hb.hash} with no staged payload"
        return hb.payload

    def _account(self, n_bytes: int, dt: float) -> None:
        with self._samples_lock:
            self.staged_wall += dt
            if len(self._samples) < 2048:
                self._samples.append((n_bytes, dt))

    def fence(self, bids: Iterable[int]) -> None:
        """Complete every in-flight transfer touching ``bids``: block on
        the worker and, for swap-ins, apply the pool scatter."""
        for bid in list(bids):
            entry = self._inflight.pop(bid, None)
            if entry is None:
                continue
            kind, fut = entry
            t0 = time.perf_counter()
            staged = fut.result()
            if kind == "in":
                self.runner.write_block(bid, staged)
            elif kind == "in_lazy":
                self.runner.write_block_lazy(bid, staged)
            self.exposed_wall += time.perf_counter() - t0

    def flush(self) -> None:
        self.fence(list(self._inflight))

    def inflight_blocks(self) -> int:
        return len(self._inflight)

    def drain_samples(self) -> List[Tuple[int, float]]:
        with self._samples_lock:
            out, self._samples = self._samples, []
        return out


@dataclass
class EngineStats:
    iterations: List[IterationRecord] = field(default_factory=list)
    finished: List[Request] = field(default_factory=list)
    aborted: List[Request] = field(default_factory=list)

    def offline_throughput(self) -> float:
        """Completed offline work (prompt + generated tokens of finished
        offline requests) per second. Reused prefixes count as progress —
        that is precisely the benefit of prefix caching."""
        if not self.iterations:
            return 0.0
        done = [r for r in self.finished if not r.is_online]
        total = sum(r.prompt_len + r.n_output for r in done)
        # makespan of the offline work: last instant offline was active
        t = max((r.t for r in self.iterations if r.offline_tokens > 0),
                default=self.iterations[-1].t)
        return total / (t + 1e-9)

    def offline_computed_rate(self) -> float:
        """Offline tokens actually computed / s (excludes cache-skipped)."""
        if not self.iterations:
            return 0.0
        total = sum(r.offline_tokens for r in self.iterations)
        return total / (self.iterations[-1].t + 1e-9)

    @property
    def swapped_in_tokens(self) -> int:
        """Total tokens restored host->device instead of recomputed."""
        return sum(r.swap_in_tokens for r in self.iterations)

    @property
    def swapped_out_tokens(self) -> int:
        """Total tokens parked device->host instead of dropped."""
        return sum(r.swap_out_tokens for r in self.iterations)

    @property
    def swapped_in_bytes(self) -> int:
        """Total PCIe bytes of restores (what the link actually moved)."""
        return sum(r.swap_in_bytes for r in self.iterations)

    @property
    def swapped_out_bytes(self) -> int:
        """Total PCIe bytes of parks."""
        return sum(r.swap_out_bytes for r in self.iterations)

    @property
    def migrated_in_bytes(self) -> int:
        """Total fabric bytes of cross-replica prefix arrivals clocked."""
        return sum(r.migrate_in_bytes for r in self.iterations)

    @property
    def swap_transfer_time(self) -> float:
        """Total PCIe seconds put on the copy stream."""
        return sum(r.swap_transfer_time for r in self.iterations)

    @property
    def swap_exposed_time(self) -> float:
        """Transfer seconds NOT hidden under compute (what the clock and
        the SLO budget actually paid)."""
        return sum(r.swap_exposed_time for r in self.iterations)

    def swap_hidden_frac(self) -> float:
        """Fraction of swap traffic the overlap hid: 0.0 on the serial
        path, approaching 1.0 when compute fully covers the transfers."""
        transfer = self.swap_transfer_time
        if transfer <= 0.0:
            return 0.0
        return max(1.0 - self.swap_exposed_time / transfer, 0.0)

    def slo_attainment(self, kind: str = "ttft") -> float:
        """Fraction of decidable online requests meeting the SLO. Requests
        for which the metric is undefined (no first token for ttft; fewer
        than 2 output tokens for tpot) are excluded from the denominator —
        counting them as hits or misses would skew the two kinds opposite
        ways."""
        online = [r for r in self.finished if r.is_online and r.slo]
        ok = n = 0
        for r in online:
            v = r.ttft() if kind == "ttft" else r.tpot()
            if v is None:
                continue
            n += 1
            ok += v <= (r.slo.ttft if kind == "ttft" else r.slo.tpot)
        return ok / n if n else 1.0


class EchoEngine:
    """With model+params this executes real forwards on the paged runner;
    with ``model=None`` it is the paper's §5.4 simulator: the same scheduler
    + KV manager loop, clocked purely by the time model (tokens fabricated
    per-request deterministically so block hashing stays realistic).

    ``device`` places the runner's weights and page pool: ``"cuda"`` (the
    default) launches the Hopper kernels and raises where no card is
    present; ``"cpu"`` runs their plain PyTorch versions."""

    def __init__(self, model: Optional[Model], params, policy: PolicyConfig, *,
                 num_blocks: int = 256, block_size: int = 16,
                 chunk_size: int = 64, max_pages_per_seq: int = 32,
                 time_model: Optional[TimeModel] = None,
                 clock_model=None, calibrator: Optional[OnlineCalibrator] = None,
                 clock: str = "virtual", seed: int = 0,
                 max_batch_tokens: int = 2048, max_running: int = 64,
                 host_kv_blocks: int = 0,
                 io_spec: Optional[BlockIOSpec] = None,
                 attn_impl: str = "auto",
                 device="cuda"):
        self.model = model
        self.policy = policy
        self.clock = clock
        self.pool = OfflinePool(block_size)
        # byte pricing of this engine's blocks: derived from the model's
        # architecture (paged KV pages vs. fixed-size state snapshots), the
        # 8B-magnitude paged default on the model-less simulator path
        if io_spec is None:
            io_spec = (io_spec_for_model(model) if model is not None
                       else paged_spec())
        self.io = io_spec
        self.bm = BlockManager(num_blocks, block_size,
                               task_aware=policy.task_aware_kv,
                               rc_provider=self.pool.rc,
                               host_blocks=host_kv_blocks,
                               io=io_spec)
        self.tm = time_model or TimeModel()
        # Ground-truth clock vs. scheduler estimate (§5 calibration loop):
        # `tm` is what the scheduler *believes*; `clock_model` is what the
        # hardware *does* (a different preset or a PerturbedTimeModel).
        # Defaulting to `tm` keeps the classic perfect-estimate simulator.
        self.clock_model = clock_model if clock_model is not None else self.tm
        self.calibrator = calibrator
        if self.calibrator is None and policy.calibrate:
            self.calibrator = OnlineCalibrator(self.tm)
        self.scheduler = Scheduler(self.bm, self.pool, self.tm, policy,
                                   chunk_size=chunk_size,
                                   max_batch_tokens=max_batch_tokens,
                                   max_running=max_running)
        self.runner = None
        if model is not None:
            if not set(model.cfg.attn_layers) <= {"attn", "moe"}:
                raise NotImplementedError(
                    "the state-snapshot runner (SSM / RG-LRU / hybrid) is "
                    "not ported yet")
            # imported here: the runner imports core.block_io, whose
            # package imports this module
            from repro_torch.models.paged import TorchPagedRunner
            self.runner = TorchPagedRunner(model, params, num_blocks,
                                           block_size, max_pages_per_seq,
                                           chunk_size, attn_impl=attn_impl,
                                           device=device)
        # async swap/compute overlap (wall path): a single-worker copy
        # stream double-buffers payload staging against runner compute, with
        # per-block fences before first touch. Gated on the same switch the
        # virtual clock and the scheduler's estimate use (tm.swap_overlap).
        self._stager: Optional[_SwapStager] = None
        if (self.runner is not None and self.bm.host is not None
                and hasattr(self.runner, "snapshot_block")
                and getattr(self.tm, "swap_overlap", False)):
            self._stager = _SwapStager(self.runner)
        # cumulative stager seconds already attributed to an iteration
        # record — worker staging that lands between steps (or during idle
        # launches) is picked up by the NEXT record instead of dropped
        self._staged_seen = 0.0
        self._exposed_seen = 0.0
        self.mem_pred = MemoryPredictor(window=120.0)
        self.now = 0.0
        self.stats = EngineStats()
        self._pending_swap_out = 0     # staged on an idle tick; next record
        self._pending_swap_out_bytes = 0
        self._pending_swap_in_bytes = 0
        self._pending_swap_wall = 0.0  # its wall time (wall-clock path)
        self._pending_migrate_in_bytes = 0  # fabric arrivals awaiting clock
        self.pending: List[Request] = []       # (arrival_time, rid) ordered
        self.listeners: List[EngineListener] = []
        self._rng = np.random.default_rng(seed)
        # step() is not reentrant and not thread-safe: the real-time layer
        # drives it from a worker thread (asyncio.to_thread), so a second
        # concurrent driver must fail loudly instead of corrupting the
        # scheduler/KV state mid-iteration
        self._step_lock = threading.Lock()

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        bisect.insort(self.pending, req,
                      key=lambda r: (r.arrival_time, r.rid))

    def _pull_arrivals(self) -> None:
        prev = -float("inf")
        while self.pending and self.pending[0].arrival_time <= self.now:
            req = self.pending.pop(0)
            assert req.arrival_time >= prev, "pending drained out of order"
            prev = req.arrival_time
            self.scheduler.submit(req)

    def abort(self, req: Request) -> bool:
        """Cancel a request mid-flight: remove it from every intake and
        scheduler structure it sits in and release all its resources — KV
        blocks (``finished=True``: an aborted owner never returns, so no
        unfinished-owner pins), radix-pool membership (dropping its RC
        contribution), and any live runner state. Returns False for
        already-terminal requests, True otherwise. Safe to call between
        iterations or from an ``EngineListener`` callback."""
        if req.state in (RequestState.FINISHED, RequestState.ABORTED):
            return False
        found = False
        if req in self.pending:
            self.pending.remove(req)
            found = True
        sched = self.scheduler
        if req in sched.online_queue:
            sched.online_queue.remove(req)
            found = True
        if req in self.pool:
            self.pool.remove(req)
            found = True
        if req in sched.running:
            sched.running.remove(req)
            found = True
        if req.block_ids:
            self.bm.free_request(req, self.now, finished=True)
            found = True
        if not found:
            return False            # not this engine's request
        # a previously-preempted request holds unfinished-owner pins on
        # committed blocks it no longer references (device or host tier) —
        # the aborted owner never returns, so the pins must drop too
        self.bm.release_owner_pins(req)
        if self.runner is not None:
            self.runner.release(req.rid)
        req.state = RequestState.ABORTED
        self.stats.aborted.append(req)
        return True

    # ------------------------------------------------------------- helpers
    def _fabricate(self, req: Request) -> np.ndarray:
        """Simulator mode: deterministic pseudo-random next-token logits
        (per request) so generated-block hashes stay realistic."""
        rng = np.random.default_rng((req.rid << 20) + req.n_output)
        out = np.zeros(128, np.float32)
        out[rng.integers(0, 128)] = 1.0
        return out

    def _emit(self, req: Request, logits: np.ndarray) -> None:
        if req.state == RequestState.ABORTED:
            return          # aborted from a listener callback this iteration
        tok = int(np.argmax(logits))
        req.record_token(tok, self.now)
        for l in self.listeners:
            l.on_token(req, tok, self.now)
        if req.done:
            self.bm.free_request(req, self.now, finished=True)
            # discharge stale owner pins: a request that was preempted and
            # then recomputed (rather than swapped back) may still pin the
            # host copies of blocks it re-registered on device
            self.bm.release_owner_pins(req)
            if req in self.scheduler.running:
                self.scheduler.running.remove(req)
            if self.runner is not None:
                self.runner.release(req.rid)
            self.stats.finished.append(req)
            for l in self.listeners:
                l.on_finish(req, self.now)

    def predicted_first_token_latency(self, req: Request) -> float:
        """Engine-local time to ``req``'s first token if placed here: its own
        prefill plus all online prefill work ahead of it, overlapped with the
        running decode batch (Eq.6-8), plus any clock skew (an engine whose
        virtual clock is already past the arrival cannot start it earlier
        than its own ``now``). Uses the scheduler's — possibly
        online-calibrated — estimate model. Shared by the cluster router's
        online placement and the serving layer's SLO-feasibility shedding."""
        sched = self.scheduler
        spans = [(0, len(req.prompt))]
        for r in sched.online_queue:
            spans.append((0, len(r.full_tokens)))
        for r in self.pending:
            if r.is_online:
                spans.append((0, len(r.full_tokens)))
        for r in sched.running:
            if r.is_online and not r.prefill_done:
                spans.append((r.computed_tokens, r.prefill_target_len))
        dlens = [r.total_len + 1 for r in sched.running
                 if r.prefill_done and not r.done]
        t = self.tm.batch_time(spans, dlens)
        return t + max(self.now - req.arrival_time, 0.0)

    def _online_kv_tokens(self) -> int:
        return sum(r.total_len for r in self.scheduler.running if r.is_online)

    # --------------------------------------------------------- load signals
    # Single source of truth for the accounting shared by cluster replicas
    # (router placement) and serving backends (admission control).
    def has_work(self) -> bool:
        return bool(self.pending or self.scheduler.online_queue
                    or self.scheduler.running or len(self.pool))

    def online_queue_depth(self) -> int:
        """Online requests waiting to run: queued at the scheduler or still
        in the pending intake."""
        n = len(self.scheduler.online_queue)
        n += sum(1 for r in self.pending if r.is_online)
        return n

    def offline_backlog(self) -> int:
        """Pooled + pending + running offline work."""
        n = len(self.pool)
        n += sum(1 for r in self.pending if not r.is_online)
        n += sum(1 for r in self.scheduler.running if not r.is_online)
        return n

    def _execute_swaps(self) -> Tuple[int, int, int]:
        """Dispatch the block staging of this iteration's swap decisions.

        With the async stager (wall path, overlap on) this only *launches*
        the transfers: device-side snapshots are dispatched here — before
        any runner write, while an "out" block's payload is still intact —
        and the blocking copies run on the copy worker; the per-request
        fences in ``step`` complete whatever the plan actually touches.
        Without it (overlap off, or no backing runner) payloads are staged
        inline exactly as before. On the virtual path the journal is
        drained for accounting alone. Returns (swapped-out tokens,
        swapped-out bytes, swapped-in bytes) — swap-in *tokens* are known
        from the plan, but the link-clocked byte weights come from the
        journal, where "in_lazy" restores correctly weigh zero."""
        events = self.bm.drain_swap_events()
        out_tokens = sum(hb.n_tokens for kind, _, hb in events
                         if kind == "out")
        out_bytes = sum(hb.n_bytes for kind, _, hb in events
                        if kind == "out")
        in_bytes = sum(hb.n_bytes for kind, _, hb in events
                       if kind == "in")
        if self._stager is not None:
            self._stager.launch(events)
            return out_tokens, out_bytes, in_bytes
        stage = self.runner is not None and hasattr(self.runner, "read_block")
        for kind, bid, hb in events:
            if kind == "out":
                if stage:
                    hb.payload = self.runner.read_block(bid)
            elif stage:
                assert hb.payload is not None, \
                    f"swap-in of block hash {hb.hash} with no staged payload"
                if kind == "in_lazy":
                    self.runner.write_block_lazy(bid, hb.payload)
                else:
                    self.runner.write_block(bid, hb.payload)
        return out_tokens, out_bytes, in_bytes

    def _fence(self, bids: Iterable[int]) -> None:
        """Complete in-flight staging on the blocks a runner call is about
        to touch (no-op without the async stager)."""
        if self._stager is not None:
            self._stager.fence(bids)

    def _observe_swap_clock(self, swap_in_bytes: int, swap_out_bytes: int,
                            compute_time: float, iter_time: float,
                            swap_transfer: float) -> None:
        """Feed the calibrator's swap-term windows (ROADMAP: swap terms were
        static after ``fit_swap``): per-event copy-worker timings on the
        wall path, the ground-truth clock's transfer legs on the virtual
        path, and — when overlap is active — the (compute, bytes, total)
        triple that refits the launch overhead. Byte-denominated: KV pages
        and state snapshots feed one pool that recovers the link rate."""
        cal = self.calibrator
        total_bytes = swap_in_bytes + swap_out_bytes
        if self._stager is not None and self.clock != "virtual":
            for n, dt in self._stager.drain_samples():
                cal.observe_swap(n, dt)
        elif self.clock == "virtual":
            if not hasattr(self.clock_model, "swap_time"):
                return
            if swap_in_bytes:
                cal.observe_swap(swap_in_bytes,
                                 self.clock_model.swap_time(swap_in_bytes))
            if swap_out_bytes:
                cal.observe_swap(swap_out_bytes,
                                 self.clock_model.swap_time(swap_out_bytes))
        elif total_bytes and swap_transfer > 0.0:
            cal.observe_swap(total_bytes, swap_transfer)
        if total_bytes and getattr(self.tm, "swap_overlap", False):
            cal.observe_overlap(compute_time, total_bytes, iter_time)

    # ---------------------------------------------------------- migration
    def export_prefix(self, tokens) -> Tuple[List[HostBlock], int]:
        """Pull the leading cached prefix of ``tokens`` out of this engine
        as shippable ``HostBlock``s — the source side of cross-replica KV
        migration (a draining replica, or one the router just stole from).
        In-flight staging is flushed first so every payload is settled; the
        walk stops at the first block absent from both tiers or still
        referenced by a running request. Returns (blocks, total fabric
        bytes). The *destination* engine charges the fabric time."""
        self.flush_swaps()
        reader = None
        if self.runner is not None and hasattr(self.runner, "read_block"):
            reader = self.runner.read_block
        out: List[HostBlock] = []
        for h in prefix_chain(tokens, self.bm.block_size):
            hb = self.bm.export_block(h, reader)
            if hb is None:
                break
            out.append(hb)
        return out, sum(hb.n_bytes for hb in out)

    def import_prefix(self, hbs: Iterable[HostBlock]) -> int:
        """Land migrated blocks in this engine's host tier, where the
        ordinary swap-in path restores them exactly like a locally parked
        prefix. Admitted bytes are charged to the next iteration's transfer
        leg at the ground-truth clock's ``migrate_time`` rate. Returns the
        bytes actually admitted (duplicates and host-tier bounces are
        free — nothing crossed the fabric)."""
        n_bytes = 0
        for hb in hbs:
            if self.bm.import_host_block(hb, self.now):
                n_bytes += hb.n_bytes
        self._pending_migrate_in_bytes += n_bytes
        return n_bytes

    def next_arrival_time(self) -> Optional[float]:
        """Earliest pending arrival (engine-clock domain), or None. The
        real-time loop uses it to sleep precisely while idle instead of
        spinning on ``step``."""
        return self.pending[0].arrival_time if self.pending else None

    def flush_swaps(self) -> None:
        """Land every in-flight host<->device staging transfer. ``run``
        calls this before going idle; the real-time layer calls it during
        graceful drain so no swap payload is lost when the loop stops."""
        if self._stager is not None:
            self._stager.flush()

    # ------------------------------------------------------------- step
    def step(self) -> Optional[IterationRecord]:
        """One scheduler+execute iteration. Serialized: a second driver
        entering while an iteration is mid-flight (the RT loop's worker
        thread vs. a direct caller) raises instead of interleaving."""
        if not self._step_lock.acquire(blocking=False):
            raise RuntimeError(
                "EchoEngine.step() re-entered while an iteration is in "
                "flight — the engine must have exactly one driver")
        try:
            return self._step_impl()
        finally:
            self._step_lock.release()

    def _step_impl(self) -> Optional[IterationRecord]:
        self._pull_arrivals()
        tsched = time.perf_counter()
        plan = self.scheduler.schedule(self.now)
        ts0 = time.perf_counter()
        schedule_wall = ts0 - tsched
        out_tok, out_bytes, in_bytes = self._execute_swaps()
        swap_out_tokens = out_tok + self._pending_swap_out
        swap_out_bytes = out_bytes + self._pending_swap_out_bytes
        swap_in_bytes = in_bytes + self._pending_swap_in_bytes
        swap_wall = time.perf_counter() - ts0 + self._pending_swap_wall
        migrate_in_bytes = self._pending_migrate_in_bytes
        self._pending_swap_out = 0
        self._pending_swap_out_bytes = 0
        self._pending_swap_in_bytes = 0
        self._pending_swap_wall = 0.0
        self._pending_migrate_in_bytes = 0
        swap_in_tokens = plan.swap_in_tokens
        if plan.n_scheduled == 0 and not plan.swap_ins:
            # an empty plan can still carry preemptions (victims freed for
            # an admission that then failed): their runner state and
            # listener events must not be skipped
            if plan.preempted:
                if self.runner is not None:
                    for req in plan.preempted:
                        self.runner.release(req.rid)
                for req in plan.preempted:
                    for l in self.listeners:
                        l.on_preempt(req, self.now)
            self._pending_swap_out = swap_out_tokens
            self._pending_swap_out_bytes = swap_out_bytes
            self._pending_swap_in_bytes = swap_in_bytes
            self._pending_swap_wall += swap_wall
            self._pending_migrate_in_bytes = migrate_in_bytes
            # idle: advance to next arrival
            if self.pending:
                self.now = max(self.now, self.pending[0].arrival_time)
                return None
            return None

        st = self._stager
        exposed_pre = st.exposed_wall if st is not None else 0.0
        t0 = time.perf_counter()
        offline_tokens = 0
        online_tokens = 0
        emissions = []
        if self.runner is not None:
            for req in plan.preempted:      # drop live recurrent state
                self.runner.release(req.rid)

        # ---- prefill chunks (one by one, §5.2)
        for req, chunk in plan.prefills:
            start = req.computed_tokens
            toks = req.full_tokens[start: start + chunk]
            if self.runner is not None:
                # complete in-flight staging on this request's blocks only —
                # other requests' transfers keep overlapping with this chunk
                self._fence(req.block_ids)
                logits = self.runner.prefill_chunk(list(toks), start,
                                                   req.block_ids, rid=req.rid)
            else:
                logits = self._fabricate(req)
            req.computed_tokens = start + chunk
            self.bm.commit(req, req.full_tokens, self.now)
            if req.is_online:
                online_tokens += chunk
            else:
                offline_tokens += chunk
            if req.n_preemptions and start < req.prefill_target_len:
                req.recomputed_tokens += chunk
            if req.prefill_done:
                emissions.append((req, logits))

        # ---- decode batch
        decodes = [r for r in plan.decodes if not r.done]
        if decodes:
            if self.runner is not None:
                self._fence({b for r in decodes for b in r.block_ids})
                tokens = [r.full_tokens[r.computed_tokens] for r in decodes]
                bts = [r.block_ids for r in decodes]
                pos = [r.computed_tokens for r in decodes]
                logits = self.runner.decode(tokens, bts, pos,
                                            rids=[r.rid for r in decodes])
            else:
                logits = np.stack([self._fabricate(r) for r in decodes])
            for i, req in enumerate(decodes):
                req.computed_tokens += 1
                self.bm.commit(req, req.full_tokens, self.now)
                if req.is_online:
                    online_tokens += 1
                else:
                    offline_tokens += 1
                emissions.append((req, logits[i]))

        wall = time.perf_counter() - t0
        spans = [(r.computed_tokens - c, r.computed_tokens)
                 for r, c in plan.prefills]
        dlens = [r.total_len for r in decodes]
        # PCIe swap traffic — BOTH directions — is clocked separately from
        # compute: the calibrator must see pure compute time or the Eq.6-8
        # refit would absorb transfer cost into the prefill coefficients.
        # Under overlap only the *exposed* tail reaches the iteration time:
        # the virtual clock charges max(compute, transfer) + launch, and on
        # the wall path the copy worker really did stage concurrently — the
        # fence stalls inside the runner window are the exposed tail.
        clock = self.clock_model
        transfer = ((clock.swap_time(swap_in_bytes)
                     + clock.swap_time(swap_out_bytes))
                    if hasattr(clock, "swap_time") else 0.0)
        # cross-replica arrivals ride the same copy-stream leg, priced at
        # the inter-node fabric rate instead of the local PCIe rate
        migrate_transfer = (clock.migrate_time(migrate_in_bytes)
                            if migrate_in_bytes
                            and hasattr(clock, "migrate_time") else 0.0)
        transfer += migrate_transfer
        if self.clock == "virtual":
            compute_time = clock.batch_time(spans, dlens)
            if transfer > 0.0 and hasattr(clock, "overlapped_iteration_time"):
                iter_time = clock.overlapped_iteration_time(compute_time,
                                                            transfer)
            else:
                iter_time = compute_time + transfer
            swap_transfer = transfer
            swap_exposed = iter_time - compute_time
        elif st is not None:
            # attribute everything accrued since the last record (staging
            # from the scheduling gap / idle launches included), but only
            # subtract the fences that stalled THIS runner window from the
            # calibrator's compute sample
            swap_transfer = st.staged_wall - self._staged_seen
            swap_exposed = st.exposed_wall - self._exposed_seen
            self._staged_seen = st.staged_wall
            self._exposed_seen = st.exposed_wall
            compute_time = max(wall - (st.exposed_wall - exposed_pre), 0.0)
            iter_time = wall + swap_wall      # swap_wall: launch overhead
        else:
            # synchronous staging happened in _execute_swaps, outside the
            # runner window, so its measured time is added back — fully
            # exposed, exactly the pre-overlap wall clock
            swap_transfer = swap_exposed = swap_wall
            compute_time = wall
            iter_time = wall + swap_wall
        self.now += iter_time
        if self.calibrator is not None:
            # feed the observed clock back into the scheduler's estimate
            self.calibrator.observe(self.now, spans, dlens, compute_time)
            self._observe_swap_clock(swap_in_bytes, swap_out_bytes,
                                     compute_time, iter_time,
                                     swap_transfer - migrate_transfer)
            if migrate_transfer > 0.0:
                self.calibrator.observe_migration(migrate_in_bytes,
                                                  migrate_transfer)
        for req, lg in emissions:               # tokens arrive at iteration end
            self._emit(req, lg)
        for req in plan.preempted:
            for l in self.listeners:
                l.on_preempt(req, self.now)
        if swap_out_tokens:
            for l in self.listeners:
                l.on_swap_out(swap_out_tokens, self.now)
        for req, n in plan.swap_ins:
            for l in self.listeners:
                l.on_swap_in(req, n, self.now)
        if swap_transfer > 0.0:
            for l in self.listeners:
                l.on_swap_overlap(swap_transfer, swap_exposed, self.now)

        # ---- estimator feedback + threshold update (§5.3)
        online_kv = self._online_kv_tokens()
        self.mem_pred.observe(self.now, online_kv)
        if self.policy.task_aware_kv:
            self.bm.threshold_blocks = self.mem_pred.threshold_blocks(
                self.bm.num_blocks, self.bm.block_size, online_kv,
                self.bm.clean_evictable_count())
            if self.bm.host is not None:
                # host-tier headroom for the predicted burst's swap-outs,
                # plus the slots whose payloads are still staging in flight
                self.bm.host.reserve = self.mem_pred.host_reserve_blocks(
                    self.bm.block_size, online_kv,
                    cap_blocks=self.bm.host.capacity,
                    inflight_blocks=(st.inflight_blocks()
                                     if st is not None else 0),
                    io=self.io)
        t_start = self.now - iter_time
        rec = IterationRecord(
            t=self.now,
            n_prefill=len(plan.prefills),
            n_decode=len(decodes),
            n_online=sum(1 for r in self.scheduler.running if r.is_online),
            n_offline=sum(1 for r in self.scheduler.running if not r.is_online),
            iter_time=iter_time,
            offline_tokens=offline_tokens,
            online_tokens=online_tokens,
            usage=self.bm.usage_breakdown(),
            hit_rate=self.bm.metrics.hit_rate,
            threshold_blocks=self.bm.threshold_blocks,
            swap_in_tokens=swap_in_tokens,
            swap_out_tokens=swap_out_tokens,
            swap_in_bytes=swap_in_bytes,
            swap_out_bytes=swap_out_bytes,
            host_blocks=len(self.bm.host) if self.bm.host is not None else 0,
            swap_transfer_time=swap_transfer,
            swap_exposed_time=swap_exposed,
            migrate_in_bytes=migrate_in_bytes,
        )
        self.stats.iterations.append(rec)
        base_hook = EngineListener.on_iteration
        detailed = [l for l in self.listeners
                    if type(l).on_iteration is not base_hook]
        if detailed:
            detail = IterationDetail(
                t_start=t_start, t_end=self.now,
                schedule_wall=schedule_wall,
                compute_time=compute_time,
                predicted_time=plan.est_time,
                admitted=plan.admitted,
                prefill_spans=[(r, s, e) for (r, _), (s, e)
                               in zip(plan.prefills, spans)],
                decodes=decodes)
            for l in detailed:
                l.on_iteration(rec, detail)
        return rec

    # ------------------------------------------------------------- loops
    def run(self, max_iters: int = 10_000,
            until_time: Optional[float] = None) -> EngineStats:
        stalls = 0
        for _ in range(max_iters):
            if until_time is not None and self.now >= until_time:
                break
            if not self.has_work():
                break
            rec = self.step()
            if rec is None and not self.pending:
                stalls += 1
                if stalls > MAX_STALLS:  # nothing schedulable: deadlock guard
                    break
            else:
                stalls = 0
        self.flush_swaps()             # land in-flight payloads before idle
        return self.stats
