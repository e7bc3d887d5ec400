"""Service event bus + live metrics.

The bus turns engine-level lifecycle hooks into subscriber callbacks keyed
by event name — the push-based replacement for scraping ``EngineStats``
after a run. ``LiveMetrics`` is the canonical subscriber: it maintains the
paper's headline metrics (SLO attainment, completed offline tokens,
finished counts) incrementally from events, matching the post-hoc
``EngineStats`` accounting on the decidable-request rule.
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import Histogram, LATENCY_BUCKETS
from repro_torch.serving.handle import RequestHandle, TokenEvent

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class SwapEvent:
    """KV traffic between the device cache and the host tier. Swap-ins
    belong to the request whose prefix was restored; swap-outs are
    hash-level (the evicted block may serve many future requests), so
    ``handle`` is None for them."""
    tokens: int
    t: float
    handle: Optional[RequestHandle] = None


@dataclass(frozen=True)
class OverlapEvent:
    """One iteration's swap/compute overlap accounting: ``transfer`` seconds
    of PCIe traffic were put on the copy stream, of which only ``exposed``
    seconds reached the clock (the tail compute could not hide)."""
    transfer: float
    exposed: float
    t: float

    @property
    def hidden(self) -> float:
        return max(self.transfer - self.exposed, 0.0)


class EventBus:
    """Named-event subscriptions. ``token``/``first_token`` callbacks get a
    ``TokenEvent``; ``finish``/``preempt``/``abort``/``shed``/``requeue``
    callbacks get the ``RequestHandle``; ``swap_in``/``swap_out`` get a
    ``SwapEvent``. Callbacks run synchronously at iteration end.

    Emission is serialized under one re-entrant lock: the real-time layer
    drives ``engine.step`` on a worker thread while the event loop thread
    sheds/aborts through the same service, so two threads can reach
    ``emit`` concurrently. The lock makes every subscriber — LiveMetrics
    above all — single-threaded by construction (callbacks may re-emit;
    hence re-entrant)."""

    EVENTS = ("token", "first_token", "finish", "preempt", "abort", "shed",
              "requeue", "swap_in", "swap_out", "swap_overlap")

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = {e: [] for e in self.EVENTS}
        # a raising subscriber must not take the serving loop down with it:
        # emit() swallows the exception, counts it here, and keeps going
        self.dropped_callbacks = 0
        self._warned: set = set()
        self._lock = threading.RLock()

    def subscribe(self, event: str, cb: Callable) -> Callable:
        if event not in self._subs:
            raise ValueError(f"unknown event {event!r}; "
                             f"expected one of {self.EVENTS}")
        with self._lock:
            self._subs[event].append(cb)
        return cb                      # decorator-friendly

    def unsubscribe(self, event: str, cb: Callable) -> None:
        with self._lock:
            self._subs[event].remove(cb)

    # convenience decorators / registrars --------------------------------
    def on_token(self, cb: Callable[[TokenEvent], None]) -> Callable:
        return self.subscribe("token", cb)

    def on_first_token(self, cb: Callable[[TokenEvent], None]) -> Callable:
        return self.subscribe("first_token", cb)

    def on_finish(self, cb: Callable[[RequestHandle], None]) -> Callable:
        return self.subscribe("finish", cb)

    def on_preempt(self, cb: Callable[[RequestHandle], None]) -> Callable:
        return self.subscribe("preempt", cb)

    def on_abort(self, cb: Callable[[RequestHandle], None]) -> Callable:
        return self.subscribe("abort", cb)

    def on_shed(self, cb: Callable[[RequestHandle], None]) -> Callable:
        return self.subscribe("shed", cb)

    def on_requeue(self, cb: Callable[[RequestHandle], None]) -> Callable:
        """Deferred offline work re-admitted from the overflow queue."""
        return self.subscribe("requeue", cb)

    def on_swap_in(self, cb: Callable[[SwapEvent], None]) -> Callable:
        return self.subscribe("swap_in", cb)

    def on_swap_out(self, cb: Callable[[SwapEvent], None]) -> Callable:
        return self.subscribe("swap_out", cb)

    def on_swap_overlap(self, cb: Callable[[OverlapEvent], None]) -> Callable:
        """Per-iteration swap/compute overlap accounting (transfer vs the
        exposed tail that actually reached the clock)."""
        return self.subscribe("swap_overlap", cb)

    # emission ------------------------------------------------------------
    def emit(self, event: str, payload) -> None:
        with self._lock:
            for cb in list(self._subs[event]):
                try:
                    cb(payload)
                except Exception:
                    self.dropped_callbacks += 1
                    key = (event, cb)
                    if key not in self._warned:   # log once per (event, cb)
                        self._warned.add(key)
                        logger.warning("subscriber %r raised on %r; "
                                       "suppressing further warnings for "
                                       "this pair", cb, event, exc_info=True)


class LiveMetrics:
    """Event-driven serving metrics, updated as tokens stream.

    Attainment follows ``EngineStats.slo_attainment`` exactly: only
    *decidable* finished online requests enter the denominator (ttft needs a
    first token; tpot needs >= 2 output tokens), so at end of run the live
    numbers equal the post-hoc scrape.

    Thread-safety: every handler runs inside ``EventBus.emit``'s lock, so
    the counters stay exact even when the off-thread step loop and the
    event-loop thread emit concurrently — no locking needed here."""

    def __init__(self, bus: EventBus):
        self.online_tokens = 0
        self.offline_tokens = 0
        self.first_tokens = 0
        self.finished_online = 0
        self.finished_offline = 0
        self.aborted = 0
        self.shed = 0
        self.preemptions = 0
        self.requeued = 0                   # deferred -> queued transitions
        self.swap_ins = 0
        self.swap_outs = 0
        self.swapped_in_tokens = 0          # recompute avoided via host KV
        self.swapped_out_tokens = 0
        self.swap_transfer_time = 0.0       # PCIe seconds on the copy stream
        self.swap_exposed_time = 0.0        # the tail NOT hidden by compute
        self.completed_offline_tokens = 0   # prompt + generated, on finish
        self.last_offline_finish_t: Optional[float] = None
        self._slo = {"ttft": [0, 0], "tpot": [0, 0]}    # kind -> [ok, n]
        # pre-bucketed latency distributions (p50/p90/p99 queries); recorded
        # on finish for online requests, matching the attainment denominator
        self.hists: Dict[str, Histogram] = {
            "ttft": Histogram("ttft_seconds", "time to first token",
                              buckets=LATENCY_BUCKETS),
            "tpot": Histogram("tpot_seconds", "time per output token",
                              buckets=LATENCY_BUCKETS),
            "queue_delay": Histogram("queue_delay_seconds",
                                     "arrival to first batch admission",
                                     buckets=LATENCY_BUCKETS),
        }
        bus.on_token(self._token)
        bus.on_first_token(self._first_token)
        bus.on_finish(self._finish)
        bus.on_preempt(self._preempt)
        bus.on_abort(self._abort)
        bus.on_shed(self._shed_cb)
        bus.on_requeue(self._requeue)
        bus.on_swap_in(self._swap_in)
        bus.on_swap_out(self._swap_out)
        bus.on_swap_overlap(self._swap_overlap)

    # ------------------------------------------------------------- handlers
    def _token(self, ev: TokenEvent) -> None:
        if ev.handle.request.is_online:
            self.online_tokens += 1
        else:
            self.offline_tokens += 1

    def _first_token(self, ev: TokenEvent) -> None:
        self.first_tokens += 1

    def _finish(self, handle: RequestHandle) -> None:
        req = handle.request
        qd = req.queue_delay()
        if qd is not None:
            self.hists["queue_delay"].observe(qd)
        if req.is_online:
            self.finished_online += 1
            ttft, tpot = req.ttft(), req.tpot()
            if ttft is not None:
                self.hists["ttft"].observe(ttft)
            if tpot is not None:
                self.hists["tpot"].observe(tpot)
            if req.slo is not None:
                if ttft is not None:
                    self._slo["ttft"][1] += 1
                    self._slo["ttft"][0] += ttft <= req.slo.ttft
                if tpot is not None:
                    self._slo["tpot"][1] += 1
                    self._slo["tpot"][0] += tpot <= req.slo.tpot
        else:
            self.finished_offline += 1
            self.completed_offline_tokens += req.prompt_len + req.n_output
            self.last_offline_finish_t = req.finish_time

    def _preempt(self, handle: RequestHandle) -> None:
        self.preemptions += 1

    def _abort(self, handle: RequestHandle) -> None:
        self.aborted += 1

    def _shed_cb(self, handle: RequestHandle) -> None:
        self.shed += 1

    def _requeue(self, handle: RequestHandle) -> None:
        self.requeued += 1

    def _swap_in(self, ev: SwapEvent) -> None:
        self.swap_ins += 1
        self.swapped_in_tokens += ev.tokens

    def _swap_out(self, ev: SwapEvent) -> None:
        self.swap_outs += 1
        self.swapped_out_tokens += ev.tokens

    def _swap_overlap(self, ev: "OverlapEvent") -> None:
        self.swap_transfer_time += ev.transfer
        self.swap_exposed_time += ev.exposed

    # ------------------------------------------------------------- queries
    def swap_hidden_frac(self) -> float:
        """Fraction of swap traffic the overlap hid (0.0 serial/swap-free),
        matching ``EngineStats.swap_hidden_frac`` at end of run."""
        if self.swap_transfer_time <= 0.0:
            return 0.0
        return max(1.0 - self.swap_exposed_time / self.swap_transfer_time,
                   0.0)

    def slo_attainment(self, kind: str = "ttft") -> float:
        ok, n = self._slo[kind]
        return ok / n if n else 1.0

    def offline_throughput(self) -> float:
        """Completed offline work per second of offline activity, from
        events alone (finish-time makespan)."""
        if self.last_offline_finish_t is None:
            return 0.0
        return self.completed_offline_tokens / (self.last_offline_finish_t
                                                + 1e-9)

    def percentile(self, metric: str, q: float) -> Optional[float]:
        """Bucket-interpolated quantile of ``ttft`` / ``tpot`` /
        ``queue_delay``; None before the first observation."""
        return self.hists[metric].percentile(q)

    def percentiles(self, qs=(0.5, 0.9, 0.99)) -> Dict[str, Dict[str, float]]:
        """{"ttft": {"p50": ..., "p90": ..., "p99": ...}, ...} — metrics
        with no observations yet are omitted."""
        out: Dict[str, Dict[str, float]] = {}
        for name, h in self.hists.items():
            vals = {f"p{int(q * 100)}": h.percentile(q) for q in qs}
            if all(v is not None for v in vals.values()):
                out[name] = vals
        return out
