"""EchoService: the unified request-lifecycle facade (one front-end API for
engine and cluster backends).

    service = EchoService(engine_or_cluster,
                          admission=AdmissionConfig(max_online_queue=32))
    h = service.submit(prompt, task_type="online", max_new_tokens=16,
                       slo=SLO(1.0, 0.1))
    for ev in h.tokens():          # streams while the service schedules
        ...
    h.abort()                      # or cancel mid-flight: zero leaked blocks

Three layers below this facade stay unchanged: ``EchoEngine.step()`` is the
low-level iteration primitive, ``ClusterSimulator.step_event()`` its
fleet-wide analogue, and the scheduler/KV manager are untouched. The
service adds what an *online* system needs on top: handles with streaming
and cancellation, an event bus for live metrics, and admission backpressure
instead of an unbounded pending list. ``drive(workload)`` is the
compatibility driver: with admission off it delegates to the backend's own
``run`` loop, so trace benchmarks keep their exact numbers.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.engine import EchoEngine, EngineListener
from repro_torch.core.request import SLO, Request, TaskType
from repro_torch.serving.admission import (ADMIT, DEFER, SHED, AdmissionConfig,
                                     AdmissionController)
from repro_torch.serving.backends import make_backend
from repro_torch.serving.events import (EventBus, LiveMetrics, OverlapEvent,
                                  SwapEvent)
from repro_torch.serving.handle import RequestHandle, TokenEvent


class _ServiceListener(EngineListener):
    """Bridges engine-level hooks onto the service's handles and bus."""

    def __init__(self, service: "EchoService"):
        self.service = service

    def on_token(self, req: Request, tok: int, t: float) -> None:
        self.service._on_token(req, tok, t)

    def on_preempt(self, req: Request, t: float) -> None:
        self.service._on_preempt(req, t)

    def on_finish(self, req: Request, t: float) -> None:
        self.service._on_finish(req, t)

    def on_swap_in(self, req: Request, n_tokens: int, t: float) -> None:
        self.service._on_swap_in(req, n_tokens, t)

    def on_swap_out(self, n_tokens: int, t: float) -> None:
        self.service._on_swap_out(n_tokens, t)

    def on_swap_overlap(self, transfer_s: float, exposed_s: float,
                        t: float) -> None:
        self.service._on_swap_overlap(transfer_s, exposed_s, t)


class EchoService:
    """Unified request-lifecycle API over an ``EchoEngine`` or a
    ``ClusterSimulator`` (routing stays behind the facade)."""

    def __init__(self, backend, *,
                 admission: Union[AdmissionConfig, AdmissionController,
                                  None] = None):
        self.backend = make_backend(backend)
        if isinstance(admission, AdmissionConfig):
            admission = AdmissionController(admission)
        self.admission: Optional[AdmissionController] = admission
        self.events = EventBus()
        self.live = LiveMetrics(self.events)
        self.handles: Dict[int, RequestHandle] = {}      # rid -> LIVE handles
        # (terminal handles are evicted; callers keep the ones they hold)
        # future arrivals held at the front door when admission is on: the
        # verdict must be taken when the clock *reaches* the arrival, not at
        # submit time — judging a whole replayed trace against the t=0 queue
        # would shed almost everything
        self._held: List[Tuple[float, int, RequestHandle]] = []
        self.backend.attach(_ServiceListener(self))

    # ------------------------------------------------------------- sugar
    @property
    def engine(self) -> EchoEngine:
        """The single engine of an engine backend (first replica's engine
        on a cluster) — convenience for metrics introspection."""
        return self.backend.engines()[0]

    @property
    def now(self) -> float:
        return self.backend.now()

    # ------------------------------------------------------------- intake
    def submit(self, prompt: Sequence[int], *,
               task_type: Union[TaskType, str] = TaskType.ONLINE,
               max_new_tokens: int = 16,
               slo: Optional[SLO] = None,
               arrival_time: Optional[float] = None) -> RequestHandle:
        """Build and submit one request; returns its live handle.
        ``arrival_time`` defaults to the backend's current clock (live
        feeding); pass an explicit time to replay a trace."""
        if isinstance(task_type, str):
            task_type = TaskType(task_type)
        req = Request(prompt=tuple(prompt), max_new_tokens=max_new_tokens,
                      task_type=task_type,
                      arrival_time=(self.backend.now()
                                    if arrival_time is None else arrival_time),
                      slo=slo)
        return self.submit_request(req)

    def submit_request(self, req: Request) -> RequestHandle:
        """Submit a pre-built ``Request`` through admission control. With
        admission on, a request whose ``arrival_time`` lies in the future is
        held at the front door and judged when the clock reaches it."""
        handle = RequestHandle(self, req)
        self.handles[req.rid] = handle
        if self._admission_active() and \
                req.arrival_time > self.backend.now():
            handle._deferred = True
            heapq.heappush(self._held, (req.arrival_time, req.rid, handle))
            return handle
        self._admit(handle)
        return handle

    def _admission_active(self) -> bool:
        return self.admission is not None and self.admission.config.active

    def _admit(self, handle: RequestHandle) -> None:
        """Take the admission verdict now and route accordingly."""
        verdict = (self.admission.verdict(self.backend, handle)
                   if self.admission is not None else ADMIT)
        if verdict == SHED:
            handle._shed = True
            self.events.emit("shed", handle)
            self.handles.pop(handle.rid, None)       # terminal: release
        elif verdict == DEFER:
            handle._deferred = True          # controller holds it; fed later
        else:
            self.backend.submit(handle.request)

    def _release_arrivals(self, force_one: bool = False) -> None:
        """Move held arrivals whose time has come through admission. With
        ``force_one`` the earliest held arrival is released even though the
        clock has not reached it yet — used when the backend is otherwise
        idle, so its own idle-advance can jump to the arrival."""
        now = self.backend.now()
        while self._held and (self._held[0][0] <= now or force_one):
            _, _, handle = heapq.heappop(self._held)
            handle._deferred = False
            self._admit(handle)
            force_one = False

    # ------------------------------------------------------------- control
    def abort(self, handle: RequestHandle) -> bool:
        """Cancel a request mid-flight. Frees its KV blocks
        (``BlockManager.free_request``), drops its radix-pool pins, removes
        it from scheduler queues, and fires ``on_abort``."""
        if handle.done:
            return False
        if not ((handle._deferred and (self._cancel_held(handle)
                                       or (self.admission is not None
                                           and self.admission.cancel(handle))))
                or self.backend.abort(handle.request)):
            return False
        handle._aborted = True
        self.events.emit("abort", handle)
        self.handles.pop(handle.rid, None)           # terminal: release
        return True

    def _cancel_held(self, handle: RequestHandle) -> bool:
        for i, (_, _, h) in enumerate(self._held):
            if h is handle:
                self._held.pop(i)
                heapq.heapify(self._held)
                handle._deferred = False
                return True
        return False

    # ------------------------------------------------------------- driving
    def step(self, until_time: Optional[float] = None) -> bool:
        """Advance the backend by one event (one engine iteration / one
        cluster event), first releasing due held arrivals and feeding
        deferred offline work. Returns False when no further progress is
        possible."""
        if self.admission is not None:
            self._release_arrivals()
            self.admission.pump(self.backend, self.events)
        if self.backend.step(until_time):
            return True
        # backend idle, but future arrivals are still held at the front
        # door: release the earliest so the backend's idle-advance can jump
        # the clock to it. Keep releasing — an arrival may be shed on
        # release (admitting nothing), and later held arrivals must still
        # get their verdict.
        while self._held:
            self._release_arrivals(force_one=True)
            if self.admission is not None:
                self.admission.pump(self.backend, self.events)
            if self.backend.step(until_time):
                return True
        return False

    def run(self, max_iters: Optional[int] = None,
            until_time: Optional[float] = None):
        """Drive until idle (or ``until_time``); returns backend stats."""
        for _ in range(max_iters or self.backend.default_max_iters):
            if not self.step(until_time):
                break
        return self.stats()

    def drive(self, workload: Iterable[Request], *,
              max_iters: Optional[int] = None,
              until_time: Optional[float] = None):
        """Compatibility driver for trace benchmarks: submit a pre-generated
        workload and run it to completion, returning ``EngineStats`` /
        ``ClusterStats`` exactly as the legacy ``submit_all`` + ``run`` path
        did. With no admission gates this delegates to the backend's own
        ``run`` loop, so the numbers are bit-identical; events still flow
        (``service.events``, ``service.live``)."""
        for req in workload:
            self.submit_request(req)
        if self.admission is None or not self.admission.config.active:
            return self.backend.run_legacy(max_iters, until_time)
        return self.run(max_iters, until_time)

    def stats(self):
        return self.backend.stats()

    def pending_frontdoor(self) -> int:
        """Requests held at the front door, not yet visible to the backend:
        future arrivals awaiting their admission verdict plus offline work
        parked in the admission overflow queue. The real-time drain loop
        treats these as outstanding work."""
        n = len(self._held)
        if self.admission is not None:
            n += len(self.admission.deferred)
        return n

    # ------------------------------------------------------------- obs
    def instrument(self, registry=None, tracer=None):
        """Attach the observability layer (``repro_torch.obs``): the bus-level
        metric bridge plus per-engine drift probes into ``registry``
        (created when None), and — given a ``Tracer`` — the lifecycle
        trace tracks. Returns the registry. Imported lazily so the plain
        serving path never loads the obs package."""
        from repro_torch.obs import MetricsRegistry
        from repro_torch.obs.probes import instrument as _instrument
        if registry is None:
            registry = MetricsRegistry()
        _instrument(self, registry, tracer)
        return registry

    # ------------------------------------------------------------- wiring
    def _handle_for(self, req: Request) -> Optional[RequestHandle]:
        return self.handles.get(req.rid)

    def _on_token(self, req: Request, tok: int, t: float) -> None:
        handle = self._handle_for(req)
        if handle is None:
            return                      # foreign request (legacy direct use)
        ev = TokenEvent(handle=handle, token=tok, t=t,
                        index=len(handle.token_events))
        handle.token_events.append(ev)
        self.events.emit("token", ev)
        if ev.first:
            self.events.emit("first_token", ev)

    def _on_preempt(self, req: Request, t: float) -> None:
        handle = self._handle_for(req)
        if handle is not None:
            self.events.emit("preempt", handle)

    def _on_swap_in(self, req: Request, n_tokens: int, t: float) -> None:
        self.events.emit("swap_in", SwapEvent(tokens=n_tokens, t=t,
                                              handle=self._handle_for(req)))

    def _on_swap_out(self, n_tokens: int, t: float) -> None:
        self.events.emit("swap_out", SwapEvent(tokens=n_tokens, t=t))

    def _on_swap_overlap(self, transfer_s: float, exposed_s: float,
                         t: float) -> None:
        self.events.emit("swap_overlap", OverlapEvent(transfer=transfer_s,
                                                      exposed=exposed_s, t=t))

    def _on_finish(self, req: Request, t: float) -> None:
        handle = self._handle_for(req)
        if handle is not None:
            self.events.emit("finish", handle)
            # terminal: drop the service's reference so a long-lived service
            # retains O(live requests), not O(all requests ever). The caller
            # keeps streaming/replaying through the handle it holds.
            self.handles.pop(req.rid, None)
