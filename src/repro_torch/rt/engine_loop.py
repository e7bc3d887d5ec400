"""AsyncEchoEngine: the real-time continuous-batching front door.

This is the production serving path: the same
``EchoService``/``EngineBackend`` stack the trace benchmarks drive, but
run by a live asyncio loop instead of a replay driver. One background
task owns the backend:

  * ``engine.step`` runs off-thread (``asyncio.to_thread``) so thousands
    of connections keep streaming while an iteration computes — the vLLM
    ``LLMEngine``-wrapper idiom;
  * arrivals are stamped with *real* times at the front door, so
    ``AdmissionController`` verdicts (bounded queue, SLO-feasibility
    shed) judge live load, not trace timestamps;
  * token/finish/abort/shed events emitted by the step (on the worker
    thread, serialized by the ``EventBus`` lock) are queued and dispatched
    to per-request ``asyncio.Queue``s on the loop thread — tokens stream
    to ``AsyncRequestHandle`` consumers as they land;
  * backpressure is explicit at both ends: a bounded submit queue
    (saturation sheds — or blocks, the caller's choice) and a per-request
    token-queue cap that aborts slow consumers instead of buffering
    unboundedly;
  * ``drain()`` is the graceful shutdown: stop admitting, finish (or,
    past a deadline, shed) in-flight work, flush the swap stager, land
    every in-flight KV transfer, stop.

The wall clock and the backend clock meet here for the first time: the
scheduler's ``TimeModel`` estimates gate the admission of live requests,
so estimator fidelity becomes a user-visible SLO property. With a
``ManualClock`` the serving domain is paused and the loop replays traces
bit-identically to ``EchoService.drive`` (the equivalence tests).

On the card three threads touch CUDA: the loop thread (it submits,
aborts, dispatches and flushes, and launches no kernel), the
default-executor thread that runs a hop's
``engine.step`` (not always the same one from hop to hop) and the
engine's ``kv-stage`` worker, which copies blocks between host and device
meanwhile. The kernels launch on ``torch.cuda.current_stream()``, which
PyTorch keeps per thread; every thread here uses the device's default
stream, so a step's launches and the stager's copies are ordered as the
engine's fences expect. This holds only while no code sets another
stream on one thread and expects it on another: keep it so. A CUDA error
raised by a step reaches the loop as the ``to_thread`` call's exception;
``_run``'s ``finally`` only flushes and dispatches, so it propagates to
whoever awaits ``drain()``.
"""
from __future__ import annotations

import asyncio
import enum
import logging
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Union

from repro_torch.core.request import Request, TaskType
from repro_torch.serving.handle import HandleStatus
from repro_torch.serving.service import EchoService
from repro_torch.rt.clock import ManualClock, WallClock
from repro_torch.rt.handle import AsyncRequestHandle, SubmitQueueFull

logger = logging.getLogger(__name__)


class RTState(enum.Enum):
    CREATED = "created"
    RUNNING = "running"
    DRAINING = "draining"
    STOPPED = "stopped"


@dataclass
class RTStats:
    """Front-door accounting, disjoint from the backend's EngineStats."""
    submitted: int = 0
    finished: int = 0
    aborted: int = 0
    shed: int = 0                      # all terminal SHED handles
    shed_submit_queue: int = 0         # bounded submit queue saturated
    shed_closed: int = 0               # submitted while draining/stopped
    slow_consumer_aborts: int = 0      # token-queue cap hit
    drain_sheds: int = 0               # in-flight work shed at drain
    preemptions: int = 0
    steps: int = 0                     # backend iterations driven
    hops: int = 0                      # to_thread round trips
    peak_live: int = 0


class AsyncEchoEngine:
    """Asyncio front door over an ``EchoService`` (or anything
    ``make_backend`` accepts: ``EchoEngine``, ``ClusterSimulator``).

    Lifecycle::

        rt = AsyncEchoEngine(engine, admission=AdmissionConfig(...))
        async with rt:                       # start() ... drain()
            h = await rt.submit(prompt, task_type="online",
                                max_new_tokens=16, slo=SLO(1.0, 0.1))
            async for ev in h.tokens():
                ...
            await h.abort()                  # or cancel mid-stream

    ``steps_per_hop`` batches backend iterations per worker-thread round
    trip (throughput knob; 1 = lowest streaming latency). ``pace=True``
    throttles the loop so the backend's virtual clock never runs ahead of
    the wall clock — a real-time simulation of the modeled hardware.
    """

    def __init__(self, backend, *,
                 admission=None,
                 clock: Optional[Union[WallClock, ManualClock]] = None,
                 max_submit_queue: int = 4096,
                 token_queue_cap: int = 1024,
                 steps_per_hop: int = 1,
                 pace: bool = False):
        self.service = (backend if isinstance(backend, EchoService)
                        else EchoService(backend, admission=admission))
        self.clock = clock if clock is not None else WallClock()
        self.token_queue_cap = token_queue_cap
        self.steps_per_hop = max(steps_per_hop, 1)
        self.pace = pace
        self.stats = RTStats()
        self._state = RTState.CREATED
        self._task: Optional[asyncio.Task] = None
        self._intake: asyncio.Queue = asyncio.Queue(maxsize=max_submit_queue)
        self._wake = asyncio.Event()
        self._live: Dict[int, AsyncRequestHandle] = {}
        self._control: Deque = deque()     # ("abort", handle, future|None)
        self._events: Deque = deque()      # bus events awaiting dispatch
        self._shed_requested = False
        self._last_arrival = 0.0           # monotone live-arrival stamps
        self._done_cbs: List[Callable[[AsyncRequestHandle], None]] = []
        bus = self.service.events
        # bridge: bus callbacks fire on whichever thread emitted (the step
        # worker, mostly); they only append — the loop thread dispatches
        bus.on_token(lambda ev: self._events.append(("token", ev)))
        bus.on_finish(lambda h: self._events.append(("finish", h)))
        bus.on_abort(lambda h: self._events.append(("abort", h)))
        bus.on_shed(lambda h: self._events.append(("shed", h)))
        bus.on_preempt(lambda h: self._events.append(("preempt", h)))

    # ------------------------------------------------------------- sugar
    @property
    def state(self) -> RTState:
        return self._state

    @property
    def engine(self):
        return self.service.engine

    @property
    def live(self):
        """The service's event-driven LiveMetrics (backend-clock domain)."""
        return self.service.live

    @property
    def events(self):
        return self.service.events

    def live_requests(self) -> int:
        """Handles between submit and terminal (intake queue included)."""
        return len(self._live) + self._intake.qsize()

    def on_request_done(self, cb: Callable[[AsyncRequestHandle], None]):
        """Register a loop-thread callback fired at every handle's terminal
        transition (the RTProbe's hook for wall-clock histograms/spans)."""
        self._done_cbs.append(cb)
        return cb

    # ------------------------------------------------------------- intake
    async def submit(self, prompt: Sequence[int], *,
                     task_type: Union[TaskType, str] = TaskType.ONLINE,
                     max_new_tokens: int = 16,
                     slo=None,
                     arrival_time: Optional[float] = None,
                     wait: bool = True) -> AsyncRequestHandle:
        """Build and submit one request; returns its async handle.

        ``arrival_time`` defaults to live stamping: the request arrives
        "now" in the backend's clock domain when the loop picks it up (the
        wall-clock admission path). Pass an explicit time to replay a
        trace. With ``wait`` the call backpressures (awaits a submit-queue
        slot); without it a saturated queue sheds immediately."""
        if isinstance(task_type, str):
            task_type = TaskType(task_type)
        req = Request(prompt=tuple(prompt), max_new_tokens=max_new_tokens,
                      task_type=task_type,
                      arrival_time=(0.0 if arrival_time is None
                                    else arrival_time),
                      slo=slo)
        return await self.submit_request(
            req, live_arrival=arrival_time is None, wait=wait)

    async def submit_request(self, req: Request, *,
                             live_arrival: bool = False,
                             wait: bool = True) -> AsyncRequestHandle:
        """Submit a pre-built ``Request`` (trace replay keeps its
        ``arrival_time``; ``live_arrival`` stamps it at intake)."""
        handle = AsyncRequestHandle(self, req,
                                    token_queue_cap=self.token_queue_cap,
                                    live_arrival=live_arrival)
        self.stats.submitted += 1
        if self._state in (RTState.DRAINING, RTState.STOPPED):
            self.stats.shed_closed += 1
            self._finalize_handle(handle, HandleStatus.SHED)
            return handle
        if wait:
            await self._intake.put(handle)
        else:
            try:
                self._intake.put_nowait(handle)
            except asyncio.QueueFull:
                self.stats.shed_submit_queue += 1
                self._finalize_handle(handle, HandleStatus.SHED)
                return handle
        self.stats.peak_live = max(self.stats.peak_live,
                                   self.live_requests())
        self._wake.set()
        return handle

    def try_submit_nowait(self, req: Request, *,
                          live_arrival: bool = True) -> AsyncRequestHandle:
        """Synchronous non-blocking submit for callers already on the loop
        thread; raises ``SubmitQueueFull`` when saturated."""
        handle = AsyncRequestHandle(self, req,
                                    token_queue_cap=self.token_queue_cap,
                                    live_arrival=live_arrival)
        self.stats.submitted += 1
        if self._state in (RTState.DRAINING, RTState.STOPPED):
            self.stats.shed_closed += 1
            self._finalize_handle(handle, HandleStatus.SHED)
            return handle
        try:
            self._intake.put_nowait(handle)
        except asyncio.QueueFull:
            self.stats.shed_submit_queue += 1
            raise SubmitQueueFull(
                f"submit queue full ({self._intake.maxsize})") from None
        self._wake.set()
        return handle

    # ------------------------------------------------------------- control
    async def _abort(self, handle: AsyncRequestHandle) -> bool:
        if handle.done:
            return False
        fut = asyncio.get_running_loop().create_future()
        self._control.append(("abort", handle, fut))
        self._wake.set()
        if self._task is None:          # loop not running: resolve inline
            self._process_control()
            self._dispatch()
        return await fut

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> "AsyncEchoEngine":
        if self._task is not None:
            raise RuntimeError("AsyncEchoEngine already started")
        self._state = RTState.RUNNING
        self._task = asyncio.create_task(self._run(), name="echo-rt-loop")
        return self

    async def drain(self, *, shed_after: Optional[float] = None) -> None:
        """Graceful shutdown: stop admitting (new submits are shed), let
        in-flight work finish, flush the swap stager, stop the loop. With
        ``shed_after`` (wall seconds) still-unfinished work is shed once
        the deadline passes instead of waiting forever."""
        if self._task is None:
            self._state = RTState.STOPPED
            return
        if self._state is RTState.RUNNING:
            self._state = RTState.DRAINING
        self._wake.set()
        if shed_after is not None:
            done, _ = await asyncio.wait({self._task}, timeout=shed_after)
            if not done:
                self._shed_requested = True
                self._wake.set()
        await self._task

    async def stop(self) -> None:
        """Hard stop: shed/abort all in-flight work, then drain."""
        self._shed_requested = True
        await self.drain()

    async def __aenter__(self) -> "AsyncEchoEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.drain()

    # ------------------------------------------------------------- loop
    async def _run(self) -> None:
        try:
            while True:
                self._drain_intake()
                self._process_control()
                self._dispatch()
                if self._shed_requested:
                    self._shed_requested = False
                    self._shed_live()
                    self._dispatch()
                if self._state is RTState.DRAINING and self._drained():
                    break
                progressed = False
                if self._backend_busy():
                    progressed = await asyncio.to_thread(self._step_hop)
                    self.stats.hops += 1
                    self._dispatch()
                if progressed:
                    if self.pace:
                        lag = self.service.now - self.clock.now()
                        if lag > 1e-4:
                            await asyncio.sleep(min(lag, 0.25))
                    continue
                if self._state is RTState.DRAINING:
                    if self._drained():
                        break
                    if self._intake.empty() and not self._control:
                        if self._live:
                            # backend can make no more progress but live
                            # requests remain (unschedulable backlog):
                            # shed them so drain terminates
                            self._shed_live()
                            self._dispatch()
                        else:
                            logger.warning(
                                "drain: backend still busy with foreign "
                                "work and no live handles; stopping")
                            break
                    continue
                # idle: sleep until a submit / abort / drain wakes us
                self._wake.clear()
                if (self._intake.empty() and not self._control
                        and not self._events
                        and self._state is RTState.RUNNING
                        and not self._backend_busy()):
                    await self._wake.wait()
        finally:
            backend = self.service.backend
            if hasattr(backend, "flush"):
                backend.flush()        # land in-flight swap staging
            self._dispatch()
            self._state = RTState.STOPPED

    # ------------------------------------------------- loop-thread internals
    def _drain_intake(self) -> None:
        while True:
            try:
                handle = self._intake.get_nowait()
            except asyncio.QueueEmpty:
                return
            if handle.done:             # cancelled while still queued
                continue
            req = handle.request
            if handle.live_arrival:
                # wall-clock admission: the request arrives *now* in the
                # backend's clock domain — the verdict judges live load
                self._last_arrival = max(self.service.now,
                                         self._last_arrival)
                req.arrival_time = self._last_arrival
            # register before submitting: a synchronous shed verdict emits
            # through the bus and must find the handle at dispatch
            self._live[req.rid] = handle
            self.stats.peak_live = max(self.stats.peak_live,
                                       self.live_requests())
            handle._sync = self.service.submit_request(req)

    def _process_control(self) -> None:
        while self._control:
            _, handle, fut = self._control.popleft()
            ok = False
            if not handle.done:
                if handle._sync is None:
                    # never drained from intake: terminal right here
                    handle._cancelled = True
                    self._finalize_handle(handle, HandleStatus.ABORTED)
                    ok = True
                else:
                    ok = self.service.abort(handle._sync)
            if fut is not None and not fut.done():
                fut.set_result(ok)

    def _step_hop(self) -> bool:
        """Worker thread: up to ``steps_per_hop`` backend events."""
        progressed = False
        for _ in range(self.steps_per_hop):
            if not self.service.step():
                break
            progressed = True
            self.stats.steps += 1
        return progressed

    def _dispatch(self) -> None:
        now_wall = self.clock.now()
        while self._events:
            kind, payload = self._events.popleft()
            if kind == "token":
                handle = self._live.get(payload.handle.rid)
                if handle is None:
                    continue            # foreign request or already closed
                if not handle._push_token(payload.token, payload.index,
                                          payload.t, now_wall):
                    # slow consumer: the bounded token queue is full —
                    # abort instead of buffering unboundedly
                    self.stats.slow_consumer_aborts += 1
                    self._control.append(("abort", handle, None))
                    self._wake.set()
            elif kind == "preempt":
                self.stats.preemptions += 1
            else:                       # finish / abort / shed
                handle = self._live.get(payload.rid)
                if handle is None:
                    continue
                status = {"finish": HandleStatus.FINISHED,
                          "abort": HandleStatus.ABORTED,
                          "shed": HandleStatus.SHED}[kind]
                self._finalize_handle(handle, status)

    def _finalize_handle(self, handle: AsyncRequestHandle,
                         status: HandleStatus) -> None:
        if handle._closed is not None:
            return
        self._live.pop(handle.rid, None)
        handle._finalize(status, self.clock.now())
        if status is HandleStatus.FINISHED:
            self.stats.finished += 1
        elif status is HandleStatus.ABORTED:
            self.stats.aborted += 1
        elif status is HandleStatus.SHED:
            self.stats.shed += 1
        for cb in self._done_cbs:
            try:
                cb(handle)
            except Exception:
                logger.warning("on_request_done callback %r raised", cb,
                               exc_info=True)

    def _shed_live(self) -> None:
        for handle in list(self._live.values()):
            if handle.done:
                continue
            if handle._sync is not None:
                if self.service.abort(handle._sync):
                    self.stats.drain_sheds += 1
            else:
                handle._cancelled = True
                self._finalize_handle(handle, HandleStatus.ABORTED)
                self.stats.drain_sheds += 1

    def _backend_busy(self) -> bool:
        return (self.service.backend.has_work()
                or self.service.pending_frontdoor() > 0)

    def _drained(self) -> bool:
        return (self._intake.empty() and not self._control
                and not self._events and not self._live
                and not self._backend_busy())

    # ------------------------------------------------------------- checks
    def kv_leaks(self) -> Dict[str, int]:
        """Post-drain invariant probe: everything here must be zero after a
        graceful drain — request-owned device blocks, outstanding
        unfinished-owner pins on either tier, in-flight stager transfers,
        scheduler running entries, and live handles."""
        leaks = {"request_owned_blocks": 0, "device_owner_pins": 0,
                 "host_owner_pins": 0, "inflight_transfers": 0,
                 "scheduler_running": 0,
                 "live_handles": len(self._live) + self._intake.qsize()}
        for eng in self.service.backend.engines():
            leaks["request_owned_blocks"] += eng.bm.running_blocks
            leaks["device_owner_pins"] += sum(
                b.unfinished_owners for b in eng.bm.blocks)
            if eng.bm.host is not None:
                leaks["host_owner_pins"] += sum(
                    hb.unfinished_owners
                    for hb in eng.bm.host.blocks.values())
            if eng._stager is not None:
                leaks["inflight_transfers"] += eng._stager.inflight_blocks()
            leaks["scheduler_running"] += len(eng.scheduler.running)
        return leaks

    # ------------------------------------------------------------- obs
    def instrument(self, registry=None, tracer=None):
        """Attach the observability layer: the service-level bridge plus
        the RT probe's wall-clock TTFT/TPOT histograms and per-connection
        tracer spans. Returns the registry."""
        from repro_torch.obs import MetricsRegistry
        from repro_torch.obs.probes import instrument_rt
        if registry is None:
            registry = MetricsRegistry()
        self.service.instrument(registry, tracer)
        instrument_rt(self, registry, tracer)
        return registry


# re-exported for convenience alongside the engine
__all__ = ["AsyncEchoEngine", "RTState", "RTStats"]
