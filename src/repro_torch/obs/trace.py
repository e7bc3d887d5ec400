"""Request-lifecycle and per-iteration tracing with Chrome-trace export.

``Tracer`` is a bounded ring buffer of trace events exported as Chrome
Trace Event JSON (the ``traceEvents`` array format) — load the file at
https://ui.perfetto.dev or chrome://tracing. The timeline is the engine's
clock (virtual seconds on the simulator paths, wall seconds otherwise)
mapped to microseconds.

Track layout (one Perfetto "process" per replica):

  pid 0..N-1   replica engines
    tid 1      schedule       — scheduler wall time per iteration
    tid 2      kernel         — the compute leg of each iteration
    tid 3      swap copy-stream — PCIe transfer spans + swap-out instants
    tid 16+rid one track per request: queued span, prefill chunk spans,
               decode spans, preempt/swap-in instants, parked spans
  pid 9996     host (wall clock) — ``attach_host``: the engine thread's
               own spans (``step`` and its children, the scheduler's
               phases, the paged runner's calls), stamped with
               ``time.perf_counter_ns`` and drawn from the attach instant
  pid 9997     rt frontdoor   — per-connection wall-clock spans (submit to
               terminal, first-token instant); NOTE this pid's timeline is
               the *serving* clock, the engine pids' is the backend clock
  pid 9998     service        — admission shed/abort instants
  pid 9999     router         — cluster dispatch/steal instants

Bounded overhead: events are stored as tuples in a ``deque(maxlen=cap)``
(oldest events drop first; ``dropped_events`` counts them) and the JSON
dicts are only built at export time. Zero cost when not attached — the
engine skips detail construction entirely when no listener overrides
``on_iteration``; a host-track span site costs one ``is None`` test.
"""
from __future__ import annotations

import json
from collections import deque
from time import perf_counter_ns
from typing import Dict, List, NamedTuple, Optional, Tuple

from repro_torch.core.engine import EngineListener, IterationDetail, IterationRecord
from repro_torch.core.request import Request, RequestState

TID_SCHEDULE = 1
TID_KERNEL = 2
TID_SWAP = 3
TID_REQ_BASE = 16          # request track = TID_REQ_BASE + rid
HOST_PID = 9996
RT_PID = 9997
SERVICE_PID = 9998
ROUTER_PID = 9999


class HostSpan(NamedTuple):
    """One closed span of the host track: ``perf_counter_ns`` stamps, its
    own id, its parent's (0 for a root), the request it served (if any)
    and a few integer args."""
    name: str
    t0: int
    t1: int
    id: int
    parent: int
    rid: Optional[int]
    args: Optional[dict]
    tid: int


class HostTrack:
    """The open spans of one engine thread, a stack: ``open`` pushes,
    ``close`` pops into the tracer's ring, ``switch`` closes the top span
    and opens its next sibling at the same instant. The engine, its
    scheduler and its runner hold one each as ``host_track``, ``None``
    until ``Tracer.attach_host`` sets it, so that a span site costs one
    ``is None`` test: no object is built and no clock is read."""

    def __init__(self, tracer: "Tracer", tid: int):
        self._tr = tracer
        self._tid = tid
        self._stack: List[list] = []        # [name, t0, id, rid, args]
        self._ids = 0

    def open(self, name: str, rid: Optional[int] = None,
             args: Optional[dict] = None, t: Optional[int] = None) -> int:
        """Open ``name`` inside the innermost open span, now or at ``t``.
        Returns the instant."""
        if t is None:
            t = perf_counter_ns()
        self._ids += 1
        self._stack.append([name, t, self._ids, rid, args])
        return t

    def note(self, args: dict) -> None:
        """Add ``args`` to the innermost open span, if one is open."""
        if self._stack:
            top = self._stack[-1]
            top[4] = {**top[4], **args} if top[4] else args

    def close(self, args: Optional[dict] = None, levels: int = 1) -> int:
        """Close the ``levels`` innermost spans at one instant; ``args`` go
        to the last closed. Returns the instant."""
        t1 = perf_counter_ns()
        for i in range(levels):
            name, t0, sid, rid, a = self._stack.pop()
            if args and i == levels - 1:
                a = {**a, **args} if a else args
            parent = self._stack[-1][2] if self._stack else 0
            self._tr._record(("H", name, t0, t1, sid, parent, rid, a,
                              self._tid))
        return t1

    def switch(self, name: str, rid: Optional[int] = None,
               args: Optional[dict] = None) -> None:
        self.open(name, rid, args, self.close())


class Tracer:
    """Ring-buffered span/instant store with Chrome-trace JSON export."""

    def __init__(self, cap: int = 200_000):
        self.cap = cap
        self._events: deque = deque(maxlen=cap)
        self._procs: Dict[int, str] = {}
        self._threads: Dict[Tuple[int, int], str] = {}
        self.n_recorded = 0
        self._engine_tracers: List[_EngineTracer] = []
        self.host_origin_ns: Optional[int] = None

    # ------------------------------------------------------------- recording
    def span(self, pid: int, tid: int, name: str, t0: float, dur: float,
             args: Optional[dict] = None, cat: str = "echo") -> None:
        self.n_recorded += 1
        self._events.append(("X", name, t0, max(dur, 0.0), pid, tid, args,
                             cat))

    def instant(self, pid: int, tid: int, name: str, t: float,
                args: Optional[dict] = None, cat: str = "echo") -> None:
        self.n_recorded += 1
        self._events.append(("i", name, t, 0.0, pid, tid, args, cat))

    def _record(self, span: tuple) -> None:
        """A host span, as ``"H"`` and ``HostSpan``'s fields: the ring holds
        plain tuples, and ``host_spans`` names their fields."""
        self.n_recorded += 1
        self._events.append(span)

    def set_process(self, pid: int, name: str) -> None:
        self._procs.setdefault(pid, name)

    def set_thread(self, pid: int, tid: int, name: str) -> None:
        self._threads.setdefault((pid, tid), name)

    @property
    def dropped_events(self) -> int:
        return self.n_recorded - len(self._events)

    # ------------------------------------------------------------- wiring
    def attach(self, target) -> "Tracer":
        """Attach to an ``EchoService``, a serving backend, or a bare
        ``EchoEngine``: one lifecycle listener per engine (pid = replica
        index), plus router dispatch/steal hooks and admission instants
        when the target exposes them."""
        service = target if hasattr(target, "backend") else None
        backend = service.backend if service is not None else target
        engines = backend.engines() if hasattr(backend, "engines") \
            else [backend]
        for i, eng in enumerate(engines):
            self.attach_engine(eng, pid=i)
        sim = getattr(backend, "sim", None)
        if sim is not None and getattr(sim, "router", None) is not None:
            self._attach_router(sim.router)
        if sim is not None and hasattr(sim, "on_lifecycle"):
            self._attach_lifecycle(sim)
        if service is not None:
            self._attach_service(service)
        return self

    def attach_engine(self, engine, pid: int = 0) -> "_EngineTracer":
        self.set_process(pid, f"replica {pid}")
        self.set_thread(pid, TID_SCHEDULE, "schedule")
        self.set_thread(pid, TID_KERNEL, "kernel")
        self.set_thread(pid, TID_SWAP, "swap copy-stream")
        lt = _EngineTracer(self, pid)
        engine.listeners.append(lt)
        self._engine_tracers.append(lt)
        return lt

    def attach_host(self, engine, replica: int = 0) -> HostTrack:
        """Turn on the host track of one engine: spans of its thread's own
        work on the wall clock (pid ``HOST_PID``, one thread per replica),
        beside the engine-clock tracks ``attach`` draws. The engine, its
        scheduler and a runner that records spans share one stack."""
        if self.host_origin_ns is None:
            self.host_origin_ns = perf_counter_ns()
        self.set_process(HOST_PID, "host (wall clock)")
        self.set_thread(HOST_PID, replica + 1, f"replica {replica} engine thread")
        track = HostTrack(self, replica + 1)
        engine.host_track = engine.scheduler.host_track = track
        if hasattr(engine.runner, "host_track"):
            engine.runner.host_track = track
        return track

    def host_spans(self) -> List[HostSpan]:
        """The host track's spans still in the ring, in the order they
        closed (a child before its parent)."""
        return [HostSpan(*e[1:]) for e in self._events if e[0] == "H"]

    def _attach_router(self, router) -> None:
        self.set_process(ROUTER_PID, "router")
        self.set_thread(ROUTER_PID, 1, "dispatch")
        self.set_thread(ROUTER_PID, 2, "steal")
        if router.on_dispatch is None:
            router.on_dispatch = lambda req, rep_id, t: self.instant(
                ROUTER_PID, 1, f"dispatch r{rep_id}", t,
                {"rid": req.rid, "task": req.task_type.value,
                 "replica": rep_id})
        if router.on_steal is None:
            router.on_steal = lambda req, frm, to, t: self.instant(
                ROUTER_PID, 2, f"steal r{frm}->r{to}", t,
                {"rid": req.rid, "from": frm, "to": to})

    def _attach_lifecycle(self, sim) -> None:
        """Fleet-membership timeline: one instant per replica lifecycle
        transition (JOINING/UP/DEGRADED/DRAINING/DOWN) on the router
        process, plus retroactive instants for transitions that already
        happened. Chains an existing ``on_lifecycle`` tap."""
        self.set_process(ROUTER_PID, "router")
        self.set_thread(ROUTER_PID, 3, "lifecycle")
        for t, rid, state in getattr(sim, "lifecycle_log", []):
            self.instant(ROUTER_PID, 3, f"r{rid} {state}", t,
                         {"replica": rid, "state": state})
        prev = sim.on_lifecycle

        def _tap(rid: int, state: str, t: float, _prev=prev) -> None:
            self.instant(ROUTER_PID, 3, f"r{rid} {state}", t,
                         {"replica": rid, "state": state})
            if _prev is not None:
                _prev(rid, state, t)

        sim.on_lifecycle = _tap

    def _attach_service(self, service) -> None:
        self.set_process(SERVICE_PID, "service")
        self.set_thread(SERVICE_PID, 1, "admission")
        bus = service.events

        def _shed(handle):
            self.instant(SERVICE_PID, 1, "shed", service.backend.now(),
                         {"rid": handle.rid})

        def _abort(handle):
            self.instant(SERVICE_PID, 1, "abort", service.backend.now(),
                         {"rid": handle.rid})

        bus.subscribe("shed", _shed)
        bus.subscribe("abort", _abort)

    # ------------------------------------------------------------- queries
    def preempted_rids(self) -> set:
        return set().union(*(lt.preempted for lt in self._engine_tracers)) \
            if self._engine_tracers else set()

    def swapped_rids(self) -> set:
        return set().union(*(lt.swapped for lt in self._engine_tracers)) \
            if self._engine_tracers else set()

    # ------------------------------------------------------------- export
    def to_dict(self) -> dict:
        events: List[dict] = []
        for pid, name in sorted(self._procs.items()):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": name}})
        for (pid, tid), name in sorted(self._threads.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
            events.append({"ph": "M", "name": "thread_sort_index",
                           "pid": pid, "tid": tid,
                           "args": {"sort_index": tid}})
        for e in self._events:
            if e[0] == "H":
                events.append(self._host_event(HostSpan(*e[1:])))
                continue
            ph, name, t, dur, pid, tid, args, cat = e
            ev = {"ph": ph, "name": name, "ts": t * 1e6, "pid": pid,
                  "tid": tid, "cat": cat}
            if ph == "X":
                ev["dur"] = dur * 1e6
            elif ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            events.append(ev)
        other = {"recorded": self.n_recorded, "dropped": self.dropped_events}
        if self.host_origin_ns is not None:
            other["host_origin_ns"] = self.host_origin_ns
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": other}

    def _host_event(self, e: HostSpan) -> dict:
        args = {"id": e.id, "parent": e.parent}
        if e.rid is not None:
            args["rid"] = e.rid
        if e.args:
            args.update(e.args)
        return {"ph": "X", "name": e.name,
                "ts": (e.t0 - self.host_origin_ns) / 1e3,
                "dur": (e.t1 - e.t0) / 1e3, "pid": HOST_PID, "tid": e.tid,
                "cat": "host", "args": args}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)


class _EngineTracer(EngineListener):
    """Per-engine lifecycle listener feeding one replica's tracks.

    Request phases are tracked as a tiny state machine (rid -> (phase, t0))
    so each request costs O(transitions) events, not O(tokens): a queued
    span from arrival to admission, per-iteration prefill chunk spans, one
    decode span per contiguous decode residency, and parked spans between
    preemption and re-admission."""

    def __init__(self, tracer: Tracer, pid: int):
        self.tr = tracer
        self.pid = pid
        self._phase: Dict[int, Tuple[str, float]] = {}
        self._named: set = set()
        self.preempted: set = set()
        self.swapped: set = set()

    # ------------------------------------------------------------- helpers
    def _req_tid(self, req: Request) -> int:
        tid = TID_REQ_BASE + req.rid
        if req.rid not in self._named:
            self._named.add(req.rid)
            self.tr.set_thread(self.pid, tid,
                               f"req {req.rid} ({req.task_type.value})")
        return tid

    def _close_phase(self, req: Request, t: float) -> None:
        entry = self._phase.pop(req.rid, None)
        if entry is None:
            return
        phase, t0 = entry
        if t > t0:
            self.tr.span(self.pid, self._req_tid(req), phase, t0, t - t0)

    # ------------------------------------------------------------- hooks
    def on_iteration(self, rec: IterationRecord,
                     detail: IterationDetail) -> None:
        tr, pid = self.tr, self.pid
        t0, t1 = detail.t_start, detail.t_end
        if detail.schedule_wall > 0:
            tr.span(pid, TID_SCHEDULE, "schedule", t0, detail.schedule_wall,
                    {"n_prefill": rec.n_prefill, "n_decode": rec.n_decode})
        rel = (detail.predicted_time - rec.iter_time) \
            / max(rec.iter_time, 1e-12)
        tr.span(pid, TID_KERNEL, "exec", t0, detail.compute_time,
                {"iter_time": rec.iter_time,
                 "predicted": detail.predicted_time,
                 "rel_err": rel,
                 "online_tokens": rec.online_tokens,
                 "offline_tokens": rec.offline_tokens})
        if rec.swap_transfer_time > 0:
            tr.span(pid, TID_SWAP, "swap copy", t0, rec.swap_transfer_time,
                    {"exposed": rec.swap_exposed_time,
                     "in_tokens": rec.swap_in_tokens,
                     "out_tokens": rec.swap_out_tokens})
        for req in detail.admitted:
            entry = self._phase.get(req.rid)
            if entry is None:          # fresh: queued since arrival
                if t0 > req.arrival_time:
                    self.tr.span(pid, self._req_tid(req), "queued",
                                 req.arrival_time, t0 - req.arrival_time)
            else:                      # parked (or re-queued): close it
                self._close_phase(req, t0)
        for req, start, end in detail.prefill_spans:
            tr.span(pid, self._req_tid(req), f"prefill [{start}:{end}]",
                    t0, t1 - t0, {"chunk": end - start})
        for req in detail.decodes:
            if req.state in (RequestState.FINISHED, RequestState.ABORTED):
                continue               # on_finish already closed the span
            if self._phase.get(req.rid, ("", 0.0))[0] != "decode":
                self._phase[req.rid] = ("decode", t0)

    def on_preempt(self, req: Request, t: float) -> None:
        self._close_phase(req, t)
        self.preempted.add(req.rid)
        self.tr.instant(self.pid, self._req_tid(req), "preempt", t,
                        {"n_preemptions": req.n_preemptions})
        self._phase[req.rid] = ("parked", t)

    def on_finish(self, req: Request, t: float) -> None:
        self._close_phase(req, t)
        self.tr.instant(self.pid, self._req_tid(req), "finish", t,
                        {"n_output": req.n_output,
                         "ttft": req.ttft(), "tpot": req.tpot()})

    def on_swap_in(self, req: Request, n_tokens: int, t: float) -> None:
        self.swapped.add(req.rid)
        self.tr.instant(self.pid, self._req_tid(req), "swap-in", t,
                        {"tokens": n_tokens})

    def on_swap_out(self, n_tokens: int, t: float) -> None:
        self.tr.instant(self.pid, TID_SWAP, "swap-out", t,
                        {"tokens": n_tokens})
