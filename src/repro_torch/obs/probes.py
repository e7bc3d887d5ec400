"""Metric probes: the EventBus-to-registry bridge and the estimator-drift
probes fed by the engine's per-iteration hook.

``ServiceMetrics`` subscribes the serving bus and mirrors the lifecycle
stream into labeled counters and latency histograms. ``EngineProbe`` is an
``EngineListener`` that records per-iteration timings, predicted-vs-clock
residuals (scheduler plan estimate and — via the calibrator's
``on_residual`` tap — the pre-refit Eq.6-8 residual per sample),
MemoryPredictor-vs-actual online-KV occupancy, and block-pool fill.

Import discipline: this module must NOT import ``repro_torch.serving`` at module
level — ``repro_torch.serving.events`` itself imports ``repro_torch.obs.metrics``, which
executes the ``repro_torch.obs`` package init. The bus is duck-typed
(``subscribe(event, cb)``) instead.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.engine import (EchoEngine, EngineListener, IterationDetail,
                               IterationRecord)
from repro_torch.obs.metrics import (BYTES_BUCKETS, FRACTION_BUCKETS, ITER_BUCKETS,
                               LATENCY_BUCKETS, REL_ERR_BUCKETS,
                               MetricsRegistry)


class ServiceMetrics:
    """Bus-level lifecycle metrics. All label children are resolved once at
    construction; the per-event handlers touch only cached handles."""

    def __init__(self, bus, registry: MetricsRegistry):
        self.registry = registry
        r = registry
        tokens = r.counter("tokens_total", "generated tokens", ("task",))
        self._tok_online = tokens.labels("online")
        self._tok_offline = tokens.labels("offline")
        finished = r.counter("requests_finished_total", "finished requests",
                             ("task",))
        self._fin_online = finished.labels("online")
        self._fin_offline = finished.labels("offline")
        events = r.counter("lifecycle_events_total",
                           "preempt/abort/shed/requeue events", ("kind",))
        self._preempt = events.labels("preempt")
        self._abort = events.labels("abort")
        self._shed = events.labels("shed")
        self._requeue = events.labels("requeue")
        swap_tok = r.counter("swap_tokens_total",
                             "KV tokens moved across the host tier",
                             ("direction",))
        self._swap_in = swap_tok.labels("in")
        self._swap_out = swap_tok.labels("out")
        swap_s = r.counter("swap_seconds_total",
                           "PCIe copy-stream seconds (transfer) and the "
                           "tail not hidden under compute (exposed)",
                           ("kind",))
        self._transfer_s = swap_s.labels("transfer")
        self._exposed_s = swap_s.labels("exposed")
        self.ttft = r.histogram("ttft_seconds", "time to first token",
                                buckets=LATENCY_BUCKETS)
        self.tpot = r.histogram("tpot_seconds", "time per output token",
                                buckets=LATENCY_BUCKETS)
        self.queue_delay = r.histogram(
            "queue_delay_seconds", "arrival to first batch admission",
            buckets=LATENCY_BUCKETS)
        bus.subscribe("token", self._on_token)
        bus.subscribe("finish", self._on_finish)
        bus.subscribe("preempt", lambda h: self._preempt.inc())
        bus.subscribe("abort", lambda h: self._abort.inc())
        bus.subscribe("shed", lambda h: self._shed.inc())
        bus.subscribe("requeue", lambda h: self._requeue.inc())
        bus.subscribe("swap_in", self._on_swap_in)
        bus.subscribe("swap_out", self._on_swap_out)
        bus.subscribe("swap_overlap", self._on_swap_overlap)

    # ------------------------------------------------------------- handlers
    def _on_token(self, ev) -> None:
        if ev.handle.request.is_online:
            self._tok_online.inc()
        else:
            self._tok_offline.inc()

    def _on_finish(self, handle) -> None:
        req = handle.request
        qd = req.queue_delay()
        if qd is not None:
            self.queue_delay.observe(qd)
        if req.is_online:
            self._fin_online.inc()
            ttft, tpot = req.ttft(), req.tpot()
            if ttft is not None:
                self.ttft.observe(ttft)
            if tpot is not None:
                self.tpot.observe(tpot)
        else:
            self._fin_offline.inc()

    def _on_swap_in(self, ev) -> None:
        self._swap_in.inc(ev.tokens)

    def _on_swap_out(self, ev) -> None:
        self._swap_out.inc(ev.tokens)

    def _on_swap_overlap(self, ev) -> None:
        self._transfer_s.inc(ev.transfer)
        self._exposed_s.inc(ev.exposed)


class EngineProbe(EngineListener):
    """Per-engine drift probes (one instance per replica, ``replica`` label).

    Everything is recorded from ``on_iteration`` so the plain serving path
    (no probe attached) never builds an ``IterationDetail``. The calibrator
    residual tap is chained, not replaced — an already-installed callback
    keeps firing."""

    def __init__(self, engine: EchoEngine, registry: MetricsRegistry, *,
                 replica: int = 0):
        self.engine = engine
        rep = str(replica)
        r = registry
        self._iter = r.histogram(
            "iteration_seconds", "engine iteration time", ("replica",),
            buckets=ITER_BUCKETS).labels(rep)
        self._sched = r.histogram(
            "schedule_seconds", "scheduler wall time per iteration",
            ("replica",), buckets=ITER_BUCKETS).labels(rep)
        self._plan_err = r.histogram(
            "plan_rel_err", "relative error of the plan's scored estimate "
            "vs the observed iteration time", ("replica",),
            buckets=REL_ERR_BUCKETS).labels(rep)
        self._plan_bias = r.gauge(
            "plan_bias", "signed (predicted-observed)/observed of the last "
            "iteration", ("replica",)).labels(rep)
        est_err = r.histogram(
            "estimator_rel_err", "pre-refit Eq.6-8 relative error per "
            "calibrator sample", ("replica", "kind"), buckets=REL_ERR_BUCKETS)
        self._cal_iter = est_err.labels(rep, "iter")
        self._cal_swap = est_err.labels(rep, "swap")
        self._cal_migrate = est_err.labels(rep, "migrate")
        ewma = r.gauge("calibrator_ewma_rel_err",
                       "calibrator EWMA relative error", ("replica", "kind"))
        self._ewma_iter = ewma.labels(rep, "iter")
        self._ewma_swap = ewma.labels(rep, "swap")
        self._ewma_migrate = ewma.labels(rep, "migrate")
        refits = r.gauge("calibrator_refits",
                         "cumulative calibrator refits", ("replica", "kind"))
        self._refits_iter = refits.labels(rep, "iter")
        self._refits_swap = refits.labels(rep, "swap")
        self._refits_migrate = refits.labels(rep, "migrate")
        self._mem_pred = r.gauge(
            "predicted_online_kv_tokens", "MemoryPredictor mu+k*sigma online "
            "KV demand", ("replica",)).labels(rep)
        self._mem_actual = r.gauge(
            "online_kv_tokens", "online KV tokens resident",
            ("replica",)).labels(rep)
        self._mem_err = r.histogram(
            "mem_pred_rel_err", "|predicted-actual|/actual online KV "
            "occupancy", ("replica",), buckets=REL_ERR_BUCKETS).labels(rep)
        self._kv = {
            k: r.gauge("kv_blocks", "block-pool occupancy by state",
                       ("replica", "state")).labels(rep, k)
            for k in ("free", "running", "cached", "threshold",
                      "host_used", "host_capacity")}
        # family-labeled link traffic: the same iteration record reads as
        # per-token KV pages on a paged engine and as fixed-size snapshots
        # on a state-family one — the byte histograms keep them comparable
        fam = engine.bm.io.family
        swap_bytes = r.histogram(
            "swap_bytes", "per-iteration PCIe payload over the host tier",
            ("replica", "family", "direction"), buckets=BYTES_BUCKETS)
        self._swap_in_bytes = swap_bytes.labels(rep, fam, "in")
        self._swap_out_bytes = swap_bytes.labels(rep, fam, "out")
        self._swap_bytes_total = r.counter(
            "swap_bytes_total", "cumulative PCIe bytes over the host tier",
            ("replica", "family", "direction"))
        self._swap_in_bytes_c = self._swap_bytes_total.labels(rep, fam, "in")
        self._swap_out_bytes_c = self._swap_bytes_total.labels(rep, fam,
                                                               "out")
        # cross-replica KV migration: fabric payload this replica imported
        # (blocks shipped from a drained / stolen-from peer's tiers)
        self._migrate_in_bytes = r.histogram(
            "migrate_bytes", "per-iteration inter-replica KV migration "
            "payload landed in the host tier", ("replica", "family"),
            buckets=BYTES_BUCKETS).labels(rep, fam)
        self._migrate_in_bytes_c = r.counter(
            "migrate_bytes_total", "cumulative inter-replica KV migration "
            "bytes imported", ("replica", "family")).labels(rep, fam)
        self._swap_exposed = r.histogram(
            "swap_exposed_seconds", "per-iteration swap tail not hidden "
            "under compute", ("replica",), buckets=ITER_BUCKETS).labels(rep)
        self._swap_hidden = r.histogram(
            "swap_hidden_frac", "per-iteration fraction of swap traffic "
            "hidden under compute", ("replica",),
            buckets=FRACTION_BUCKETS).labels(rep)
        cal = engine.calibrator
        if cal is not None:
            prev = cal.on_residual

            def _tap(kind: str, rel: float, _prev=prev) -> None:
                h = {"iter": self._cal_iter, "swap": self._cal_swap,
                     "migrate": self._cal_migrate}.get(kind)
                if h is not None:
                    h.observe(rel)
                if _prev is not None:
                    _prev(kind, rel)

            cal.on_residual = _tap

    # ------------------------------------------------------------- hook
    def on_iteration(self, rec: IterationRecord,
                     detail: IterationDetail) -> None:
        self._iter.observe(rec.iter_time)
        if detail.schedule_wall > 0:
            self._sched.observe(detail.schedule_wall)
        if rec.iter_time > 0:
            err = (detail.predicted_time - rec.iter_time) / rec.iter_time
            self._plan_err.observe(abs(err))
            self._plan_bias.set(err)
        predicted = self.engine.mem_pred.predict()
        actual = self.engine._online_kv_tokens()
        self._mem_pred.set(predicted)
        self._mem_actual.set(actual)
        if actual > 0:
            self._mem_err.observe(abs(predicted - actual) / actual)
        snap = self.engine.bm.occupancy_snapshot()
        for k, g in self._kv.items():
            g.set(snap[k])
        cal = self.engine.calibrator
        if cal is not None:
            if cal.ewma_err is not None:
                self._ewma_iter.set(cal.ewma_err)
            if cal.ewma_swap_err is not None:
                self._ewma_swap.set(cal.ewma_swap_err)
            if cal.ewma_migrate_err is not None:
                self._ewma_migrate.set(cal.ewma_migrate_err)
            self._refits_iter.set(cal.refits)
            self._refits_swap.set(cal.swap_refits)
            self._refits_migrate.set(cal.migrate_refits)
        if rec.migrate_in_bytes > 0:
            self._migrate_in_bytes.observe(rec.migrate_in_bytes)
            self._migrate_in_bytes_c.inc(rec.migrate_in_bytes)
        if rec.swap_in_bytes > 0:
            self._swap_in_bytes.observe(rec.swap_in_bytes)
            self._swap_in_bytes_c.inc(rec.swap_in_bytes)
        if rec.swap_out_bytes > 0:
            self._swap_out_bytes.observe(rec.swap_out_bytes)
            self._swap_out_bytes_c.inc(rec.swap_out_bytes)
        if rec.swap_transfer_time > 0:
            self._swap_exposed.observe(rec.swap_exposed_time)
            self._swap_hidden.observe(
                max(1.0 - rec.swap_exposed_time / rec.swap_transfer_time,
                    0.0))


class RTProbe:
    """Wall-clock serving metrics for the real-time front door.

    Everything the engine-side probes record lives in the backend's clock
    domain; this probe records what a *client* experiences — wall seconds
    from submit to first token (``rt_ttft_wall_seconds``) and per token
    after it — via ``AsyncEchoEngine.on_request_done``, which fires on the
    event-loop thread at every handle's terminal transition. With a tracer
    it draws one span per connection at ``RT_PID`` (serving-clock
    timeline): submit-to-terminal, first-token instant inside it.

    Duck-typed against the engine (``on_request_done``/``stats``/
    ``live_requests``) for the same import-discipline reason as the bus:
    ``repro_torch.rt`` imports ``repro_torch.serving`` which imports this package.
    """

    def __init__(self, rt, registry: MetricsRegistry, tracer=None):
        self.rt = rt
        self.tracer = tracer
        r = registry
        self.ttft_wall = r.histogram(
            "rt_ttft_wall_seconds", "serving-clock time to first token",
            buckets=LATENCY_BUCKETS)
        self.tpot_wall = r.histogram(
            "rt_tpot_wall_seconds", "serving-clock time per output token",
            buckets=LATENCY_BUCKETS)
        self.latency_wall = r.histogram(
            "rt_request_wall_seconds", "serving-clock submit-to-terminal "
            "latency", buckets=LATENCY_BUCKETS)
        done = r.counter("rt_requests_total",
                         "terminal real-time requests", ("status",))
        self._done = {s: done.labels(s)
                      for s in ("finished", "aborted", "shed")}
        self._live = r.gauge("rt_live_requests",
                             "handles between submit and terminal")
        self._slow = r.gauge("rt_slow_consumer_aborts",
                             "token-queue-cap aborts so far")
        if tracer is not None:
            from repro_torch.obs.trace import RT_PID
            self._rt_pid = RT_PID
            tracer.set_process(RT_PID, "rt frontdoor")
        rt.on_request_done(self._on_done)

    def _on_done(self, handle) -> None:
        status = handle.status.value
        self._done.get(status, self._done["aborted"]).inc()
        lat = handle.wall_latency()
        if lat is not None:
            self.latency_wall.observe(lat)
        ttft, tpot = handle.wall_ttft(), handle.wall_tpot()
        if ttft is not None:
            self.ttft_wall.observe(ttft)
        if tpot is not None:
            self.tpot_wall.observe(tpot)
        self._live.set(self.rt.live_requests())
        self._slow.set(self.rt.stats.slow_consumer_aborts)
        if self.tracer is not None:
            from repro_torch.obs.trace import TID_REQ_BASE
            tid = TID_REQ_BASE + handle.rid
            self.tracer.set_thread(self._rt_pid, tid, f"conn r{handle.rid}")
            self.tracer.span(
                self._rt_pid, tid, f"r{handle.rid} {status}",
                handle.t_submit_wall, lat or 0.0,
                args={"tokens": handle.n_tokens,
                      "ttft_wall": ttft, "tpot_wall": tpot})
            if handle.t_first_token_wall is not None:
                self.tracer.instant(self._rt_pid, tid, "first_token",
                                    handle.t_first_token_wall)


def instrument_rt(rt, registry: MetricsRegistry, tracer=None) -> RTProbe:
    """Attach the wall-clock front-door probe to an ``AsyncEchoEngine``
    (the service-level probes are attached separately by
    ``AsyncEchoEngine.instrument``)."""
    return RTProbe(rt, registry, tracer)


# ----------------------------------------------------------------- wiring
def instrument_engine(engine: EchoEngine, registry: MetricsRegistry,
                      tracer=None, *, replica: int = 0) -> EngineProbe:
    """Attach the drift probes (and optionally a tracer track) to one
    engine. Returns the probe (already registered as a listener)."""
    probe = EngineProbe(engine, registry, replica=replica)
    engine.listeners.append(probe)
    if tracer is not None:
        tracer.attach_engine(engine, pid=replica)
    return probe


def instrument(service, registry: MetricsRegistry,
               tracer=None) -> Tuple[ServiceMetrics, List[EngineProbe]]:
    """Attach the full probe set to an ``EchoService``: the bus bridge plus
    one ``EngineProbe`` per backend engine; with a tracer, the lifecycle
    tracks too (replica pids line up between metrics and trace)."""
    sm = ServiceMetrics(service.events, registry)
    backend = service.backend
    engines = backend.engines() if hasattr(backend, "engines") \
        else [backend]
    probes = [EngineProbe(eng, registry, replica=i)
              for i, eng in enumerate(engines)]
    for eng, probe in zip(engines, probes):
        eng.listeners.append(probe)
    if tracer is not None:
        tracer.attach(service)
    return sm, probes
