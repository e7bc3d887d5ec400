"""The port's ``data/`` and ``obs/`` against the JAX package's: the workload
generators give equal requests; a model-less engine on the virtual clock,
with an ``EngineProbe`` and a ``Tracer`` attached in each package, gives a
byte-equal Prometheus text and an equal trace; and the port's
``check_trace`` / ``check_prometheus`` accept its own artifacts and reject
the malformed ones of tests/test_obs.py.

The engine stamps each iteration's scheduler time with the host clock
(``time.perf_counter``), which both metrics and trace record. To compare
byte for byte, both engine modules read one counting clock that advances
a fixed step a call: the engines are copies, so they read it equally
often."""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import repro.core.engine as jengine_mod
import repro.data as jdata
import repro.obs as jobs
from repro.core import ECHO_C as J_ECHO_C
from repro.core import SLO as JSLO
from repro.core import EchoEngine as JEchoEngine
from repro.core import TimeModel as JTimeModel
import repro_torch.core.engine as tengine_mod
import repro_torch.data as tdata
import repro_torch.obs as tobs
from repro_torch.core import ECHO_C, SLO, EchoEngine, TimeModel
from repro_torch.obs.check import check_prometheus, check_trace

ROOT = Path(__file__).resolve().parents[1]

PORT = types.SimpleNamespace(core=types.SimpleNamespace(
    EchoEngine=EchoEngine, ECHO_C=ECHO_C, SLO=SLO, TimeModel=TimeModel),
    data=tdata, obs=tobs, engine_mod=tengine_mod)
JAX = types.SimpleNamespace(core=types.SimpleNamespace(
    EchoEngine=JEchoEngine, ECHO_C=J_ECHO_C, SLO=JSLO, TimeModel=JTimeModel),
    data=jdata, obs=jobs, engine_mod=jengine_mod)


def _req_fields(r):
    return (r.prompt, r.max_new_tokens, r.task_type.value, r.arrival_time,
            None if r.slo is None else (r.slo.ttft, r.slo.tpot))


def _numbered(reqs):
    """Requests numbered 0.. in order: each package counts its own rids."""
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


# ---------------------------------------------------------------- data
def _pressure_workload(pkg, seed=0, duration=4.0, rate=6.0):
    """tests/test_obs.py's workload, built with ``pkg``'s own generators."""
    rng = np.random.default_rng(seed)
    arrivals = list(np.cumsum(rng.exponential(1.0 / rate, int(rate * duration))))
    online = pkg.data.make_online_requests(arrivals, prompt_mean=96, prompt_std=24,
                                           max_new_mean=8, slo=pkg.core.SLO(1.0, 0.1),
                                           seed=seed + 1)
    offline = pkg.data.make_offline_corpus(4, 8, doc_len=192, question_len=16,
                                           max_new=4, seed=seed + 2)
    return _numbered(online + offline)


def test_online_and_offline_generators_match_jax():
    want, got = _pressure_workload(JAX, seed=3), _pressure_workload(PORT, seed=3)
    assert [_req_fields(r) for r in got] == [_req_fields(r) for r in want]
    jo = jdata.make_offline_corpus(3, 5, doc_len=64, question_len=8, shuffle=True,
                                   seed=9, arrival_time=1.5)
    to = tdata.make_offline_corpus(3, 5, doc_len=64, question_len=8, shuffle=True,
                                   seed=9, arrival_time=1.5)
    assert [_req_fields(r) for r in to] == [_req_fields(r) for r in jo]


def test_bursty_trace_matches_jax():
    kw = dict(base_rate=3.0, tidal_period=40.0, burst_prob=0.1, burst_len=3.0, seed=4)
    want = jdata.BurstyTrace(**kw)
    got = tdata.BurstyTrace(**kw)
    assert got.sample(0.0, 30.0) == want.sample(0.0, 30.0)
    assert got.rate(7.0, True) == want.rate(7.0, True)


def test_multi_tenant_workload_matches_jax():
    def build(data, slo):
        tenants = data.default_tenants(4) + (
            data.TenantSpec("b", online_rate=1.0, slo=slo(1.5, 0.15), n_docs=2,
                            questions_per_doc=5),)
        return data.make_multi_tenant_workload(tenants, 10.0, seed=2)
    jon, joff = build(jdata, JSLO)
    ton, toff = build(tdata, SLO)
    assert [t.name for t in tdata.default_tenants(4)] == \
        [t.name for t in jdata.default_tenants(4)]
    assert [_req_fields(r) for r in ton] == [_req_fields(r) for r in jon]
    assert [_req_fields(r) for r in toff] == [_req_fields(r) for r in joff]
    assert dataclasses.asdict(tdata.TenantSpec("x")) == \
        dataclasses.asdict(jdata.TenantSpec("x"))


# ---------------------------------------------------------------- obs
class _CountingClock:
    """``time.perf_counter`` advancing 250 µs a call."""

    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return self.n * 2.5e-4


def _drive(pkg, monkeypatch, cap=200_000):
    """The workload through a model-less engine with a small device cache
    and a host tier (preemption and swap both happen), probe and tracer
    attached. Returns (stats, registry, tracer)."""
    clock = _CountingClock()
    monkeypatch.setattr(pkg.engine_mod, "time", clock)
    core = pkg.core
    eng = core.EchoEngine(None, None, core.ECHO_C, num_blocks=48, block_size=16,
                          chunk_size=32, time_model=core.TimeModel.a100(),
                          host_kv_blocks=64)
    registry, tracer = pkg.obs.MetricsRegistry(), pkg.obs.Tracer(cap=cap)
    pkg.obs.instrument_engine(eng, registry, tracer, replica=0)
    for r in _pressure_workload(pkg):
        eng.submit(r)
    stats = eng.run(max_iters=20_000)
    monkeypatch.undo()
    assert clock.n > 0
    return stats, registry, tracer


def test_probe_and_tracer_match_jax_byte_for_byte(monkeypatch, tmp_path):
    jstats, jreg, jtr = _drive(JAX, monkeypatch)
    tstats, treg, ttr = _drive(PORT, monkeypatch)
    assert len(tstats.iterations) == len(jstats.iterations) > 0
    assert ttr.preempted_rids() and ttr.swapped_rids(), \
        "the drive must preempt and swap"
    assert ttr.preempted_rids() == jtr.preempted_rids()
    assert ttr.swapped_rids() == jtr.swapped_rids()
    # the probe saw every iteration the engine recorded
    assert treg.get("iteration_seconds").labels("0").count == len(tstats.iterations)
    prom_t, prom_j = treg.to_prometheus(), jreg.to_prometheus()
    assert prom_t.encode() == prom_j.encode()
    assert json.dumps(treg.to_json(), sort_keys=True) == \
        json.dumps(jreg.to_json(), sort_keys=True)
    assert ttr.to_dict() == jtr.to_dict()
    assert ttr.dropped_events == jtr.dropped_events == 0
    # and the artifacts the port writes pass its checker
    trace, prom = tmp_path / "trace.json", tmp_path / "m.prom"
    ttr.write(str(trace))
    treg.write(str(prom))
    summary = check_trace(str(trace))
    assert summary["spans"] > 0 and summary["instants"] > 0
    assert check_prometheus(str(prom))["samples"] > 0


def test_tracer_ring_buffer_matches_jax(monkeypatch):
    _, _, jtr = _drive(JAX, monkeypatch, cap=100)
    _, _, ttr = _drive(PORT, monkeypatch, cap=100)
    assert len(ttr._events) == 100
    assert ttr.dropped_events == jtr.dropped_events > 0
    assert ttr.to_dict() == jtr.to_dict()


def test_check_cli_accepts_the_port_artifacts(monkeypatch, tmp_path):
    """``python -m repro_torch.obs.check`` on a trace and a metrics file."""
    _, reg, tr = _drive(PORT, monkeypatch)
    trace, prom, bad = tmp_path / "trace.json", tmp_path / "m.prom", tmp_path / "bad.prom"
    tr.write(str(trace))
    reg.write(str(prom))
    bad.write_text("this is { not exposition\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def check(*paths):
        return subprocess.run([sys.executable, "-m", "repro_torch.obs.check",
                               *map(str, paths)], capture_output=True, text=True,
                              timeout=120, cwd=ROOT, env=env)
    out = check(trace, prom)
    assert out.returncode == 0, out.stderr
    assert check(bad).returncode != 0


def test_registry_round_trip_matches_jax():
    """tests/test_obs.py's registry drive in both packages: equal text,
    and each package's parser reads the other's."""
    def fill(obs):
        reg = obs.MetricsRegistry()
        c = reg.counter("reqs_total", "requests", ("kind",))
        c.labels("online").inc(3)
        c.labels("offline").inc(2.5)
        reg.gauge("depth", "queue depth").labels().set(7)
        h = reg.histogram("lat", "latency", ("replica",), buckets=obs.LATENCY_BUCKETS)
        for v in (0.01, 0.2, 0.2, 3.0, 50.0):
            h.labels("0").observe(v)
        return reg
    jt, tt = fill(jobs).to_prometheus(), fill(tobs).to_prometheus()
    assert tt == jt
    assert tobs.parse_prometheus(jt) == jobs.parse_prometheus(tt)
    h = tobs.Histogram("lat", "", buckets=(0.1, 0.2, 0.4))
    jh = jobs.Histogram("lat", "", buckets=(0.1, 0.2, 0.4))
    for v in (0.05, 0.15, 0.15, 0.3):
        h.observe(v)
        jh.observe(v)
    for q in (0.25, 0.5, 0.9, 1.0):
        assert h.percentile(q) == jh.percentile(q)


def test_check_trace_rejects_invalid_artifacts(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"events": []}))
    with pytest.raises(ValueError, match="traceEvents"):
        check_trace(str(bad))
    nospan = tmp_path / "nospan.json"
    nospan.write_text(json.dumps(
        {"traceEvents": [{"ph": "i", "name": "x", "pid": 0, "tid": 1, "ts": 0.0}]}))
    with pytest.raises(ValueError, match="no complete"):
        check_trace(str(nospan))
    missing = tmp_path / "missing.json"
    missing.write_text(json.dumps(
        {"traceEvents": [{"ph": "X", "name": "x", "pid": 0, "tid": 1}]}))
    with pytest.raises(ValueError, match="missing ts"):
        check_trace(str(missing))


def test_check_prometheus_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.prom"
    bad.write_text("this is { not exposition\n")
    with pytest.raises(ValueError):
        check_prometheus(str(bad))
