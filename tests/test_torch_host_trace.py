"""The port's host track (``Tracer.attach_host``) and the counters beside
it, on a tiny attention model on the CPU: spans nest under ``step`` with
the right parent ids and request ids and cover it; attaching the track
changes no token, no iteration record and no engine-clock event; an
engine without it records no host event; the paged runner's spans carry
the plans' rows; the block manager counts each whole-pool walk and each
chain hash; the serve CLI's ``--trace-out`` draws one host thread per
replica."""
import dataclasses
import json
import sys
import types
from collections import Counter

import numpy as np
import pytest
import torch

import repro_torch.core.block_manager as bm_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ECHO, SLO, EchoEngine, EngineListener, Request, TaskType
from repro_torch.core.block_manager import BlockManager
import repro_torch.launch.serve as serve
from repro_torch.models import Model
from repro_torch.models.paged import padded_rows
from repro_torch.obs import Tracer
from repro_torch.obs.trace import HOST_PID

from tests.test_torch_obs import JAX, PORT, _drive

ENGINE_KW = dict(num_blocks=64, block_size=8, chunk_size=16, max_pages_per_seq=16)
STEP_CHILDREN = {"schedule", "swaps", "runner.prefill", "commit", "runner.decode", "clock",
                 "emit", "kv_threshold", "record"}
PHASES = ["continue", "admit_online", "decode_slots", "shed", "admit_offline", "finalize"]


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(name="tiny-dense", family="dense", source="test", num_layers=2,
                      d_model=64, vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=16,
                      d_ff=128, dtype="float32", rope_theta=10_000.0)
    model = Model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


class Plans(EngineListener):
    """Each iteration's prefill chunk lengths and decode batch size."""

    def __init__(self):
        self.chunks, self.batches = [], []

    def on_iteration(self, rec, detail):
        self.chunks += [e - s for _, s, e in detail.prefill_spans]
        if detail.decodes:
            self.batches.append(len(detail.decodes))


def _serve(tiny, host: bool):
    """Offline questions on one shared document beside a few online
    requests, through one engine on the virtual clock, a tracer on the
    engine-clock tracks and, with ``host``, the host track."""
    model, params = tiny
    eng = EchoEngine(model, params, ECHO, device="cpu", **ENGINE_KW)
    tracer = Tracer()
    tracer.attach_engine(eng)
    if host:
        tracer.attach_host(eng)
    plans = Plans()
    eng.listeners.append(plans)
    rng = np.random.default_rng(0)
    doc = tuple(int(x) for x in rng.integers(0, 128, 40))
    reqs = [Request(prompt=doc + tuple(int(x) for x in rng.integers(0, 128, 6)),
                    max_new_tokens=5, task_type=TaskType.OFFLINE) for _ in range(4)]
    reqs += [Request(prompt=tuple(int(x) for x in rng.integers(0, 128, 20)), max_new_tokens=6,
                     task_type=TaskType.ONLINE, arrival_time=0.001 * i, slo=SLO(1.0, 0.2))
             for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_iters=500)
    assert all(r.done for r in reqs)
    return eng, tracer, plans, reqs


@pytest.fixture(scope="module")
def traced(tiny):
    return _serve(tiny, host=True)


def test_spans_nest_under_step_with_their_parents_ids(traced):
    eng, tracer, _, _ = traced
    spans = tracer.host_spans()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    steps = [s for s in spans if s.name == "step"]
    assert steps and all(s.parent == 0 for s in steps)
    assert len(steps) >= len(eng.stats.iterations)
    for s in spans:
        assert "#" not in s.name and s.t0 <= s.t1
        if s.parent:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    names = Counter((by_id[s.parent].name if s.parent else None, s.name) for s in spans)
    assert {c for p, c in names if p == "step"} == STEP_CHILDREN
    assert {c for p, c in names if p == "schedule"} == set(PHASES)
    for kind in ("runner.prefill", "runner.decode"):
        assert {c for p, c in names if p == kind} == {"prep", "forward", "logits"}
    # the phases of one schedule run in their order, one each
    sched = next(s for s in spans if s.name == "schedule")
    kids = sorted((s for s in spans if s.parent == sched.id), key=lambda s: s.t0)
    assert [k.name for k in kids] == PHASES
    for s in steps:
        assert set(s.args) == {"now", "predicted_us", "n_prefill", "n_decode"}
    assert steps[-1].args["now"] == eng.now


def test_request_spans_carry_their_rid(traced):
    _, tracer, plans, reqs = traced
    spans = tracer.host_spans()
    rids = {r.rid for r in reqs}
    prefills = [s for s in spans if s.name == "runner.prefill"]
    assert len(prefills) == len(plans.chunks)
    assert all(s.rid in rids and s.args["live"] > 0 and s.args["rows"] == 16
               for s in prefills)
    assert {s.rid for s in prefills} == rids
    by_id = {s.id: s for s in spans}
    # each chunk's commit follows its runner call under the same step
    for s in prefills:
        nxt = min((c for c in spans if c.parent == s.parent and c.t0 >= s.t1),
                  key=lambda c: c.t0)
        assert nxt.name == "commit" and nxt.rid == s.rid
    assert all(by_id[s.parent].name == "step" for s in prefills)


def test_step_children_cover_it(traced):
    _, tracer, _, _ = traced
    spans = tracer.host_spans()
    for s in (s for s in spans if s.name == "step"):
        covered = sum(c.t1 - c.t0 for c in spans if c.parent == s.id)
        assert covered >= 0.95 * (s.t1 - s.t0), s


def test_the_track_changes_no_token_record_or_engine_clock_event(tiny, traced):
    on_eng, on_tr, on_plans, on_reqs = traced
    off_eng, off_tr, off_plans, off_reqs = _serve(tiny, host=False)
    assert [r.output_tokens for r in on_reqs] == [r.output_tokens for r in off_reqs]
    assert [dataclasses.asdict(r) for r in on_eng.stats.iterations] == \
        [dataclasses.asdict(r) for r in off_eng.stats.iterations]
    assert on_plans.chunks == off_plans.chunks and on_plans.batches == off_plans.batches
    assert off_tr.host_spans() == [] and off_eng.host_track is None
    off = off_tr.to_dict()
    assert all(e["pid"] != HOST_PID for e in off["traceEvents"])
    assert "host_origin_ns" not in off["otherData"]
    on = on_tr.to_dict()
    host = [e for e in on["traceEvents"] if e["pid"] == HOST_PID]
    assert len(host) == len(on_tr.host_spans()) + 3      # the process, thread and its order
    spans = [e for e in host if e["ph"] == "X"]
    assert all(e["ts"] >= 0 and e["dur"] >= 0 and "id" in e["args"] for e in spans)
    assert on["otherData"]["host_origin_ns"] == on_tr.host_origin_ns


def test_engine_clock_tracks_with_the_host_track_still_match_jax(monkeypatch):
    """The parity drive of tests/test_torch_obs.py with the host track on:
    outside its own process the port's trace is the JAX package's, byte for
    byte, and the host track is all steps."""
    _, _, jtr = _drive(JAX, monkeypatch)
    attach = PORT.obs.Tracer.attach_engine

    def attach_both(self, engine, pid=0):
        self.attach_host(engine, replica=pid)
        return attach(self, engine, pid)
    monkeypatch.setattr(PORT.obs.Tracer, "attach_engine", attach_both)
    tstats, _, ttr = _drive(PORT, monkeypatch)
    jd, td = jtr.to_dict(), ttr.to_dict()
    assert [e for e in td["traceEvents"] if e["pid"] != HOST_PID] == jd["traceEvents"]
    steps = [s for s in ttr.host_spans() if s.name == "step"]
    assert len(steps) >= len(tstats.iterations) > 0


def test_runner_spans_carry_the_plans_rows(traced):
    """Each runner call's span carries its live rows (the plan's chunk or
    batch) and the rows the runner computed for them (padded)."""
    _, tracer, plans, _ = traced
    spans = tracer.host_spans()
    prefills = [s for s in spans if s.name == "runner.prefill"]
    decodes = [s for s in spans if s.name == "runner.decode"]
    assert [s.args["live"] for s in prefills] == plans.chunks
    assert all(s.args["rows"] == 16 for s in prefills)
    assert [s.args["live"] for s in decodes] == plans.batches
    assert [s.args["rows"] for s in decodes] == \
        [padded_rows("decode", b, 16) for b in plans.batches]
    assert [padded_rows("decode", b, 16) for b in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]


def test_each_whole_pool_walk_counts_the_pool():
    bm = BlockManager(48, 4)
    m = bm.metrics
    walks = [lambda: bm.running_blocks, lambda: bm.cached_blocks, bm.evictable_count,
             bm.clean_evictable_count, bm.usage_breakdown]
    for i, walk in enumerate(walks, 1):
        walk()
        assert m.scanned_blocks == 48 * i
    bm.occupancy_snapshot()                   # running_blocks and cached_blocks
    assert m.scanned_blocks == 48 * (len(walks) + 2)
    bm.free_blocks                            # no walk
    assert m.scanned_blocks == 48 * (len(walks) + 2)


def _count_hashes(monkeypatch):
    """Counts the ``chain_hash`` calls a ``BlockManager`` method makes (the
    scheduler's own calls are not the KV manager's)."""
    calls = types.SimpleNamespace(n=0)
    real = bm_mod.chain_hash

    def counting(prev, tokens):
        if isinstance(sys._getframe(1).f_locals.get("self"), BlockManager):
            calls.n += 1
        return real(prev, tokens)
    monkeypatch.setattr(bm_mod, "chain_hash", counting)
    return calls


def test_each_chain_hash_is_counted(tiny, monkeypatch):
    calls = _count_hashes(monkeypatch)
    eng, _, _, _ = _serve(tiny, host=False)
    assert eng.bm.metrics.hashed_blocks == calls.n > 0


def test_host_tier_swaps_keep_the_counts(tiny, monkeypatch):
    """A small pool with a host tier: swap-in and the host probes hash too."""
    calls = _count_hashes(monkeypatch)
    model, params = tiny
    eng = EchoEngine(model, params, ECHO, device="cpu", host_kv_blocks=32,
                     **dict(ENGINE_KW, num_blocks=20))
    tracer = Tracer()
    tracer.attach_host(eng)
    rng = np.random.default_rng(1)
    doc = tuple(int(x) for x in rng.integers(0, 128, 48))
    for i in range(6):
        eng.submit(Request(prompt=doc + tuple(int(x) for x in rng.integers(0, 128, 4)),
                           max_new_tokens=3, task_type=TaskType.OFFLINE))
    eng.run(max_iters=500)
    assert eng.bm.metrics.hashed_blocks == calls.n > 0
    spans = tracer.host_spans()
    for s in (s for s in spans if s.name == "step"):
        covered = sum(c.t1 - c.t0 for c in spans if c.parent == s.id)
        assert covered >= 0.95 * (s.t1 - s.t0)


def test_serve_trace_out_draws_a_host_thread_per_replica(tmp_path, monkeypatch, capsys):
    """``launch/serve.py --trace-out`` on the model-free two-replica cluster:
    ``setup_obs`` attaches the host track to each replica's engine, and the
    exported trace has one host thread per replica, each with ``step``
    roots and their children."""
    path = tmp_path / "trace.json"
    monkeypatch.setattr(sys, "argv", ["serve", "--replicas", "2", "--duration", "3",
                                      "--trace-out", str(path)])
    serve.main()
    assert "trace: " in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    host = [e for e in events if e["pid"] == HOST_PID]
    threads = {e["tid"]: e["args"]["name"] for e in host
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert threads == {1: "replica 0 engine thread", 2: "replica 1 engine thread"}
    spans = [e for e in host if e["ph"] == "X"]
    for tid in threads:
        mine = [e for e in spans if e["tid"] == tid]
        roots = {e["args"]["id"] for e in mine if e["args"]["parent"] == 0}
        assert roots and all(e["name"] == "step" for e in mine
                             if e["args"]["id"] in roots)
        assert any(e["args"]["parent"] in roots for e in mine)
