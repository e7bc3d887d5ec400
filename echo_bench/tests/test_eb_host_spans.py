"""The port's host track as the benchmark reads it: host stamps mapped onto
the profiler's clock by two anchors; idle stretches named by the innermost
program span; the span and counter readers on a made-up record, their
``.itl`` copies, and the tiny CPU cell run with the track attached."""
from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import pytest

from conftest import TINY_CELL
from echo_bench import hostspans
from echo_bench.devtrace import Trace
from echo_bench.serve import Call, Record
from echo_bench.spec import metric_reader
from repro_torch.obs.trace import HostSpan

SPAN_READERS = ("step_host_ms", "est_err_pct", "clock_lag_pct", "decode_host_ms")
COUNTER_READERS = ("kv_scan_blocks", "kv_hash_blocks", "prefill_pad_pct")
MS = 1_000_000


def _span(name, t0, t1, sid, parent=0, rid=None, **args):
    return HostSpan(name, t0, t1, sid, parent, rid, args or None, 1)


def _record():
    """Two window steps (times in ns on the host's clock, from 10 s) and a
    third that began after the window; counters over the window's two
    iterations; three prefill calls, two in the window."""
    s = 10_000 * MS
    spans = [
        # step 1: 20 ms, schedule 4 ms, one chunk (6 ms), commit 1 ms, the rest host work
        _span("schedule", s, s + 4 * MS, 2, 1), _span("swaps", s + 4 * MS, s + 5 * MS, 3, 1),
        _span("runner.prefill", s + 5 * MS, s + 11 * MS, 4, 1, rid=7, live=40, rows=512),
        _span("commit", s + 11 * MS, s + 12 * MS, 5, 1, rid=7),
        _span("clock", s + 12 * MS, s + 20 * MS, 6, 1),
        _span("step", s, s + 20 * MS, 1, now=1.0, predicted_us=12_000, n_prefill=1,
              n_decode=0),
        # step 2: 30 ms from 10.02 s, a decode of 10 ms whose logits copy takes 7 ms
        _span("schedule", s + 20 * MS, s + 22 * MS, 12, 11),
        _span("prep", s + 22 * MS, s + 23 * MS, 14, 13),
        _span("forward", s + 23 * MS, s + 25 * MS, 15, 13),
        _span("logits", s + 25 * MS, s + 32 * MS, 16, 13),
        _span("runner.decode", s + 22 * MS, s + 32 * MS, 13, 11, live=3, rows=4),
        _span("commit", s + 32 * MS, s + 50 * MS, 17, 11),
        _span("step", s + 20 * MS, s + 50 * MS, 11, now=1.03, predicted_us=5_000,
              n_prefill=0, n_decode=3),
        # after the window
        _span("record", s + 10_000 * MS, s + 10_001 * MS, 22, 21),
        _span("step", s + 10_000 * MS, s + 10_002 * MS, 21, now=9.0, predicted_us=1,
              n_prefill=0, n_decode=0)]
    rec = Record(model={}, engine={"block_size": 16, "chunk_size": 512}, window=(10.0, 20.0))
    rec.spans = hostspans.window_spans(spans, rec.window)
    rec.iterations = [(10.02, 0.004), (10.05, 0.002)]
    rec.counters = {"start": {"scanned_blocks": 1000, "hashed_blocks": 50},
                    "end": {"scanned_blocks": 1000 + 2 * 40_704, "hashed_blocks": 450}}
    rec.calls = [Call("prefill", 10.005, 10.011, rid=7, chunk=40, ctx=(0,)),
                 Call("prefill", 10.3, 10.31, rid=8, chunk=512, ctx=(0,)),
                 Call("prefill", 25.0, 25.1, rid=9, chunk=16, ctx=(0,))]
    return rec


def test_window_spans_keep_the_steps_that_began_in_the_window_with_their_spans():
    rec = _record()
    assert sorted(s.id for s in rec.spans) == [1, 2, 3, 4, 5, 6, 11, 12, 13, 14, 15, 16, 17]


def test_span_and_counter_readers():
    rec = _record()
    read = {n: metric_reader(n) for n in SPAN_READERS + COUNTER_READERS}
    # step 1: 20 - 4 - 6 = 10 ms; step 2: 30 - 2 - 10 = 18 ms
    assert read["step_host_ms"](rec) == pytest.approx(14.0)
    # step 1: |12 - 6| / 6 = 100%; step 2: |5 - 10| / 10 = 50%
    assert read["est_err_pct"](rec) == pytest.approx(75.0)
    assert hostspans.estimate_errors(rec.spans) == pytest.approx([1.0, -0.5])
    # now moved 0.03 s while 30 ms of wall time passed between the step ends
    assert read["clock_lag_pct"](rec) == pytest.approx(0.0, abs=1e-9)
    assert read["decode_host_ms"](rec) == pytest.approx(3.0)
    assert read["kv_scan_blocks"](rec) == pytest.approx(40_704)
    assert read["kv_hash_blocks"](rec) == pytest.approx(200)
    # the two window calls: 552 live rows of 1,024 computed
    assert read["prefill_pad_pct"](rec) == pytest.approx(100 * (1024 - 552) / 1024)
    rec.spans[-1] = rec.spans[-1]._replace(args=dict(rec.spans[-1].args, now=1.015))
    assert read["clock_lag_pct"](rec) == pytest.approx(50.0)


def test_readers_find_nothing_where_the_program_records_nothing():
    """The parent's program has no host track, no counters beside the hit
    counters, and the run records no spans: each reader gives None."""
    rec = _record()
    del rec.spans
    rec.counters = {"start": {"offline_hit_blocks": 1}, "end": {"offline_hit_blocks": 2}}
    for n in SPAN_READERS + ("kv_scan_blocks", "kv_hash_blocks"):
        assert metric_reader(n)(rec) is None
    rec.calls = []
    assert metric_reader("prefill_pad_pct")(rec) is None


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_new_itl_copies_read_as_their_originals(name):
    rec = _record()
    assert metric_reader(name + ".itl")(rec) == metric_reader(name)(rec)


def test_clock_maps_host_spans_onto_the_profilers_ranges():
    """A CPU-only profile: each host span opened around a ``record_function``
    range lands on that range, both ends within 200 us, once the two
    anchors map the host's clock onto the profiler's."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.obs import Tracer
    tracer = Tracer()
    engine = types.SimpleNamespace(scheduler=types.SimpleNamespace(), runner=None)
    track = tracer.attach_host(engine)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    anchors = [hostspans.take_anchor(f"{hostspans.ANCHOR}.start")]
    for i in range(6):
        track.open(f"span{i}")
        with record_function(f"eb.range{i}"):
            time.sleep(0.003)
        track.close()
    anchors.append(hostspans.take_anchor(f"{hostspans.ANCHOR}.stop"))
    prof.stop()
    ranges = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("eb.")]
    clock = hostspans.Clock(anchors, ranges)
    assert len(clock.offsets_ns) == 2
    by_name = {n: (s, e) for n, s, e in ranges}
    spans = tracer.host_spans()
    assert len(spans) == 6
    for sp in spans:
        s, e = by_name["eb.range" + sp.name[4:]]
        assert abs(clock(sp.t0) - s) < 200_000 and abs(clock(sp.t1) - e) < 200_000


def test_idle_gaps_are_labelled_by_the_innermost_program_span():
    """The benchmark's ranges and the host track on one clock (here the
    identity): a gap is named by the path below ``step`` of the innermost
    program span open as it began; one inside ``eb.step`` before the
    program's ``step`` opened keeps the benchmark's label."""
    ns = 1_000_000_000
    ranges = [("eb.window", 0, ns), ("eb.step", 15, ns // 2)]
    ops = [("gemm", 10, 20, 1), ("gemm", 300, 400, 2), ("gemm", 450, 550, 3),
           ("gemm", 700, 800, 4), ("gemm", ns // 2 + 10, ns // 2 + 20, 5)]
    trace = Trace(start=0, end=ns, ranges=ranges, ops=ops, launch_at={}, lacking=0)
    spans = [_span("prep", 500, 600, 3, 2), _span("logits", 600, ns // 4, 4, 2),
             _span("runner.decode", 500, ns // 4, 2, 1),
             _span("commit", ns // 4, ns // 2 - 5, 5, 1), _span("step", 200, ns // 2 - 5, 1)]
    gaps = hostspans.idle_gaps(trace, spans, lambda t: t)
    assert len(gaps) == 6
    by_start = {}
    for label, sec in gaps:
        by_start[label] = by_start.get(label, 0.0) + sec
    assert by_start == pytest.approx({
        "generator and harness": (10 + ns - (ns // 2 + 20)) / ns,   # before eb.step, after it
        "engine step, other": 280 / ns,                            # 20..300: no step yet
        "step": 50 / ns,                                           # 400..450
        "runner.decode/prep": 150 / ns,                            # 550..700
        "runner.decode/logits": (ns // 2 + 10 - 800) / ns})        # 800..: inside logits
    assert gaps[0][0] == "generator and harness"
    # split by what the host did through each stretch: the gap that began in
    # logits also lasted through commit and past the program's step
    by_span = dict(hostspans.idle_by_span(trace, spans, lambda t: t))
    assert by_span == pytest.approx({
        "generator and harness": (10 + 10 + ns // 2 - 20) / ns,
        "engine step, other": (180 + 5) / ns,                      # 20..200; the step's tail
        "step": (100 + 50) / ns,                                   # 200..300, 400..450
        "runner.decode/prep": 50 / ns,                             # 550..600
        "runner.decode/logits": (100 + ns // 4 - 800) / ns,        # 600..700, 800..ns/4
        "commit": (ns // 4 - 5) / ns})                             # ns/4..ns/2 - 5
    assert sum(by_span.values()) == pytest.approx(sum(by_start.values()))


def test_tiny_cell_with_the_host_track_reads_all_seven(checkout):
    """``tools/host_spans.py`` on the tiny CPU cell: ``run.py``'s own line
    carries the counter readers, and the tool's line all seven readings."""
    p = subprocess.run([sys.executable, "echo_bench/tools/host_spans.py", "--workload",
                        TINY_CELL, "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
                       cwd=checkout, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    run_line, out = json.loads(lines[-2]), json.loads(lines[-1])
    assert run_line["correct"] is True
    assert {n + s for n in COUNTER_READERS for s in ("", ".itl")} <= set(run_line["metrics"])
    assert all(v is not None for v in out["metrics"].values()), out
    assert set(out["metrics"]) == set(SPAN_READERS + COUNTER_READERS)
    assert out["metrics"]["kv_scan_blocks"] >= 512                 # the pool, once a step
    assert 0 <= out["metrics"]["prefill_pad_pct"] < 100
    assert out["window_spans"] > 0 and out["dropped_events"] == 0
