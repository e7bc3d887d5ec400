"""The metric arithmetic: rates over the window, percentiles over all
samples, live-row work, each kernel's bound against ``chip_smoke.py``'s at
its shapes, and the per-layer readers on a made-up record and trace."""
from __future__ import annotations

import json

import pytest

from conftest import REPO
from echo_bench import roofline, stats
from echo_bench.devtrace import Trace
from echo_bench.serve import Call, Record
from echo_bench.spec import metric_reader

QWEN = json.loads((REPO / "echo_bench/configs/qwen3-4b.json").read_text())["model"]
YI = json.loads((REPO / "echo_bench/configs/yi-9b.json").read_text())["model"]


def test_quantile_is_numpys_linear_interpolation():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.quantile(xs, 0.5) == 3.0
    assert stats.quantile(xs, 0.95) == pytest.approx(4.8)
    assert stats.quantile(list(range(101)), 0.95) == pytest.approx(95.0)
    assert stats.quantile([7.0], 0.95) == 7.0


def test_ttft_counts_requests_due_in_the_window_and_a_missing_first_token():
    due = [0.5, 1.0, 2.0, 3.0, 5.0]
    first = [0.6, 1.3, None, 3.1, 5.2]
    got, failed = stats.ttfts(due, first, (1.0, 4.0), drain_end=9.0)
    assert got == pytest.approx([0.3, 7.0, 0.1]) and failed == 1


def test_itl_takes_every_gap_whose_later_token_lands_in_the_window():
    times = {1: [0.0, 0.9, 1.1, 1.6, 4.5], 2: [2.0, 2.5]}
    assert sorted(stats.itls(times, (1.0, 4.0))) == pytest.approx([0.2, 0.5, 0.5])
    assert stats.rate(300.0, (2.0, 5.0)) == pytest.approx(100.0)


def test_bounds_reproduce_chip_smoke():
    """``chip_smoke.py``'s kernel lines (PERF.md's kernel table): decode B 8
    at qwen3-4b's heads, contexts summing to 752 (its draw near 100 each),
    0.00096 ms; the prefill chunk Sc 64 at context 448 against T 512, 0.00094
    ms (both bound by bytes)."""
    ctx = [94] * 8
    nbytes, flops = roofline.decode_attn_work(QWEN, ctx, 16)
    smoke = (2 * 8 * 32 * 128 * 2 + sum(ctx) * 8 * 128 * 2 * 2
             + sum(-(-c // 16) for c in ctx) * 4 + 8 * 4)
    assert nbytes == smoke and flops == 4 * sum(ctx) * 32 * 128
    assert round(roofline.bound_s(nbytes, flops, "bfloat16") * 1e3, 5) == 0.00096
    nbytes, flops = roofline.prefill_attn_work(QWEN, 64, 448)
    assert flops == 4 * 128 * 32 * sum(448 + i + 1 for i in range(64))
    assert round(roofline.bound_s(nbytes, flops, "bfloat16") * 1e3, 5) == 0.00094


def test_live_rows_only():
    """A 40-row tail of a 1,024-row chunk counts 40 rows, and each row only
    the keys up to its own position."""
    nbytes, flops = roofline.prefill_attn_work(QWEN, 40, 1000)
    assert flops == 4 * 128 * 32 * sum(1000 + i + 1 for i in range(40))
    assert nbytes == 2 * 40 * 32 * 128 * 2 + 2 * 1040 * 8 * 128 * 2
    d, ff = YI["d_model"], YI["d_ff"]
    per_tok = 2 * (d * 32 * 128 + 2 * d * 4 * 128 + 32 * 128 * d + 3 * d * ff)
    assert roofline.layer_matmul_flops(YI) == per_tok
    _, att = roofline.decode_attn_work(YI, [10, 20], 16)
    assert roofline.decode_call_flops(YI, [10, 20], 16) == \
        48 * (2 * per_tok + att) + 2 * 2 * d * 64000


def _record():
    rec = Record(model=YI, engine={"block_size": 16}, window=(10.0, 20.0), num_blocks=200,
                 offline_rids=frozenset({1, 2, 7}), offline_progress=4000)
    rec.calls = [Call("prefill", 11.0, 11.03, rid=1, chunk=512, ctx=(0,)),
                 Call("decode", 11.05, 11.1, ctx=(100, 200), rids=(7, 9)),
                 Call("prefill", 25.0, 25.1, rid=2, chunk=40, ctx=(2048,))]
    rec.occupancy = {"start": {"running_online": 5, "running_offline": 20, "free_online": 0,
                               "free_offline": 0, "unused": 175},
                     "end": {"running_online": 10, "running_offline": 30, "free_online": 4,
                             "free_offline": 6, "unused": 150}}
    rec.iterations = [(11.2, 0.004), (12.0, 0.006)]
    rec.online = [(9.0, 1), (10.5, 2), (12.0, 3), (19.0, 4)]
    rec.token_times = {1: [9.5, 10.5], 2: [10.9, 11.4, 11.6], 3: [12.2]}
    rec.drain_end = 30.0
    rec.counters = {"start": {"offline_hit_blocks": 10, "offline_lookup_blocks": 40},
                    "end": {"offline_hit_blocks": 40, "offline_lookup_blocks": 80}}
    ns = 1_000_000_000
    ranges = [("eb.window", 0, ns), ("eb.step", 0, ns // 2),
              ("eb.schedule", 0, ns // 10), ("eb.prefill#0", ns // 10, ns // 5),
              ("eb.decode#1", ns // 5, ns // 2)]
    ops = [("chunked_prefill_tc_kernel", ns // 10 + 10, ns // 10 + 1010, 1),
           ("splitk_cluster_kernel", ns // 5 + 10, ns // 5 + 2010, 2),
           ("gemm", ns // 5 + 3000, ns // 5 + 4000, 3),
           ("gemm", 6 * ns // 10, 6 * ns // 10 + 1000, 4)]
    calls = {"eb.prefill": [(ns // 10, ns // 5, 0)], "eb.decode": [(ns // 5, ns // 2, 1)]}
    rec.trace = Trace(start=0, end=ns, ranges=ranges, ops=ops,
                      launch_at={1: ns // 10 + 5, 2: ns // 5 + 5, 3: ns // 5 + 6,
                                 4: ns // 2 + 5},
                      lacking=0, calls=calls)
    return rec


def test_readers():
    rec = _record()
    read = {n: metric_reader(n) for n in
            ("sched_ms", "prefix_hit_pct", "prefill_ms", "decode_ms", "idle_pct",
             "prefill_attn_roofline", "decode_attn_roofline", "mfu_pct",
             "ttft_p95_ms.host_bound", "itl_p95_ms.host_bound", "offline_computed_tok_s",
             "kv_used_pct", "offline_tok_s.itl")}
    assert read["sched_ms"](rec) == pytest.approx(5.0)
    assert read["prefix_hit_pct"](rec) == pytest.approx(75.0)
    assert read["prefill_ms"](rec) == pytest.approx(30.0)      # the call past the window is out
    assert read["decode_ms"](rec) == pytest.approx(50.0)
    assert read["idle_pct"](rec) == pytest.approx(100 * (1 - 5000e-9))
    b = roofline.bound_s(*roofline.prefill_attn_work(YI, 512, 0), "bfloat16")
    assert read["prefill_attn_roofline"](rec) == pytest.approx(100 * b / 1000e-9)
    b = roofline.bound_s(*roofline.decode_attn_work(YI, (100, 200), 16), "bfloat16")
    assert read["decode_attn_roofline"](rec) == pytest.approx(100 * b / 2000e-9)
    flops = (roofline.prefill_call_flops(YI, 512, 0)
             + roofline.decode_call_flops(YI, (100, 200), 16))
    assert read["mfu_pct"](rec) == pytest.approx(100 * flops / 989e12)
    # due in the window: 0.4 s, 0.2 s and one with no first token (30 - 19)
    assert read["ttft_p95_ms.host_bound"](rec) == pytest.approx(
        1e3 * stats.quantile([0.4, 0.2, 11.0], 0.95))
    assert read["itl_p95_ms.host_bound"](rec) == pytest.approx(
        1e3 * stats.quantile([1.0, 0.5, 0.2], 0.95))
    # the offline prefill's 512 rows and one offline decode row, in 10 s;
    # the call past the window and the online decode row are out
    assert read["offline_computed_tok_s"](rec) == pytest.approx(51.3)
    assert read["kv_used_pct"](rec) == pytest.approx(25.0)
    assert read["offline_tok_s.itl"](rec) == pytest.approx(400.0)
    rec.trace = None
    assert read["mfu_pct"](rec) is None and read["idle_pct"](rec) is None


@pytest.mark.parametrize("copy, original", [
    (n + ".itl", n) for n in ("sched_ms", "prefix_hit_pct", "prefill_ms", "decode_ms",
                              "offline_computed_tok_s", "kv_used_pct", "idle_pct",
                              "prefill_attn_roofline", "decode_attn_roofline", "mfu_pct")
] + [("ttft_p95_ms.itl", "ttft_p95_ms.host_bound")])
def test_itl_copies_read_as_their_originals(copy, original):
    rec = _record()
    assert metric_reader(copy)(rec) == metric_reader(original)(rec)


def test_occupancy_line_counts_running_and_cached_blocks():
    use = _record().occupancy["end"]
    line = stats.occupancy_line(use, 200)
    assert line.startswith("50 of 200 blocks hold KV (25.0%)") and "150 free" in line


def test_idle_gaps_are_labelled_by_the_innermost_range():
    gaps = _record().trace.idle_gaps()
    ns = 1_000_000_000
    assert gaps[0] == ("generator and harness", pytest.approx((4 * ns // 10 - 1000) / ns))
    assert gaps[1] == ("decode call", pytest.approx((6 * ns // 10 - ns // 5 - 4000) / ns))
    assert {g[0] for g in gaps} == {"schedule", "prefill call", "decode call",
                                    "generator and harness"}
