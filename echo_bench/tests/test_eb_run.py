"""Whole runs of ``run.py`` on the tiny CPU cell, as the driver starts
them, from a checkout; and a mix added as a new file only."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import DATA, TINY_CELL, make_checkout

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(root, cell, trace, seed=2147483659, seconds=2):
    p = subprocess.run([sys.executable, "echo_bench/run.py", "--workload", cell,
                        "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], cwd=root, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_whole_run_prints_a_valid_line(checkout, trace):
    out, err = _run(checkout, TINY_CELL, trace)
    assert KEYS <= set(out) and list(out)[-1] == "check"
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    if trace:
        # the host-side per-layer metrics; the device ones need the card
        assert {"sched_ms", "prefill_ms", "decode_ms", "ttft_p95_ms.host_bound",
                "itl_p95_ms.host_bound", "sched_ms.itl", "decode_ms.itl",
                "offline_computed_tok_s", "kv_used_pct", "offline_tok_s.itl",
                "ttft_p95_ms.itl"} <= set(out["metrics"])
        assert 0 < out["metrics"]["kv_used_pct"]["value"] <= 100
        assert out["metrics"]["decode_ms.itl"] == out["metrics"]["decode_ms"]
        assert not {"idle_pct", "mfu_pct"} & set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"offline_tok_s", "itl_p95_ms", "setup_s"}
        assert out["metrics"]["setup_s"]["value"] > 0
    assert err.strip().splitlines()[-1].startswith("check ")


def test_a_new_mix_is_a_new_file(tmp_path):
    """A mix added as ``traffic/<name>.json`` (with its cell and limits) is
    served with no edit to any file of the harness."""
    mix = json.loads((DATA / "tiny_mix.json").read_text())
    mix["online"]["rate_per_s"] = 3.0
    mix["offline"]["docs"] = 2
    root = make_checkout(tmp_path, "tmp_mix", mix)
    out, _ = _run(root, "tiny.tmp_mix", 0, seed=5)
    assert out["correct"] is True and set(out["metrics"]) >= {"setup_s"}


def test_same_seed_same_inputs():
    from echo_bench import traffic
    mix = json.loads((DATA / "tiny_mix.json").read_text())
    a, b = traffic.make_online(mix, 256, 7, 2), traffic.make_online(mix, 256, 7, 2)
    assert [(x.due_s, x.prompt, x.max_new) for x in a] == \
        [(x.due_s, x.prompt, x.max_new) for x in b]
    c = traffic.make_online(mix, 256, 8, 2)
    # another seed: the same sizes and gaps, in another order
    assert sorted(len(x.prompt) for x in a) == sorted(len(x.prompt) for x in c)
    assert [x.prompt for x in a] != [x.prompt for x in c]
    oa, oc = traffic.make_offline(mix, 256, 7), traffic.make_offline(mix, 256, 8)
    # documents and questions pair up otherwise; the work in all is the same
    assert sum(len(x.prompt) for x in oa) == sum(len(x.prompt) for x in oc)
    assert sorted(x.max_new for x in oa) == sorted(x.max_new for x in oc)


@pytest.mark.parametrize("seconds", [2, 51, 200])
def test_online_stream_outlasts_the_window(seconds):
    """The stream is drawn for the run's own window: arrivals are due
    until past the window's end, whatever ``--seconds`` is."""
    from echo_bench import traffic
    mix = json.loads((DATA / "tiny_mix.json").read_text())
    for seed in (7, 2 ** 31 + 11):
        specs = traffic.make_online(mix, 256, seed, seconds)
        assert specs[-1].due_s >= mix["ramp_s"] + seconds


def test_no_card_no_result(checkout):
    """The real cells ask for CUDA: with none, the run exits non-zero and
    prints no result."""
    p = subprocess.run([sys.executable, "echo_bench/run.py", "--workload", "yi-9b.docqa",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=checkout,
                       capture_output=True, text=True, timeout=120)
    if "device_count() is 0" not in p.stderr:
        pytest.skip("a CUDA device is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_only_the_benchmark_files_is_no_result(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the harness (no port)
    exits non-zero and prints nothing on standard output."""
    root = make_checkout(tmp_path)
    (root / "src").unlink()
    p = subprocess.run([sys.executable, "echo_bench/run.py", "--workload", TINY_CELL,
                        "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=root,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "repro_torch" in p.stderr
