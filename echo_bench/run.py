#!/usr/bin/env python3
"""Run one cell of Echo's co-serving benchmark on the PyTorch/CUDA port.

    python3 echo_bench/run.py --workload yi-9b.docqa --seed 7 --seconds 51 --trace 0

Builds the cell's model from the seed on the card, serves its traffic
through ``repro_torch``'s ``EchoEngine`` (a ramp, the measured window of
``--seconds``, a drain), checks what the served path produced against the
plain float32 reference, and prints one JSON line as the last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from spans, counters and a profiled
sub-window. Exits non-zero, printing no result, where the card (or the
number the cell asks for) is missing, or where the JAX package or JAX has
been loaded. Builds and caches stay under ``build/`` in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_start() -> float:
    """Seconds on ``time.time()`` at which this process started (from
    /proc); now, where that cannot be read."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text()
                     .splitlines() if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


START_WALL = _process_start()


def _setup_paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    cache = ROOT / "build" / "echo_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_modules() -> list:
    """Loaded modules of JAX or of the JAX package, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None, patch=None) -> int:
    """One run. ``patch(session)``, if given, is called once the engine is
    built (the tests plant faults in the served path through it)."""
    args = _parse(argv)
    _setup_paths()
    from echo_bench import judge, stats
    from echo_bench.spec import load_cell, metric_reader
    cell = load_cell(args.workload, ROOT)
    cfg, mix = cell.config, cell.traffic
    device = cfg.get("device", "cuda")
    import torch
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            _say(f"echo_bench: {args.workload} needs {cell.chips} CUDA device(s); "
                 f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                 f"device_count() is {torch.cuda.device_count()}")
            return 2
    torch.set_num_threads(4)
    seed = args.seed % 2 ** 63
    from echo_bench.serve import Session
    from echo_bench.weights import make_params
    params = make_params(cfg["model"], seed, device)
    sess = Session(cfg, mix, params, seed, args.seconds, device, trace=bool(args.trace))
    if patch is not None:
        patch(sess)
    res = sess.run()
    window = (res["start"], res["end"])
    setup_s = time.time() - START_WALL - (time.perf_counter() - res["start"])
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    late = sorted(res["late"])
    _say(f"echo_bench: {args.workload} seed {args.seed}: pool {res['blocks']} blocks of "
         f"{cfg['engine']['block_size']}; window {window[1] - window[0]:.3f} s; "
         f"{len(res['online'])} online requests submitted; generator late by "
         f"p50 {1e3 * stats.quantile(late, 0.5):.2f} ms, p99 "
         f"{1e3 * stats.quantile(late, 0.99):.2f} ms, max {1e3 * late[-1]:.2f} ms")
    _say("echo_bench: set-up parts: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in sess.setup_parts.items()) + f"; setup_s {setup_s:.2f} s")
    left, total = res["backlog_tokens"]
    _say(f"echo_bench: backlog at the window's end: {res['backlog_requests'][0]} of "
         f"{res['backlog_requests'][1]} offline requests unfinished, {left} of {total} "
         f"tokens ({100.0 * left / total:.1f}%) left")

    rec = sess.rec
    for when in ("start", "end"):
        _say(f"echo_bench: KV pool at the window's {when}: "
             + stats.occupancy_line(rec.occupancy[when], rec.num_blocks))
    _say(f"echo_bench: blocks evicted in the window: "
         f"{rec.counters['end']['evictions'] - rec.counters['start']['evictions']}")
    ttft, failed = rec.ttfts()
    itl = rec.itls()
    tails = (f"; online p95 TTFT {1e3 * stats.quantile(ttft, 0.95):.1f} ms, ITL "
             f"{1e3 * stats.quantile(itl, 0.95):.1f} ms" if ttft and itl else "")
    _say(f"echo_bench: {len(ttft)} online requests due in the window, {failed} without a "
         f"first token by the drain's end; {len(itl)} online token gaps in the window{tails}; "
         f"offline progress {res['offline_progress']} tokens")
    if args.trace:
        rec.trace = sess.profiler.trace() if sess.profiler else None
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"], ROOT)(rec)
            if v is None:
                _say(f"echo_bench: per-layer metric {m['name']} found nothing to read")
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"offline_tok_s": stats.rate(res["offline_progress"], window),
               "itl_p95_ms": 1e3 * stats.quantile(itl, 0.95) if itl else None,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if e2e.get(m["name"]) is not None}

    rule = cell.limits["sample"]
    sample = judge.draw(sess.engine.stats.finished, sess.first_ctx, sess.chunks, seed, rule)
    sess.close()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if device == "cuda":
        _say(f"echo_bench: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
             f"before the reference (the weights)")
    verdict = judge.judge(cfg["model"], params, sample) if sample else None
    gap = verdict.max_gap if verdict else None
    served = verdict.served if verdict else 0
    limit = float(cell.limits["max_logit_gap"])
    correct = bool(verdict is not None and gap <= limit and served >= rule["min_served"]
                   and verdict.hit and verdict.multi)
    _say(f"echo_bench: reference over {len(sample)} requests "
         f"({', '.join(s.why for s in sample)}) in {time.perf_counter() - t0:.1f} s")

    found = forbidden_modules()
    if found:
        _say(f"echo_bench: refused: the process has loaded {found}")
        return 3
    out = {"correct": correct, "attempted": len(ttft), "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if device == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                      "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if args.trace and rec.trace is not None:
        tr = rec.trace
        out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = {"device_ops": [[n, s] for n, s, _ in tr.device_ops()[:10]],
                            "idle_gaps": [[n, s] for n, s in tr.idle_gaps()[:10]]}
        _say(f"echo_bench: profiled {tr.window_s:.3f} s, {len(tr.ops)} device operations, "
             f"{tr.lacking} launches without a device record")
    check = {"max_logit_gap": {"value": gap, "limit": limit},
             "served_tokens": {"value": served, "limit": rule["min_served"]},
             "prefix_hit_sampled": {"value": int(bool(verdict and verdict.hit)), "limit": 1},
             "multi_chunk_sampled": {"value": int(bool(verdict and verdict.multi)), "limit": 1}}
    out["check"] = check
    print(json.dumps(out), flush=True)
    for name, c in check.items():
        _say(f"check {name} {c['value']} limit {c['limit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
