#!/usr/bin/env python3
"""Find a cell's knee once: serve its traffic at several online rates, one
engine after another in one process on the same weights, and print for
each rate the share of online requests due in the window that met both
SLO limits (TTFT from the due time, TPOT over the request's life, each
request served to its end or to the drain's limit; one with no first
token misses), the online queue at the window's start and end, and the
end-to-end metrics. The knee is the highest rate with at least 90% met
and no queue growing; the cell's rate is about four fifths of it.

    python3 echo_bench/tools/sweep.py --workload yi-9b.docqa --rates 1,2,3,4 --seconds 20
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--traffic", default=None,
                    help="serve this mix (traffic/<name>.json) instead of the cell's")
    ap.add_argument("--docs", type=int, default=None,
                    help="serve this many offline documents instead of the mix's")
    args = ap.parse_args()
    from echo_bench import stats
    from echo_bench.run import ROOT, _setup_paths
    from echo_bench.spec import load_cell
    _setup_paths()
    import torch
    from echo_bench.serve import Session
    from echo_bench.weights import make_params
    cell = load_cell(args.workload, ROOT)
    cfg, mix = cell.config, cell.traffic
    device = cfg.get("device", "cuda")
    params = make_params(cfg["model"], args.seed, device)
    if args.traffic is not None:
        mix = json.loads((ROOT / "echo_bench" / "traffic" / f"{args.traffic}.json").read_text())
    if args.docs is not None:
        mix = dict(mix, offline=dict(mix["offline"], docs=args.docs))
    slo = mix["slo"]
    for rate in (float(r) for r in args.rates.split(",")):
        sess = Session(cfg, mix, params, args.seed, args.seconds, device, trace=False,
                       rate_per_s=rate, iterations=True)
        res = sess.run(until_done=True)
        window = (res["start"], res["end"])
        times = sess.listener.times
        met = n = 0
        ttft, tpots = [], []
        for r, d in zip(res["online"], res["due"]):
            if not window[0] <= d < window[1]:
                continue
            n += 1
            ts = times.get(r.rid)
            if not ts:
                continue
            t1 = ts[0] - d
            tp = (ts[-1] - ts[0]) / (len(ts) - 1) if len(ts) > 1 else 0.0
            ttft.append(t1)
            tpots.append(tp)
            met += t1 <= slo["ttft_s"] and tp <= slo["tpot_s"]
        itl = stats.itls(times, window)
        waits = [w for _, w in sess.rec.iterations]
        row = dict(rate=rate, traffic=args.traffic, docs=mix["offline"]["docs"], due=n,
                   sched_ms=1e3 * sum(waits) / max(len(waits), 1), met_pct=100.0 * met / max(n, 1),
                   ttft_ok_pct=100.0 * sum(t <= slo["ttft_s"] for t in ttft) / max(n, 1),
                   tpot_ok_pct=100.0 * sum(t <= slo["tpot_s"] for t in tpots) / max(n, 1),
                   queue=res["queue"],
                   offline_tok_s=stats.rate(res["offline_progress"], window),
                   ttft_p95_ms=1e3 * stats.quantile(ttft, 0.95) if ttft else None,
                   itl_p50_ms=1e3 * stats.quantile(itl, 0.5) if itl else None,
                   itl_p95_ms=1e3 * stats.quantile(itl, 0.95) if itl else None,
                   tpot_p50_ms=1e3 * stats.quantile(tpots, 0.5) if tpots else None,
                   backlog_left_pct=100.0 * res["backlog_tokens"][0] / res["backlog_tokens"][1])
        print(json.dumps(row), flush=True)
        sess.close()
        del sess
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[2] / "src"),
                    str(Path(__file__).resolve().parents[2])]
    main()
