#!/usr/bin/env python3
"""Readings for a cell's correctness limit, many seeds in one process.

For each seed: the seed's weights and traffic, a run of the cell at its own
load with a short window (``--seconds``), the sample ``run.py`` draws, and
the widest reference-logit gap of the served tokens (the lower reading);
with ``--control`` also the gap of the tokens the fp8 reference
(``reference.py``, ``quant="fp8"``) puts first at the same positions (the
control, which has to read above the limit). One JSON line a seed.

    python3 echo_bench/tools/readings.py --workload yi-9b.docqa --seeds 1,2,3 --control
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def reading(cell, seed: int, seconds: float, control: bool) -> dict:
    import torch
    from echo_bench import judge
    from echo_bench.serve import Session
    from echo_bench.weights import make_params
    cfg, device = cell.config, cell.config.get("device", "cuda")
    params = make_params(cfg["model"], seed, device)
    sess = Session(cfg, cell.traffic, params, seed, seconds, device, trace=False)
    sess.run()
    sample = judge.draw(sess.engine.stats.finished, sess.first_ctx, sess.chunks, seed,
                        cell.limits["sample"])
    sess.close()
    del sess
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v = judge.judge(cfg["model"], params, sample, control=control)
    return dict(seed=seed, max_logit_gap=v.max_gap, control_gap=v.control_gap,
                served=v.served, requests=v.requests, hit=v.hit, multi=v.multi,
                sample=[(s.why, len(s.prompt), len(s.served)) for s in sample],
                reference_s=time.perf_counter() - t0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    from echo_bench.run import ROOT, _setup_paths
    from echo_bench.spec import load_cell
    _setup_paths()
    cell = load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(reading(cell, seed, args.seconds, args.control)), flush=True)


if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[2] / "src"),
                    str(Path(__file__).resolve().parents[2])]
    main()
