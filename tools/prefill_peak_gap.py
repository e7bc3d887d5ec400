#!/usr/bin/env python3
"""Where ``chip_smoke.py`` phase 31's prefill peak on the card differs from
the dry run's count of the same step.

Full-width mamba2-1.3b (seeded random weights) on a (data 1, model 1)
``DeviceMesh`` over an NCCL group of one rank prefills a 128-token prompt
twice under the caching allocator's history
(``torch.cuda.memory._record_memory_history``). For each run it prints
``max_memory_allocated`` past the bytes allocated at the start; then, from
the second run's history, the allocations live when their sum peaked,
grouped by the port's frames; then ``tools/dryrun_peak.py``'s breakdown of
the dry run's count of the same step (a subprocess: it opens its own
``fake`` group).

Run from the repository root on a machine with one CUDA card:

    python3 tools/prefill_peak_gap.py
"""
from __future__ import annotations

import collections
import gc
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402

PROMPT = 128


def live_at_peak(snapshot):
    """(most bytes live past the start, {address: event} live then) from
    the history's allocations and frees, in order."""
    live, cur, best, best_live = {}, 0, 0, {}
    for e in (e for trace in snapshot["device_traces"] for e in trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > best:
                best, best_live = cur, dict(live)
        elif e["action"] == "free_requested" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
    return best, best_live


def main() -> None:
    cfg = get_config("mamba2-1.3b")
    model = Model(cfg)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        params = sharding.param_shardings(
            model.init(torch.Generator(device="cuda").manual_seed(0)), mesh)
        prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT), device="cuda")
        _, pl = sharding.input_specs(cfg, InputShape("p", PROMPT, 1, "prefill"), mesh)
        tokens = sharding.distribute({"tokens": prompt}, pl, mesh)["tokens"]
        for run in range(2):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            torch.cuda.memory._record_memory_history(max_entries=200_000)
            with torch.no_grad(), sharding.on_mesh(mesh):
                out = model.prefill(params, tokens)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            snapshot = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            del out
            print(f"run {run}: max_memory_allocated {peak:,} B, {base:,} B at the start: "
                  f"{peak - base:,} B past it; {torch.cuda.get_device_name(0)}")
        best, live = live_at_peak(snapshot)
        print(f"the history's allocations: at most {best:,} B live past the start")
        total, count = collections.Counter(), collections.Counter()
        for e in live.values():
            frames = " < ".join(f"{Path(f['filename']).name}:{f['line']}"
                                for f in e.get("frames", []) if "repro_torch" in f["filename"])
            total[frames[:260]] += e["size"]
            count[frames[:260]] += 1
        for frames, n in total.most_common(20):
            print(f"  {n / 1e6:12.3f} MB x{count[frames]:4d} {frames}")
    finally:
        dist.destroy_process_group()
    subprocess.run([sys.executable, str(ROOT / "tools" / "dryrun_peak.py"), "mamba2-1.3b",
                    "prefill", str(PROMPT), "1", "--mesh", "1x1", "--min-mb", "0.5"],
                   cwd=ROOT, check=True)


if __name__ == "__main__":
    main()
