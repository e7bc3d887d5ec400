#!/usr/bin/env python3
"""How often a ``torch.profiler`` trace on the card lacks device records.

Traces recurrentgemma-9b's bf16 ``Model.prefill`` at full width (seeded
random weights) again and again with ``chip_smoke._trace``, at S 3072 and
S 128, once with no primer and once with ``chip_smoke.PRIMER_LAUNCHES``
small launches ahead of the step. For each trace it prints how many device
records the trace lacks of the step's launches, copies and memsets and of
the primer's, and the RG-LRU kernel's launches in the step's records beside
the wrapper's count; then, for each S and primer, how many traces lacked
records of the step, of the primer, and how many were short of an RG-LRU
launch.

Run from the repository root on a machine with one CUDA card:

    python3 tools/profile_drops.py [--long 30] [--short 100]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--long", type=int, default=30, help="traces at S 3072, per primer")
    ap.add_argument("--short", type=int, default=100, help="traces at S 128, per primer")
    args = ap.parse_args()
    cs.phase_device()
    cs.phase_build()
    cfg = get_config("recurrentgemma-9b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cs.DEV).manual_seed(0))
    gen = torch.Generator(device=cs.DEV).manual_seed(1)
    for s, reps in ((3072, args.long), (128, args.short)):
        toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=cs.DEV)

        def fn():
            with torch.inference_mode():
                return model.prefill(params, toks)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for primer in (0, cs.PRIMER_LAUNCHES):
            lacking, primer_lacking, short = 0, 0, 0
            for it in range(reps):
                fn()
                torch.cuda.synchronize()
                before = rglru_scan.launches
                prof, step, dropped, primer_dropped = cs._trace(fn, primer)
                made = rglru_scan.launches - before
                rg = sum(1 for e in prof.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA
                         and e.correlation_id() in step and cs.RGLRU_KERNEL in e.name())
                lacking += dropped > 0
                primer_lacking += primer_dropped > 0
                short += rg < made
                print(f"S {s} primer {primer} trace {it}: lacks {dropped} of the step's "
                      f"{len(step)} device records, {primer_dropped} of the primer's; "
                      f"{cs.RGLRU_KERNEL} {rg} in the step's records, {made} by the "
                      f"wrapper", flush=True)
            print(f"S {s} primer {primer}: {reps} traces; {lacking} lack records of the "
                  f"step, {primer_lacking} of the primer; {short} short of an RG-LRU "
                  f"launch", flush=True)


if __name__ == "__main__":
    main()
