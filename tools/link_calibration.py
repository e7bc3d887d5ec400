#!/usr/bin/env python3
"""How steady the port's cold-start link calibration is on a card.

Runs ``repro_torch.rt.calibrate_link`` N times on a fresh ``TimeModel.h100()``
each (as ``serve --serve`` and ``chip_smoke.py`` phase 23 do once) and prints
each outcome: applied or skipped, the fitted rate, floor and launch terms,
and the samples the fit used. It ends with the count of applied fits and
their range of rates.

    PYTHONPATH=src python3 tools/link_calibration.py 20
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", type=int, nargs="?", default=20)
    args = ap.parse_args()
    import torch

    from repro_torch.core.estimator import TimeModel
    from repro_torch.rt.calibrate import calibrate_link
    if not torch.cuda.is_available():
        sys.exit("link_calibration: no CUDA device")
    rates = []
    for i in range(args.runs):
        cal = calibrate_link(TimeModel.h100(), device="cuda")
        print(f"{i:2d} {cal.summary()}; samples (KiB, us): "
              + ", ".join(f"{n >> 10} {t * 1e6:.0f}" for n, t in cal.samples), flush=True)
        if cal.applied:
            rates.append(cal.bandwidth_gbs)
    print(f"{len(rates)} of {args.runs} applied"
          + (f", {min(rates):.2f}-{max(rates):.2f} GB/s" if rates else ""))


if __name__ == "__main__":
    main()
