#!/usr/bin/env python3
"""Attention kernel times of one checkout, for comparing two checkouts on
one card within one call.

Imports ``repro_torch`` and ``chip_smoke`` from ``--root`` (a checkout of
this repository; the current one by default) and times, with
``chip_smoke.time_ms`` (median of 30 launches between CUDA events, L2
flushed), split-K and legacy decode and the chunked prefill at phase 4's
shapes: qwen3-4b's (Hq 32, Hkv 8, hd 128, bf16) decode at B 8 over fixed
contexts near 100 and at long context (B 2, 8192 and 5000 over 512-page
tables), its prefill (Sc 64 against T 512, ctx 448); then the same at
granite-34b's MQA (Hq 48, Hkv 1), where a checkout whose kernels refuse
that group records the error instead. Prints the card's name and power
limit and one JSON line of ms by shape and kernel.

Run from the repository root on a machine with one CUDA card, alternating
the checkouts (parent, change, change, parent):

    for r in build/parent . . build/parent; do python3 tools/attn_ab.py --root $r; done
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SERVE_CTX = [100, 87, 120, 95, 101, 81, 116, 110]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_splitk

    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    bf16 = torch.bfloat16
    times = {}
    for label, hq, hkv in (("qwen3-4b", cs.HQ, cs.HKV), ("granite-34b", 48, 1)):
        for shape, b, ctx, nblk in (("B 8", 8, SERVE_CTX, cs.MAX_PAGES),
                                    ("long", 2, cs.LONG_CTX, cs.LONG_NBLK)):
            ins = cs.decode_inputs(gen, b, hq, hkv, cs.HD, cs.BS, nblk, ctx, bf16,
                                   cs.NUM_BLOCKS)
            for name, fn in (("splitk", paged_attention_splitk),
                             ("legacy", paged_attention)):
                key = f"{label} decode {shape} {name}"
                try:
                    times[key] = cs.time_ms(lambda: fn(*ins))
                except ValueError as e:
                    times[key] = f"raises: {e}"
        ins = cs.prefill_inputs(gen, cs.CHUNK, cs.MAX_PAGES * cs.BS, hq, hkv, cs.HD, bf16)
        times[f"{label} prefill"] = cs.time_ms(lambda: chunked_prefill_attention(*ins, 448))
    print(cs._smi())
    print(json.dumps({"root": str(root), "ms": times}))


if __name__ == "__main__":
    main()
