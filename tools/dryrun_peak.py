#!/usr/bin/env python3
"""What is live at the peak of one dry-run step: rank 0's storages at the
moment ``RankCounter`` read its peak, grouped by the op that made each, its
first output's shape and the port's Python frames that called it (frames
are kept for storages of ``--min-mb`` and more).

The step is ``repro_torch.launch.dryrun.measure``'s, on ``meta`` tensors
over a ``fake`` process group, so nothing is allocated: a full-width
config traces on the host of a card in seconds. Run from the repository
root:

    python3 tools/dryrun_peak.py qwen3-4b train 4096 256 [--mesh pod16x16]
    python3 tools/dryrun_peak.py mamba2-1.3b prefill 128 1 --mesh 1x1 --min-mb 0.5

ARCH KIND SEQ BATCH: the config, the step kind (train, prefill, decode),
the sequence length and the global batch; ``--mesh`` pod16x16 (default),
pod2x16x16 or 1x1; ``--reduced`` traces the ``.reduced()`` config.
"""
from __future__ import annotations

import argparse
import collections
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402

MESHES = {"pod16x16": 256, "pod2x16x16": 512, "1x1": 1}


class PeakCounter(dryrun.RankCounter):
    """``RankCounter`` that remembers where each counted storage came from
    and which storages were live, and from where, when the peak last rose
    (a storage's key may be reused once it dies)."""

    min_bytes = 16 << 20

    def __init__(self):
        super().__init__()
        self.op = None
        self.origin = {}
        self.at_peak = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        outer, self.op = self.op, str(func)
        try:
            return super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self.op = outer

    def _track(self, out) -> None:
        if self._sizes is None:
            return
        before, peak = set(self._sizes), self.peak
        super()._track(out)
        for key in set(self._sizes) - before:
            frames = ""
            if self._sizes[key] >= self.min_bytes:
                frames = " < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                    for f in reversed(traceback.extract_stack())
                                    if "repro_torch" in f.filename
                                    and "dryrun" not in f.filename)
            shape = next((tuple(t.shape) for t in dryrun._tensors(out)), ())
            self.origin[key] = (self.op, shape, frames[:300])
        if self.peak > peak:
            self.at_peak = {k: (n, self.origin[k]) for k, n in self._sizes.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", choices=ARCH_IDS)
    ap.add_argument("kind", choices=("train", "prefill", "decode"))
    ap.add_argument("seq", type=int)
    ap.add_argument("batch", type=int)
    ap.add_argument("--mesh", choices=tuple(MESHES), default="pod16x16")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--min-mb", type=float, default=16.0)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    PeakCounter.min_bytes = int(args.min_mb * 2**20)
    counters = []
    dryrun.RankCounter = lambda: counters.append(PeakCounter()) or counters[-1]
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if args.reduced else cfg
    with dryrun.fake_world(MESHES[args.mesh]):
        mesh = (make_mesh((1, 1), ("data", "model"), device_type="cpu") if args.mesh == "1x1"
                else make_production_mesh(multi_pod=args.mesh == "pod2x16x16",
                                          device_type="cpu"))
        m = dryrun.measure(cfg, InputShape(args.kind, args.seq, args.batch, args.kind), mesh)
    counter = counters[-1]
    print(f"{cfg.name} {args.kind} S {args.seq} B {args.batch} on {args.mesh}: arguments "
          f"{m['argument_bytes']:,} B, temp_bytes {m['temp_bytes']:,} B, output_bytes "
          f"{m['output_bytes']:,} B")
    total, count = collections.Counter(), collections.Counter()
    for n, origin in counter.at_peak.values():
        total[origin] += n
        count[origin] += 1
    for (op, shape, frames), n in total.most_common(args.top):
        print(f"  {n / 1e6:12.3f} MB x{count[op, shape, frames]:4d} {op} {shape} {frames}")


if __name__ == "__main__":
    main()
