"""Cold-start host↔device link calibration: measure, fit, then serve.

The swap terms of the ``TimeModel`` (``swap_byte``/``swap_floor``/
``swap_launch``) price every swap-vs-recompute decision and every SLO
charge for carried transfer traffic, but the presets are nominal link
numbers (PCIe 4.0/5.0 x16). A server should not price a link it never
measured: at startup, ``serve --serve`` times a few real host→device and
device→host copies, fits the byte rate and dispatch floor with
``TimeModel.fit_swap``, and (optionally) overlaps a copy with a matmul on
the card to recover the copy launch overhead via
``TimeModel.fit_swap_overlap``, all before the first request is admitted.

What is timed: pageable copies, ``torch.from_numpy(buf).to(device)`` up
and ``tensor.cpu()`` down, the kind the swap tier performs
(``TorchPagedRunner.stage_payload``/``materialize``, ``StateRunner``'s
the same). The tier stages from pageable host memory, so pinned buffers
would price a link several times faster than the one the engine uses.

No silent fallback: on ``device="cuda"`` a failure to measure raises.
Only ``device="cpu"``, the caller's explicit request, returns
``applied=False``: the CPU has no host↔device link. A degenerate fit (a
byte rate of about zero) is a result, not a failure: it restores the
preset terms and says so.
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import resolve_device

logger = logging.getLogger(__name__)

# modest payloads: enough spread for a 2-term lstsq, small enough that
# startup stays sub-second even over a slow link
DEFAULT_SIZES = (1 << 18, 1 << 20, 1 << 22)      # 256 KiB, 1 MiB, 4 MiB


@dataclass
class LinkCalibration:
    """Outcome of one cold-start calibration run."""
    applied: bool                      # did the fit replace the presets?
    backend: str                       # the card's name, or "cpu"
    swap_byte: float                   # the model's terms after the run
    swap_floor: float
    swap_launch: float
    samples: List[Tuple[int, float]] = field(default_factory=list)
    overlap_samples: List[Tuple[float, int, float]] = \
        field(default_factory=list)
    error: Optional[str] = None

    @property
    def bandwidth_gbs(self) -> Optional[float]:
        """Fitted effective link bandwidth, GB/s."""
        if self.swap_byte <= 0.0:
            return None
        return 1.0 / (self.swap_byte * 1e9)

    def summary(self) -> str:
        if not self.applied:
            return (f"link calibration skipped ({self.error}); "
                    f"keeping preset swap terms")
        bw = self.bandwidth_gbs
        return (f"link calibrated on {self.backend}: "
                f"{bw:.1f} GB/s effective, floor {self.swap_floor*1e6:.0f}us, "
                f"launch {self.swap_launch*1e6:.0f}us "
                f"({len(self.samples)} transfer samples)")


def _upload(buf: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One pageable host→device copy, waited for."""
    out = torch.from_numpy(buf).to(dev)
    torch.cuda.synchronize(dev)
    return out


def measure_link(sizes=DEFAULT_SIZES, repeats: int = 3,
                 device="cuda") -> List[Tuple[int, float]]:
    """Time pageable host→device and device→host copies on ``device`` (a
    CUDA device). Returns ``(n_bytes, seconds)`` samples, both directions
    pooled: the fit recovers one effective link rate."""
    dev = resolve_device(device)
    samples: List[Tuple[int, float]] = []
    for n in sizes:
        buf = np.zeros(n, dtype=np.uint8)
        _upload(buf, dev).cpu()        # one unmeasured round trip: allocator warm-up
        for _ in range(repeats):
            t0 = time.perf_counter()
            on_card = _upload(buf, dev)
            samples.append((n, time.perf_counter() - t0))
            t0 = time.perf_counter()
            on_card.cpu()              # a pageable copy returns when it landed
            samples.append((n, time.perf_counter() - t0))
    return samples


def measure_overlap(tm, sizes=DEFAULT_SIZES, repeats: int = 2,
                    matmul_dim: int = 512,
                    device="cuda") -> List[Tuple[float, int, float]]:
    """Overlap an upload (issued from a helper thread, as the engine's
    ``kv-stage`` worker issues its copies) with a matmul on the card and
    time the pair: ``(compute_s, n_bytes, total_s)`` samples for
    ``fit_swap_overlap``'s max-plus-launch residual."""
    dev = resolve_device(device)
    x = torch.ones((matmul_dim, matmul_dim), dtype=torch.float32, device=dev)

    def step():
        torch.matmul(x, x)
        torch.cuda.synchronize(dev)

    step()                                         # cuBLAS handle, warm-up
    t0 = time.perf_counter()
    step()
    compute_s = time.perf_counter() - t0
    samples: List[Tuple[float, int, float]] = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        for n in sizes:
            buf = np.zeros(n, dtype=np.uint8)
            _upload(buf, dev)                      # warm-up
            for _ in range(repeats):
                t0 = time.perf_counter()
                fut = pool.submit(_upload, buf, dev)
                step()
                fut.result()
                samples.append((compute_s, n, time.perf_counter() - t0))
    return samples


def calibrate_link(tm, *, sizes=DEFAULT_SIZES, repeats: int = 3,
                   overlap: bool = True, device="cuda") -> LinkCalibration:
    """Measure the real link of ``device`` and refit ``tm``'s swap terms in
    place.

    ``device="cpu"`` keeps the presets (there is no link to measure) and
    says so; on ``"cuda"`` any failure to measure raises. A degenerate fit
    (a byte rate of about zero) restores the presets and the returned
    record says why."""
    snapshot = (tm.swap_byte, tm.swap_floor, tm.swap_launch)

    def _skip(reason: str, backend: str) -> LinkCalibration:
        tm.swap_byte, tm.swap_floor, tm.swap_launch = snapshot
        return LinkCalibration(applied=False, backend=backend,
                               swap_byte=tm.swap_byte,
                               swap_floor=tm.swap_floor,
                               swap_launch=tm.swap_launch, error=reason)

    dev = resolve_device(device)
    if dev.type == "cpu":
        return _skip("no host↔device link on the CPU", "cpu")
    backend = torch.cuda.get_device_name(dev)
    samples = measure_link(sizes, repeats, dev)
    if len(samples) < 2:
        raise ValueError(f"calibrate_link needs at least one size and one "
                         f"repeat, got sizes={sizes!r} repeats={repeats}")
    tm.fit_swap(samples)
    # a fitted rate implying > ~1 PB/s is float noise from size-blind
    # timings: nothing real was measured, keep the nominal link pricing
    if tm.swap_byte < 1e-15:
        return _skip("degenerate fit: measured byte rate ~ 0", backend)
    overlap_samples: List[Tuple[float, int, float]] = []
    if overlap:
        overlap_samples = measure_overlap(tm, sizes, device=dev)
        tm.fit_swap_overlap(overlap_samples)
    cal = LinkCalibration(applied=True, backend=backend,
                          swap_byte=tm.swap_byte,
                          swap_floor=tm.swap_floor,
                          swap_launch=tm.swap_launch,
                          samples=samples,
                          overlap_samples=overlap_samples)
    logger.info("%s", cal.summary())
    return cal
