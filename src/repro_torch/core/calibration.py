"""Online calibration of the §5 execution-time estimator.

The paper fits Eq.6-8 once from offline micro-benchmarks; in a live system
the hardware drifts (MIG neighbours, clock throttling, driver upgrades) and
a fleet is heterogeneous, so the estimate must track the *observed* clock.
The ``OnlineCalibrator`` closes that loop: every engine iteration it records
(prefill spans, decode lengths, observed iteration time), maintains a
sliding window of category-separated samples, tracks the EWMA relative
error of the current estimate, and — when drift persists — refits the
coefficients in place through the estimator's own ``fit_prefill`` /
``fit_decode`` / ``fit_lambda`` routines, so the scheduler's very next plan
is scored with the corrected model.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Sequence, Tuple

from repro_torch.core.estimator import TimeModel

Span = Tuple[int, int]


@dataclass
class CalibrationSample:
    """One engine iteration as seen by the calibrator."""
    t: float
    predicted: float
    observed: float

    @property
    def rel_err(self) -> float:
        return abs(self.predicted - self.observed) / max(self.observed, 1e-12)


class OnlineCalibrator:
    """Drift-triggered refitting of a live ``TimeModel``.

    ``tm`` is mutated in place — it is the same object the scheduler scores
    plans with, so a refit takes effect on the next ``schedule`` call.

    Iterations are bucketed by shape so each Eq.6-8 family gets clean
    samples: prefill-only single-span iterations feed ``fit_prefill`` (the
    span form — mid-context chunks carry the quadratic increment), decode-
    only iterations feed ``fit_decode``, and mixed iterations feed
    ``fit_lambda`` with prefill/decode legs re-estimated by the refit model.
    """

    def __init__(self, tm: TimeModel, *, window: int = 256,
                 ewma_alpha: float = 0.1, drift_threshold: float = 0.15,
                 min_samples: int = 24, cooldown: int = 32,
                 history_limit: Optional[int] = 100_000):
        self.tm = tm
        self.window = window
        self.ewma_alpha = ewma_alpha
        self.drift_threshold = drift_threshold
        self.min_samples = min_samples
        self.cooldown = cooldown

        self._prefill: Deque[Tuple[Span, float]] = deque(maxlen=window)
        self._decode: Deque[Tuple[int, float, float]] = deque(maxlen=window)
        self._mixed: Deque[Tuple[List[Span], List[int], float]] = \
            deque(maxlen=window)
        # swap staging observations: (bytes, seconds) for the PCIe terms,
        # (compute, bytes, total) for the overlap launch overhead — byte-
        # denominated so KV-page and state-snapshot transfers share one pool
        self._swap: Deque[Tuple[int, float]] = deque(maxlen=window)
        self._overlap: Deque[Tuple[float, int, float]] = deque(maxlen=window)
        # inter-node migration observations: (bytes, seconds) for the fabric
        # terms — same byte-denominated shape as the swap pool
        self._migrate: Deque[Tuple[int, float]] = deque(maxlen=window)

        self.ewma_err: Optional[float] = None
        self.ewma_swap_err: Optional[float] = None
        self.ewma_migrate_err: Optional[float] = None
        self.n_observed = 0
        self.n_swap_observed = 0
        self.n_migrate_observed = 0
        self.refits = 0
        self.swap_refits = 0
        self.migrate_refits = 0
        self._since_refit = 0
        self._since_swap_refit = 0
        self._since_migrate_refit = 0
        # bounded so a long-running server cannot grow without limit; the
        # default keeps every benchmark-length run intact
        self.history: Deque[CalibrationSample] = deque(maxlen=history_limit)
        # observability tap: called with ("iter"|"swap", rel_err) per sample
        # so drift probes can histogram residuals live instead of scraping
        # `history` after the run (repro.obs.probes sets this)
        self.on_residual: Optional[Callable[[str, float], None]] = None

    @classmethod
    def passive(cls, tm: TimeModel, **kw) -> "OnlineCalibrator":
        """Measure estimate-vs-clock error but never refit — the static
        baseline of calibration studies."""
        return cls(tm, drift_threshold=float("inf"), **kw)

    # ------------------------------------------------------------- observe
    def observe(self, now: float, prefill_spans: Sequence[Span],
                decode_lens: Sequence[int], observed: float) -> float:
        """Record one iteration; refit on sustained drift. Returns the
        iteration's relative error under the (pre-refit) estimate."""
        spans = [tuple(s) for s in prefill_spans]
        lens = list(decode_lens)
        predicted = self.tm.batch_time(spans, lens)
        sample = CalibrationSample(now, predicted, observed)
        self.history.append(sample)
        self.n_observed += 1
        self._since_refit += 1

        rel = sample.rel_err
        if self.ewma_err is None:
            self.ewma_err = rel
        else:
            self.ewma_err += self.ewma_alpha * (rel - self.ewma_err)

        if spans and not lens:
            if len(spans) == 1:          # unambiguous Eq.6 sample
                self._prefill.append((spans[0], observed))
        elif lens and not spans:
            self._decode.append((max(lens), float(sum(lens)) / len(lens),
                                 observed))
        elif spans and lens:
            self._mixed.append((spans, lens, observed))

        if self.on_residual is not None:
            self.on_residual("iter", rel)
        if self.drifting():
            self.refit()
        return rel

    def observe_swap(self, n_bytes: int, observed: float) -> float:
        """Record one staging transfer of ``n_bytes`` of block payload
        (ROADMAP open item: the swap terms were static after ``fit_swap``
        while the compute terms refit). On the wall path ``observed`` is the
        copy worker's measured staging seconds; on the virtual path the
        ground-truth clock's transfer leg. Refits the PCIe terms in place on
        sustained drift. Returns the transfer's relative error under the
        (pre-refit) estimate."""
        if n_bytes <= 0:
            return 0.0
        predicted = self.tm.swap_time(n_bytes)
        rel = abs(predicted - observed) / max(observed, 1e-12)
        if self.ewma_swap_err is None:
            self.ewma_swap_err = rel
        else:
            self.ewma_swap_err += self.ewma_alpha * (rel - self.ewma_swap_err)
        self._swap.append((n_bytes, observed))
        self.n_swap_observed += 1
        self._since_swap_refit += 1
        if self.on_residual is not None:
            self.on_residual("swap", rel)
        if self.swap_drifting():
            self.refit_swap()
        return rel

    def observe_migration(self, n_bytes: int, observed: float) -> float:
        """Record one replica->replica prefix shipment of ``n_bytes`` —
        the fabric analogue of ``observe_swap``. On the virtual path
        ``observed`` is the ground-truth clock's migration leg. Refits the
        ``migrate_byte``/``migrate_floor`` terms in place on sustained
        drift. Returns the shipment's relative error under the (pre-refit)
        estimate."""
        if n_bytes <= 0:
            return 0.0
        predicted = self.tm.migrate_time(n_bytes)
        rel = abs(predicted - observed) / max(observed, 1e-12)
        if self.ewma_migrate_err is None:
            self.ewma_migrate_err = rel
        else:
            self.ewma_migrate_err += \
                self.ewma_alpha * (rel - self.ewma_migrate_err)
        self._migrate.append((n_bytes, observed))
        self.n_migrate_observed += 1
        self._since_migrate_refit += 1
        if self.on_residual is not None:
            self.on_residual("migrate", rel)
        if self.migrate_drifting():
            self.refit_migration()
        return rel

    def observe_overlap(self, compute: float, n_bytes: int,
                        total: float) -> None:
        """Record one overlapped iteration (compute, transfer bytes, total
        observed time) — the sample family that refits the async launch
        overhead (``fit_swap_overlap``) alongside the PCIe terms."""
        if n_bytes > 0:
            self._overlap.append((compute, n_bytes, total))

    def drifting(self) -> bool:
        return (self.ewma_err is not None
                and self.ewma_err > self.drift_threshold
                and self._since_refit >= self.cooldown
                and self.n_observed >= self.min_samples
                and (len(self._prefill) >= 3 or len(self._decode) >= 3
                     or len(self._mixed) >= 3))

    def swap_drifting(self) -> bool:
        return (self.ewma_swap_err is not None
                and self.ewma_swap_err > self.drift_threshold
                and self._since_swap_refit >= self.cooldown
                and len(self._swap) >= max(self.min_samples // 3, 2))

    def migrate_drifting(self) -> bool:
        return (self.ewma_migrate_err is not None
                and self.ewma_migrate_err > self.drift_threshold
                and self._since_migrate_refit >= self.cooldown
                and len(self._migrate) >= max(self.min_samples // 3, 2))

    # ------------------------------------------------------------- refit
    def _pseudo_prefill(self) -> List[Tuple[Span, float]]:
        """Prefill observations recovered from mixed iterations.

        A busy engine rarely runs prefill-only iterations, so Eq.6 would
        starve on clean samples. For mixed iterations with a single prefill
        chunk, invert Eq.8 around the decode leg (just refit from decode-only
        iterations): whichever branch of max/min the prefill leg lands on,
        solve for it and keep the solution consistent with that branch."""
        out: List[Tuple[Span, float]] = []
        lam = min(max(self.tm.lam, 0.05), 0.95)
        for spans, lens, t in self._mixed:
            if len(spans) != 1:
                continue
            td = self.tm.decode_time(lens)
            tp_hi = (t - (1.0 - lam) * td) / lam       # prefill is the max
            tp_lo = (t - lam * td) / (1.0 - lam)       # prefill is the min
            if tp_hi >= td > 0.0:
                out.append((spans[0], tp_hi))
            elif 0.0 < tp_lo <= td:
                out.append((spans[0], tp_lo))
        return out

    def _scale_correction(self) -> None:
        """Remove residual systematic bias: every Eq.6-8 time coefficient is
        multiplied by the median observed/predicted ratio over the window
        (lambda is unitless and stays). Exact for pure scale drift; a strict
        bias reduction when the categorized fits leave a common-mode error."""
        ratios = []
        for span, t in self._prefill:
            ratios.append(t / max(self.tm.prefill_time([span]), 1e-12))
        for mx, mn, t in self._decode:
            pred = max(self.tm.gamma * mx + self.tm.delta * mn, self.tm.d0)
            ratios.append(t / max(pred, 1e-12))
        for spans, lens, t in self._mixed:
            ratios.append(t / max(self.tm.batch_time(spans, lens), 1e-12))
        if len(ratios) < 3:
            return
        ratios.sort()
        s = ratios[len(ratios) // 2]
        s = min(max(s, 0.1), 10.0)
        for f in ("alpha", "beta", "c", "gamma", "delta", "d0"):
            setattr(self.tm, f, getattr(self.tm, f) * s)

    def refit(self) -> None:
        """Refit every coefficient family with enough window samples.
        Order matters: decode first (clean decode-only samples), then
        prefill (clean + pseudo samples recovered via the new decode leg),
        then lambda with both refit legs."""
        if len(self._decode) >= 3:
            self.tm.fit_decode(list(self._decode))
        # prefill and lambda are coupled through the Eq.8 inversion, so
        # alternate them a few rounds (coordinate descent) per refit
        for _ in range(3):
            prefill = list(self._prefill) + self._pseudo_prefill()
            if len(prefill) >= 3:
                self.tm.fit_prefill(prefill)
            if self._mixed:
                legs = [(self.tm.prefill_time(spans),
                         self.tm.decode_time(lens), t)
                        for spans, lens, t in self._mixed]
                self.tm.fit_lambda(legs)
            if not self._mixed:
                break
        self._scale_correction()
        self.refits += 1
        self._since_refit = 0
        self.ewma_err = None             # measure the refit model afresh
        # age out the pre-drift regime: a refit fires after >= cooldown
        # drifted iterations, so the trailing ``cooldown`` samples of each
        # bucket describe the new hardware; older ones would bias the next
        # fit toward hardware that no longer exists
        for bucket in (self._prefill, self._decode, self._mixed):
            while len(bucket) > self.cooldown:
                bucket.popleft()

    def refit_swap(self) -> None:
        """Refit the PCIe transfer terms (and, given overlap samples, the
        launch overhead) from the observed staging times, through the
        estimator's own fitting routines — the swap analogue of ``refit``."""
        if len(self._swap) >= 2:
            self.tm.fit_swap(list(self._swap))
        if len(self._overlap) >= 2 and self.tm.swap_overlap:
            self.tm.fit_swap_overlap(list(self._overlap))
        self.swap_refits += 1
        self._since_swap_refit = 0
        self.ewma_swap_err = None        # measure the refit terms afresh
        for bucket in (self._swap, self._overlap):
            while len(bucket) > self.cooldown:
                bucket.popleft()

    def refit_migration(self) -> None:
        """Refit the inter-node fabric terms from observed shipment times —
        the migration analogue of ``refit_swap``."""
        if len(self._migrate) >= 2:
            self.tm.fit_migrate(list(self._migrate))
        self.migrate_refits += 1
        self._since_migrate_refit = 0
        self.ewma_migrate_err = None     # measure the refit terms afresh
        while len(self._migrate) > self.cooldown:
            self._migrate.popleft()

    # ------------------------------------------------------------- metrics
    def mean_rel_err(self, last_n: Optional[int] = None) -> float:
        hist = list(self.history)
        if last_n:
            hist = hist[-last_n:]
        if not hist:
            return 0.0
        return sum(s.rel_err for s in hist) / len(hist)

    def convergence_curve(self, every: int = 50) -> List[Tuple[int, float]]:
        """(iteration, mean rel err of the trailing ``every`` iterations) —
        the benchmark's view of how fast calibration converges. Iteration
        numbers are global (offset survives history truncation)."""
        hist = list(self.history)
        start = self.n_observed - len(hist)
        out = []
        for end in range(every, len(hist) + 1, every):
            chunk = hist[end - every:end]
            out.append((start + end,
                        sum(s.rel_err for s in chunk) / len(chunk)))
        return out
