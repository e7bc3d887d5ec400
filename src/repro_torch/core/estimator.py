"""Echo estimation toolkits (§5): execution-time model, memory predictor,
online-trace rate predictor.

Time model (Eq. 6-8):
    T_prefill(l)  = max(alpha * l^2 + beta * l, c)
    T_decode(L)   = gamma * max(L) + delta * mean(L)
    T_batch       = lam * max(Tp, Td) + (1 - lam) * min(Tp, Td)

Coefficients are fit from micro-benchmark samples with non-negative least
squares (simple projected lstsq). For SSM/RG-LRU families prefill cost is
linear: the quadratic basis column is dropped (alpha pinned to 0).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.block_io import (  # noqa: F401  (KV_* kept as re-export)
    KV_BYTES_PER_TOKEN_8B,
    BlockIOSpec,
)


@dataclass
class TimeModel:
    alpha: float = 1e-9      # s / token^2  (prefill quadratic)
    beta: float = 1e-6       # s / token    (prefill linear)
    c: float = 1e-4          # s            (prefill floor)
    gamma: float = 1e-7     # s / token    (decode max-pool)
    delta: float = 1e-7      # s / token    (decode mean-pool)
    d0: float = 1e-4         # s            (decode floor)
    lam: float = 0.8         # prefill/decode overlap coefficient
    swap_byte: float = 0.0   # s / byte     (host<->device payload over PCIe)
    swap_floor: float = 0.0  # s            (per-transfer dispatch floor)
    swap_launch: float = 0.0  # s           (async copy launch/fence overhead)
    swap_overlap: bool = True  # overlap PCIe transfers with compute (Eq.9)
    migrate_byte: float = 0.0   # s / byte  (replica->replica over the fabric)
    migrate_floor: float = 0.0  # s         (per-migration connection setup)
    quadratic_prefill: bool = True

    @classmethod
    def a100(cls, **overrides) -> "TimeModel":
        """Coefficients of LLaMA-3.1-8B-instruct magnitude on one A100-40G,
        structured per Eq.6-8 — the shared default for virtual-clock serving,
        cluster simulation, benchmarks, and examples. Swap terms price PCIe
        4.0 x16 (~25 GB/s effective); what a block *weighs* comes from the
        runner family's ``BlockIOSpec``, not from the link model."""
        kw = dict(alpha=2e-7, beta=1e-4, c=2e-3, gamma=3e-5, delta=3e-5,
                  d0=2e-3, lam=0.9,
                  swap_byte=cls.pcie_swap_byte(25.0), swap_floor=1e-4,
                  swap_launch=5e-5,
                  migrate_byte=cls.pcie_swap_byte(10.0), migrate_floor=2e-4)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def h100(cls, **overrides) -> "TimeModel":
        """H100-80G magnitude: ~2.5x the A100 FLOPs and ~1.7x its HBM
        bandwidth, so the quadratic attention term shrinks more than the
        bandwidth-bound decode terms; floors shrink with faster dispatch.
        PCIe 5.0 x16 doubles the swap bandwidth (~50 GB/s effective)."""
        kw = dict(alpha=8e-8, beta=4e-5, c=1e-3, gamma=1.8e-5, delta=1.8e-5,
                  d0=1.2e-3, lam=0.92,
                  swap_byte=cls.pcie_swap_byte(50.0), swap_floor=5e-5,
                  swap_launch=2e-5,
                  migrate_byte=cls.pcie_swap_byte(25.0), migrate_floor=1e-4)
        kw.update(overrides)
        return cls(**kw)

    @staticmethod
    def pcie_swap_byte(pcie_gbps: float) -> float:
        """Per-byte host<->device transfer seconds from link bandwidth."""
        return 1.0 / (pcie_gbps * 1e9)

    HW_PROFILES = ("a100", "h100")

    @classmethod
    def preset(cls, name: str, **overrides) -> "TimeModel":
        if name not in cls.HW_PROFILES:
            raise ValueError(f"unknown hardware profile {name!r}; "
                             f"expected one of {cls.HW_PROFILES}")
        return getattr(cls, name)(**overrides)

    def perturbed(self, scale: float = 1.0, jitter: float = 0.0,
                  contention_prob: float = 0.0, contention_scale: float = 2.0,
                  seed: int = 0) -> "PerturbedTimeModel":
        """Ground-truth wrapper: this model's Eq.6-8 structure, scaled by a
        systematic miscalibration ``scale`` plus seeded per-iteration noise."""
        return PerturbedTimeModel(base=self, scale=scale, jitter=jitter,
                                  contention_prob=contention_prob,
                                  contention_scale=contention_scale, seed=seed)

    # ------------------------------------------------------------ queries
    def prefill_time(self, spans: Sequence[Tuple[int, int]]) -> float:
        """Prefill chunks are processed one by one (§5.2).

        Each span (s, e) is the token range computed this iteration; the
        quadratic attention term for a chunk of a longer context is the
        increment alpha*(e^2 - s^2), consistent with Eq.6 for (0, l).
        """
        t = 0.0
        for s, e in spans:
            t += max(self.alpha * (e * e - s * s) + self.beta * (e - s), self.c)
        return t

    def decode_time(self, lens: Sequence[int]) -> float:
        if len(lens) == 0:
            return 0.0
        return max(self.gamma * max(lens) + self.delta * float(np.mean(lens)),
                   self.d0)

    def batch_time(self, prefill_spans: Sequence[Tuple[int, int]],
                   decode_lens: Sequence[int]) -> float:
        tp = self.prefill_time(prefill_spans) if prefill_spans else 0.0
        td = self.decode_time(decode_lens) if decode_lens else 0.0
        if tp == 0.0 or td == 0.0:
            return tp + td
        return self.lam * max(tp, td) + (1.0 - self.lam) * min(tp, td)

    def swap_time(self, n_bytes: int) -> float:
        """Host<->device transfer time for ``n_bytes`` of block payload over
        PCIe — the cost side of the swap-in-vs-recompute decision, and the
        term charged against the SLO budget when a plan carries swap traffic.
        Callers convert blocks to bytes through the runner family's
        ``BlockIOSpec`` so paged KV pages and fixed-size state snapshots are
        charged by what they actually move."""
        if n_bytes <= 0:
            return 0.0
        return self.swap_byte * n_bytes + self.swap_floor

    def migrate_time(self, n_bytes: int) -> float:
        """Replica-to-replica transfer time for ``n_bytes`` of parked prefix
        payload over the inter-node fabric — the price of shipping a host-tier
        block to the replica the router steals toward, instead of recomputing
        the prefix there. Typically slower per byte than the local PCIe hop
        (``swap_byte``) and with a higher connection-setup floor."""
        if n_bytes <= 0:
            return 0.0
        return self.migrate_byte * n_bytes + self.migrate_floor

    def swap_equiv_tokens(self, n_bytes: int, trips: int = 2) -> float:
        """A swap expressed in recompute-token units (Eq.4's benefit and
        punishment are token-denominated): transfer seconds divided by the
        linear prefill cost per token. Defaults to the full round trip
        (``trips=2``, out now + in later) — what evicting a future-needed
        block to the host tier costs instead of its recompute."""
        return trips * self.swap_time(n_bytes) / max(self.beta, 1e-12)

    def overlapped_iteration_time(self, compute: float,
                                  transfer: float) -> float:
        """Iteration time when PCIe transfers run on an async copy stream:
        ``max(compute, transfer)`` plus the launch/fence overhead of kicking
        the stream, instead of the serial ``compute + transfer``. With
        ``swap_overlap=False`` this degrades to the serial charge exactly
        (the pre-overlap clock)."""
        if transfer <= 0.0:
            return compute
        if not self.swap_overlap:
            return compute + transfer
        return max(compute, transfer) + self.swap_launch

    def exposed_swap_time(self, compute: float, transfer: float) -> float:
        """The transfer tail NOT hidden under compute — the only part of the
        PCIe traffic that counts against the SLO budget under overlap."""
        return self.overlapped_iteration_time(compute, transfer) - compute

    # ------------------------------------------------------------ fitting
    def fit_prefill(self, samples: Sequence[Tuple]) -> None:
        """samples: (prompt_len, seconds) for single-prefill iterations, or
        ((start, end), seconds) for mid-context chunks — the quadratic basis
        of a span (s, e) is its attention increment e^2 - s^2 (see
        ``prefill_time``), so both forms fit the same Eq.6 coefficients.

        Fit with an intercept column: on hosts where small-prefill cost is
        dominated by a dispatch floor (flat timings), an intercept-free
        quadratic fit extrapolates garbage; Eq.6's `c` absorbs the floor."""
        if len(samples) < 3:
            return
        spans = [(0, x) if np.isscalar(x) else tuple(x)
                 for x, _ in samples]
        quad = np.array([e * e - s * s for s, e in spans], np.float64)
        ls = np.array([e - s for s, e in spans], np.float64)
        ts = np.array([t for _, t in samples], np.float64)
        ones = np.ones_like(ls)
        if self.quadratic_prefill:
            basis = np.stack([quad, ls, ones], axis=1)
        else:
            basis = np.stack([ls, ones], axis=1)
        coef, *_ = np.linalg.lstsq(basis, ts, rcond=None)
        coef = np.maximum(coef, 0.0)
        if self.quadratic_prefill:
            self.alpha, self.beta, c = map(float, coef)
        else:
            self.alpha = 0.0
            self.beta, c = map(float, coef)
        self.c = float(max(min(np.min(ts), max(c, 1e-6)), 1e-6))

    def fit_decode(self, samples: Sequence[Tuple[int, float, float]]) -> None:
        """samples: (max_len, mean_len, seconds) for decode-only batches."""
        if len(samples) < 3:
            return
        mx = np.array([s[0] for s in samples], np.float64)
        mn = np.array([s[1] for s in samples], np.float64)
        ts = np.array([s[2] for s in samples], np.float64)
        basis = np.stack([mx, mn, np.ones_like(mx)], axis=1)   # + floor
        coef, *_ = np.linalg.lstsq(basis, ts, rcond=None)
        coef = np.maximum(coef, 0.0)
        self.gamma, self.delta = float(coef[0]), float(coef[1])
        self.d0 = float(max(min(np.min(ts), max(float(coef[2]), 1e-6)), 1e-6))

    def fit_swap(self, samples: Sequence[Tuple[int, float]]) -> None:
        """samples: (n_bytes, seconds) for host<->device block transfers —
        micro-benchmarked like Eq.6-8 (calibration support for the PCIe
        terms; a fit on real host<->device copy timings replaces the link
        presets). Byte-denominated, so KV-page and state-snapshot payloads
        land in one pool and jointly recover the link rate."""
        if len(samples) < 2:
            return
        ns = np.array([s[0] for s in samples], np.float64)
        ts = np.array([s[1] for s in samples], np.float64)
        basis = np.stack([ns, np.ones_like(ns)], axis=1)
        coef, *_ = np.linalg.lstsq(basis, ts, rcond=None)
        coef = np.maximum(coef, 0.0)
        self.swap_byte = float(coef[0])
        self.swap_floor = float(max(min(np.min(ts), max(float(coef[1]), 0.0)),
                                    0.0))

    def fit_migrate(self, samples: Sequence[Tuple[int, float]]) -> None:
        """samples: (n_bytes, seconds) for replica->replica prefix shipments —
        the inter-node analogue of ``fit_swap``; recovers the fabric rate and
        the per-migration setup floor from observed timings."""
        if len(samples) < 2:
            return
        ns = np.array([s[0] for s in samples], np.float64)
        ts = np.array([s[1] for s in samples], np.float64)
        basis = np.stack([ns, np.ones_like(ns)], axis=1)
        coef, *_ = np.linalg.lstsq(basis, ts, rcond=None)
        coef = np.maximum(coef, 0.0)
        self.migrate_byte = float(coef[0])
        self.migrate_floor = float(max(min(np.min(ts),
                                           max(float(coef[1]), 0.0)), 0.0))

    def fit_swap_overlap(self, samples: Sequence[Tuple[float, int, float]]) -> None:
        """samples: (compute_seconds, transfer_bytes, total_seconds) for
        iterations that carried overlapped swap traffic. Fits the launch
        overhead as the median residual of the max-model — robust to the odd
        iteration where a fence exposed a partial tail."""
        resid = [t - max(c, self.swap_time(n))
                 for c, n, t in samples if n > 0]
        if len(resid) < 2:
            return
        resid.sort()
        self.swap_launch = float(max(resid[len(resid) // 2], 0.0))

    def fit_lambda(self, samples: Sequence[Tuple[float, float, float]]) -> None:
        """samples: (t_prefill_est, t_decode_est, seconds) for mixed batches."""
        if not samples:
            return
        num, den = 0.0, 0.0
        for tp, td, t in samples:
            hi, lo = max(tp, td), min(tp, td)
            if hi - lo < 1e-12:
                continue
            num += (t - lo) * (hi - lo)
            den += (hi - lo) ** 2
        if den > 0:
            self.lam = float(min(max(num / den, 0.0), 1.5))


@dataclass
class PerturbedTimeModel:
    """Ground-truth execution clock distinct from the scheduler's estimate.

    Wraps a base ``TimeModel`` (the true hardware profile) with a systematic
    miscalibration factor, seeded multiplicative log-normal jitter, and rare
    contention spikes (a neighbour stealing the GPU for one iteration).
    ``batch_time`` is stateful — each call draws fresh noise — so it must
    only clock execution, never score scheduling candidates."""
    base: TimeModel
    scale: float = 1.0              # systematic drift vs. the estimate
    jitter: float = 0.0             # sigma of per-iteration log-normal noise
    contention_prob: float = 0.0    # chance an iteration hits contention
    contention_scale: float = 2.0   # slowdown of a contended iteration
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def mean_time(self, prefill_spans: Sequence[Tuple[int, int]],
                  decode_lens: Sequence[int]) -> float:
        """Noise-free expected iteration time (for analysis/tests)."""
        return self.base.batch_time(prefill_spans, decode_lens) * self.scale

    def batch_time(self, prefill_spans: Sequence[Tuple[int, int]],
                   decode_lens: Sequence[int]) -> float:
        t = self.mean_time(prefill_spans, decode_lens)
        if self.jitter > 0.0:
            t *= float(self._rng.lognormal(0.0, self.jitter))
        if self.contention_prob > 0.0 and \
                self._rng.random() < self.contention_prob:
            t *= self.contention_scale
        return t

    def swap_time(self, n_bytes: int) -> float:
        """PCIe transfers share the systematic drift but not the compute
        jitter (the link is not the contended resource). Byte-denominated,
        passed straight through to the base model's byte terms."""
        return self.base.swap_time(n_bytes) * self.scale

    def migrate_time(self, n_bytes: int) -> float:
        """Inter-node fabric hops drift with the same systematic scale as
        the PCIe terms (one miscalibrated hardware profile)."""
        return self.base.migrate_time(n_bytes) * self.scale

    @property
    def swap_overlap(self) -> bool:
        return self.base.swap_overlap

    @property
    def swap_launch(self) -> float:
        return self.base.swap_launch * self.scale

    def overlapped_iteration_time(self, compute: float,
                                  transfer: float) -> float:
        """Same max-plus-launch structure as the base model; ``compute`` and
        ``transfer`` arrive already drifted/jittered by this wrapper, so only
        the launch overhead picks up the systematic scale here."""
        if transfer <= 0.0:
            return compute
        if not self.base.swap_overlap:
            return compute + transfer
        return max(compute, transfer) + self.swap_launch

    def exposed_swap_time(self, compute: float, transfer: float) -> float:
        return self.overlapped_iteration_time(compute, transfer) - compute


@dataclass
class DegradedClock:
    """Straggler wrapper for a ground-truth clock: every ground-truth term —
    compute, PCIe, fabric, launch — runs ``slowdown``x slower than the
    wrapped clock (a thermally throttled or noisy-neighbour replica).

    Composable over either a plain ``TimeModel`` or a ``PerturbedTimeModel``;
    it never touches the scheduler's *estimate*, so a degraded replica keeps
    planning as if healthy and the damage shows up as clock skew — exactly
    the signal the router's ``predicted_added_latency`` already penalizes."""
    base: object                    # TimeModel | PerturbedTimeModel
    slowdown: float = 2.0

    def mean_time(self, prefill_spans: Sequence[Tuple[int, int]],
                  decode_lens: Sequence[int]) -> float:
        mean = getattr(self.base, "mean_time", None)
        t = (mean(prefill_spans, decode_lens) if mean is not None
             else self.base.batch_time(prefill_spans, decode_lens))
        return t * self.slowdown

    def batch_time(self, prefill_spans: Sequence[Tuple[int, int]],
                   decode_lens: Sequence[int]) -> float:
        return self.base.batch_time(prefill_spans, decode_lens) * self.slowdown

    def swap_time(self, n_bytes: int) -> float:
        return self.base.swap_time(n_bytes) * self.slowdown

    def migrate_time(self, n_bytes: int) -> float:
        return self.base.migrate_time(n_bytes) * self.slowdown

    @property
    def swap_overlap(self) -> bool:
        return self.base.swap_overlap

    @property
    def swap_launch(self) -> float:
        return self.base.swap_launch * self.slowdown

    def overlapped_iteration_time(self, compute: float,
                                  transfer: float) -> float:
        """``compute``/``transfer`` arrive already slowed by this wrapper,
        so only the launch overhead picks up the slowdown here."""
        if transfer <= 0.0:
            return compute
        if not self.swap_overlap:
            return compute + transfer
        return max(compute, transfer) + self.swap_launch

    def exposed_swap_time(self, compute: float, transfer: float) -> float:
        return self.overlapped_iteration_time(compute, transfer) - compute


@dataclass
class MemoryPredictor:
    """§5.3: predict online KV demand as mu + k*sigma over a sliding window."""
    window: float = 3600.0          # seconds of history
    k_sigma: float = 2.0
    _obs: Deque[Tuple[float, float]] = field(default_factory=deque)
    # running first/second moments of the window so predict() is O(1):
    # callers (threshold + host reserve + the drift probes) hit it several
    # times per engine iteration and the window can hold thousands of
    # samples
    _sum: float = 0.0
    _sumsq: float = 0.0

    def observe(self, now: float, online_kv_tokens: float) -> None:
        self._obs.append((now, online_kv_tokens))
        self._sum += online_kv_tokens
        self._sumsq += online_kv_tokens * online_kv_tokens
        cutoff = now - self.window
        while self._obs and self._obs[0][0] < cutoff:
            _, v = self._obs.popleft()
            self._sum -= v
            self._sumsq -= v * v

    def predict(self) -> float:
        n = len(self._obs)
        if n == 0:
            return 0.0
        mean = self._sum / n
        var = max(self._sumsq / n - mean * mean, 0.0)
        return float(mean + self.k_sigma * math.sqrt(var))

    def threshold_blocks(self, total_blocks: int, block_size: int,
                         current_online_tokens: float = 0.0,
                         clean_evictable_blocks: int = 0,
                         floor_frac: float = 0.5) -> int:
        """Running-KV cap (the §4.2 threshold): reserve headroom for the
        predicted *increment* of online KV demand over what is resident,
        net of blocks a burst may already evict punishment-free (dead
        offline / finished online — evicting those costs nothing)."""
        inc = max(self.predict() - current_online_tokens, 0.0)
        reserve = max(int(math.ceil(inc / block_size)) - clean_evictable_blocks, 0)
        return max(total_blocks - reserve, int(total_blocks * floor_frac))

    def host_reserve_blocks(self, block_size: int,
                            current_online_tokens: float = 0.0,
                            cap_blocks: Optional[int] = None,
                            inflight_blocks: int = 0,
                            io: Optional[BlockIOSpec] = None) -> int:
        """Host-tier headroom (§5.3 applied to the swap layer): slots to
        keep clear of low-priority swaps so a predicted online burst can
        always park the state it preempts instead of losing it to recompute.
        With an ``io`` spec the burst is priced in bytes and converted back
        through the family's per-slot payload — a host slot holds one full
        block, whatever that block weighs (KV pages or one fixed-size state
        snapshot) — so paged and state families reserve uniformly.
        ``inflight_blocks`` — swap payloads still staging on the async copy
        stream — extend the reserve: a slot whose transfer has not landed
        cannot be re-purposed without losing the work in flight."""
        inc = max(self.predict() - current_online_tokens, 0.0)
        inc_blocks = int(math.ceil(inc / block_size))
        if io is not None:
            slot_bytes = max(io.block_bytes(block_size), 1)
            inc_bytes = inc_blocks * io.block_bytes(block_size)
            inc_blocks = int(math.ceil(inc_bytes / slot_bytes))
        reserve = inc_blocks + max(inflight_blocks, 0)
        if cap_blocks is not None:
            reserve = min(reserve, cap_blocks // 2)
        return reserve


@dataclass
class RatePredictor:
    """Fig.11: predict online arrival rate from a sliding window
    (mu + k*sigma, k=2 to cover ~95% of bursts, §5.3)."""
    window: float = 900.0
    k_sigma: float = 2.0
    _arrivals: Deque[float] = field(default_factory=deque)
    _t0: Optional[float] = None          # first observation: history start

    def observe(self, t: float) -> None:
        if self._t0 is None:
            self._t0 = t
        self._arrivals.append(t)
        cutoff = t - self.window
        while self._arrivals and self._arrivals[0] < cutoff:
            self._arrivals.popleft()

    def predict_rate(self, now: float, bin_s: float = 60.0) -> float:
        """Predicted arrivals/s = mu + sigma of per-bin counts, binned only
        over *elapsed* history: during warmup (observed span < window) bins
        before the first observation would be structurally empty and dilute
        the rate ~window/elapsed-fold."""
        if not self._arrivals:
            return 0.0
        span = min(self.window, now - self._t0)
        if span <= bin_s:
            # under one full bin of history: single-bin mean, no sigma yet
            # (span clamped: sub-second history cannot resolve a rate)
            arr = [a for a in self._arrivals if a >= now - max(span, 0.0)]
            return len(arr) / max(span, 1.0)
        nbins = int(span / bin_s)            # whole bins of real history
        cutoff = now - nbins * bin_s
        arr = [a for a in self._arrivals if a >= cutoff]
        counts = np.zeros(nbins)
        for a in arr:
            b = min(int((a - cutoff) / bin_s), nbins - 1)
            counts[b] += 1
        per_s = counts / bin_s
        return float(per_s.mean() + self.k_sigma * per_s.std())
