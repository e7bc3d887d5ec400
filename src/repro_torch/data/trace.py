"""Online arrival trace generator: tidal (diurnal) + bursty (Fig. 2).

Arrivals follow a non-homogeneous Poisson process whose rate is
    lambda(t) = base * tidal(t) * burst(t)
with a sinusoidal tidal factor (configurable peak/off-peak ratio, the paper
observes ~6x) and a two-state Markov burst multiplier (flash crowds).
Timestamps can be scaled to match experimental capacity, as the paper does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class BurstyTrace:
    base_rate: float = 2.0          # arrivals / s at the tidal mean
    tidal_period: float = 86_400.0  # s (24 h)
    tidal_ratio: float = 6.0        # peak / off-peak rate ratio
    burst_rate: float = 4.0         # multiplier while bursting
    burst_prob: float = 0.02        # P(enter burst) per second
    burst_len: float = 20.0         # mean burst duration (s)
    seed: int = 0

    def rate(self, t: float, bursting: bool = False) -> float:
        r = self.tidal_ratio
        tidal = (1 + (r - 1) / (r + 1) *
                 np.sin(2 * np.pi * t / self.tidal_period - np.pi / 2))
        lam = self.base_rate * tidal
        return lam * (self.burst_rate if bursting else 1.0)

    def sample(self, t0: float, t1: float) -> List[float]:
        """Arrival timestamps in [t0, t1) via thinning."""
        rng = np.random.default_rng(self.seed)
        lam_max = self.base_rate * 2.0 * self.burst_rate
        out = []
        t = t0
        bursting = False
        next_state_change = t0
        while t < t1:
            if t >= next_state_change:
                if bursting:
                    bursting = False
                    next_state_change = t + rng.exponential(1.0 / max(self.burst_prob, 1e-9))
                else:
                    bursting = True
                    next_state_change = t + rng.exponential(self.burst_len)
                # first toggle at t0 starts calm
                if t == t0:
                    bursting = False
            t += rng.exponential(1.0 / lam_max)
            if t >= t1:
                break
            if rng.random() < self.rate(t, bursting) / lam_max:
                out.append(t)
        return out
