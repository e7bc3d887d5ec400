"""The arithmetic of the end-to-end metrics, over the benchmark's clock."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile of all ``values`` by linear interpolation between
    order statistics (numpy's default, R's type 7)."""
    if not values:
        raise ValueError("quantile of no values")
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttfts(due: Sequence[float], firsts: Sequence[float], window: Tuple[float, float],
          drain_end: float) -> Tuple[List[float], int]:
    """Time to first token, from the due time, of every online request due
    in the window; one with no first token by the drain's end counts as
    ``drain_end - due`` (a lower bound: it missed every limit) and as
    failed. Returns (seconds, failed)."""
    out, failed = [], 0
    for d, f in zip(due, firsts):
        if not window[0] <= d < window[1]:
            continue
        if f is None:
            failed += 1
            f = drain_end
        out.append(f - d)
    return out, failed


def itls(token_times: Dict[int, List[float]], window: Tuple[float, float]) -> List[float]:
    """Every gap between consecutive tokens of an online request whose
    later token landed in the window."""
    out = []
    for times in token_times.values():
        out += [b - a for a, b in zip(times, times[1:]) if window[0] <= b < window[1]]
    return out


def rate(amount: float, window: Tuple[float, float]) -> float:
    return amount / (window[1] - window[0])


def occupancy(usage: Dict[str, int], num_blocks: int) -> float:
    """Percent of the page pool holding KV (running or cached), from
    ``BlockManager.usage_breakdown``."""
    return 100.0 * (num_blocks - usage["unused"]) / num_blocks


def occupancy_line(usage: Dict[str, int], num_blocks: int) -> str:
    return (f"{num_blocks - usage['unused']} of {num_blocks} blocks hold KV "
            f"({occupancy(usage, num_blocks):.1f}%): running online "
            f"{usage['running_online']}, running offline {usage['running_offline']}, "
            f"cached online {usage['free_online']}, cached offline {usage['free_offline']}; "
            f"{usage['unused']} free")
