"""Straggler monitor and bound policy, and the ragged-exchange cap
autotuner (the port's own copy of ``repro/runtime/straggler.py``).

For inference the BLS bound IS the mitigation: a bound of k absorbs any
transient per-host delay up to k iterations of slack (paper §IV).  The
monitor observes per-step latency jitter and recommends the smallest k
whose absorption window covers the tail, capped by the memory budget (ring
bytes are linear in k).  ``CapAutotuner`` plays the same game for the
ragged exchange's bucket cap; :func:`detect_stragglers` flags the
consistent stragglers no bound masks."""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional


@dataclasses.dataclass
class BoundRecommendation:
    bound: int
    reason: str
    p50: float
    p99: float


class StragglerMonitor:
    """Windowed percentiles over observed step latencies."""

    def __init__(self, window: int = 256):
        self.lat = collections.deque(maxlen=window)

    def observe(self, seconds: float) -> None:
        self.lat.append(seconds)

    def reset(self) -> None:
        self.lat.clear()

    def percentile(self, q: float) -> float:
        if not self.lat:
            return 0.0
        xs = sorted(self.lat)
        i = min(len(xs) - 1, int(q * len(xs)))
        return xs[i]

    def recommend_bound(self, *, slot_bytes: int, memory_budget: int,
                        max_bound: int = 16) -> BoundRecommendation:
        """k ~= ceil(p99 excess jitter / median step), capped by the
        ring-buffer budget (paper: ring bytes = k * slot_bytes)."""
        p50 = self.percentile(0.50)
        p99 = self.percentile(0.99)
        if p50 <= 0:
            return BoundRecommendation(0, "no data", 0.0, 0.0)
        jitter = max(p99 - p50, 0.0)
        k = min(max_bound, int(-(-jitter // p50)))  # ceil
        if slot_bytes > 0:
            k = min(k, memory_budget // slot_bytes)
        reason = (f"p99-p50 jitter {jitter*1e3:.2f} ms over median "
                  f"{p50*1e3:.2f} ms -> k={k}")
        return BoundRecommendation(k, reason, p50, p99)


@dataclasses.dataclass(frozen=True)
class CapRecommendation:
    cap: int          # smallest safe per-destination bucket cap
    ragged: bool      # does that cap still undercut the dense exchange?
    live_q: int       # the live-count quantile the cap covers
    drops: int        # drops observed since the last recommendation
    reason: str


class CapAutotuner:
    """Windowed quantile tracker for per-destination live-row counts:
    recommends the smallest cap (rounded up to ``round_to`` rows, with
    ``headroom`` slack) covering the target quantile with zero drops;
    observed drops at least double it.  ``ragged`` flips False once the
    cap reaches the dense exchange's per-destination rows."""

    def __init__(self, window: int = 128, quantile: float = 0.99,
                 headroom: float = 1.25, round_to: int = 8):
        self.live = collections.deque(maxlen=window)
        self.quantile = quantile
        self.headroom = headroom
        self.round_to = round_to
        self.drops = 0          # since last recommend()
        self.total_drops = 0

    def observe(self, live_max: int, drops: int = 0) -> None:
        self.live.append(int(live_max))
        self.drops += int(drops)
        self.total_drops += int(drops)

    def reset(self) -> None:
        self.live.clear()
        self.drops = 0

    def __len__(self) -> int:
        return len(self.live)

    def recommend(self, *, dense_rows: int,
                  current_cap: Optional[int] = None,
                  peek: bool = False) -> CapRecommendation:
        if not self.live:
            return CapRecommendation(dense_rows, False, 0, 0,
                                     "no observations yet -> dense")
        xs = sorted(self.live)
        q = xs[min(len(xs) - 1, int(self.quantile * len(xs)))]
        cap = int(q * self.headroom)
        cap = -(-max(cap, 1) // self.round_to) * self.round_to  # ceil round
        drops = self.drops
        if not peek:
            self.drops = 0
        if drops:
            cap = max(cap, 2 * (current_cap if current_cap else cap))
        cap = min(cap, dense_rows)
        ragged = cap < dense_rows
        reason = (f"live p{int(self.quantile * 100)}={q} rows/dest, "
                  f"headroom x{self.headroom} -> cap={cap} "
                  f"({'ragged' if ragged else 'dense: cap*P >= B*T'}"
                  f"{f', {drops} drops seen' if drops else ''})")
        return CapRecommendation(cap, ragged, q, drops, reason)


def detect_stragglers(per_host_latencies: dict, threshold: float = 1.5
                      ) -> list:
    """Hosts above ``threshold`` x the median latency are CONSISTENT
    stragglers — the case the paper shows BLS cannot mask: flag them for
    degraded serving or eviction instead.  An empty dict or a singleton
    flags nobody (one slow host alone is indistinguishable from a slow
    workload); an even count uses the true median, so a 2-host pod with
    one straggler still flags it."""
    if len(per_host_latencies) < 2:
        return []
    xs = sorted(per_host_latencies.values())
    n = len(xs)
    med = xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
    return [h for h, v in per_host_latencies.items() if v > threshold * med]
