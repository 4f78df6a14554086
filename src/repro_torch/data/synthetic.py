"""Synthetic DLRM traffic mirroring the paper's §V benchmarks (the port's
own copy of ``repro/data/synthetic.py``'s batch generator).

``uniform``  — every table accessed with exactly one index.
``hetero``   — Setting 1: 1..max_hot indices per (sample, table).
``powerlaw`` — Zipf-skewed row ids.
``powerlaw_hetero`` — both at once.
``drift``    — Zipf row ids and per-table bag sizes from a phase-seeded
               table-heat profile (:func:`table_heat`).

``open_loop_arrivals`` / ``request_stream`` add arrival times (an open-loop,
optionally bursty Poisson process) for the serving frontend, and
``make_delta_batch`` / ``delta_stream`` the versioned embedding-row updates
that the freshness path ships over the exchange.

Every draw is made in the reference's order from the same
``SeedSequence``, so a (seed, step) gives byte-identical numpy arrays in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import DLRMConfig

# Criteo Kaggle (Mini-Kaggle) per-table cardinalities, as in the reference
# DLRM's kaggle config (26 categorical fields).  The paper: "the largest
# Mini-Kaggle table has approx. 1 million entries".
CRITEO_KAGGLE_TABLE_SIZES = (
    1460, 583, 10_131_227 // 10, 2_202_608 // 2, 305, 24, 12_517, 633, 3,
    93_145, 5_683, 8_351_593 // 8, 3_194, 27, 14_992, 5_461_306 // 5, 10,
    5_652, 2_173, 4, 7_046_547 // 7, 18, 15, 286_181, 105, 142_572,
)

# Ali-CCP after NVTabular conversion: 23 categorical tables, largest ~2M.
ALI_CCP_TABLE_SIZES = (
    238_635, 98_100, 14_340, 11, 4, 7, 5, 4_368, 2_885_126 // 2, 1_329_000,
    560_000, 12, 2_000_000, 6_769, 463_710, 82_060, 4_737, 44_425, 26_944,
    91_358, 3_438, 14_115, 77_591,
)


@dataclasses.dataclass(frozen=True)
class Batch:
    dense: np.ndarray    # (B, n_dense) float32
    idx: np.ndarray      # (B, T_pad, hot) int32
    mask: np.ndarray     # (B, T_pad, hot) float32 (1 = valid index)
    labels: np.ndarray   # (B,) float32 in {0, 1}


def table_heat(n_tables: int, phase: int, *, seed: int = 0) -> np.ndarray:
    """Per-table relative heat of one drift phase: a Zipf profile
    (1/rank) over a PHASE-seeded permutation of the tables, normalized
    to max 1.  Deterministic in (seed, phase)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD21F, phase]))
    order = rng.permutation(n_tables)
    heat = np.empty(n_tables)
    heat[order] = 1.0 / (1.0 + np.arange(n_tables))
    return heat


def make_batch(cfg: DLRMConfig, batch: int, *, mode: str = "uniform",
               t_pad: Optional[int] = None, powerlaw_alpha: float = 1.05,
               seed: int = 0, step: int = 0, phase: int = 0) -> Batch:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    t = cfg.n_tables
    t_pad = t_pad or t
    ragged = mode in ("hetero", "powerlaw_hetero", "drift")
    hot = cfg.max_hot if ragged else 1
    dense = rng.standard_normal((batch, cfg.n_dense_features),
                                dtype=np.float32)
    idx = np.zeros((batch, t_pad, hot), np.int32)
    mask = np.zeros((batch, t_pad, hot), np.float32)
    sizes = np.asarray(cfg.table_sizes)
    heat = table_heat(t, phase, seed=seed) if mode == "drift" else None
    for ti in range(t):
        n = sizes[ti]
        if mode.startswith("powerlaw") or mode == "drift":
            # Zipf-ish skew clipped to the table size
            raw = rng.zipf(powerlaw_alpha, size=(batch, hot))
            idx[:, ti] = np.minimum(raw - 1, n - 1).astype(np.int32)
        else:
            idx[:, ti] = rng.integers(0, n, size=(batch, hot),
                                      dtype=np.int32)
        if mode == "drift":
            counts = 1 + rng.binomial(cfg.max_hot - 1, heat[ti],
                                      size=batch)
            mask[:, ti] = (np.arange(hot)[None, :]
                           < counts[:, None]).astype(np.float32)
        elif ragged:
            counts = rng.integers(1, cfg.max_hot + 1, size=batch)
            mask[:, ti] = (np.arange(hot)[None, :]
                           < counts[:, None]).astype(np.float32)
        else:
            mask[:, ti] = 1.0
    labels = (rng.random(batch) < 0.25).astype(np.float32)
    return Batch(dense=dense, idx=idx, mask=mask, labels=labels)


def batch_stream(cfg: DLRMConfig, batch: int, n_steps: int, **kw
                 ) -> Iterator[Batch]:
    for step in range(n_steps):
        yield make_batch(cfg, batch, step=step, **kw)


@dataclasses.dataclass(frozen=True)
class Request:
    """One open-loop serving request: a single sample row plus its
    arrival time on the generator's virtual clock (seconds from 0)."""
    t_arrive: float
    dense: np.ndarray    # (n_dense,) float32
    idx: np.ndarray      # (T_pad, hot) int32
    mask: np.ndarray     # (T_pad, hot) float32


def open_loop_arrivals(n: int, *, rate_rps: float, burstiness: float = 0.0,
                       burst_factor: float = 8.0,
                       mean_burst_len: int = 16,
                       factor_of=None, seed: int = 0) -> np.ndarray:
    """Arrival times (seconds, ascending) of an open-loop request stream.

    Baseline is Poisson at ``rate_rps``.  ``burstiness`` in [0, 1) turns
    it into a two-state Markov-modulated process (the power-law traffic
    shape the capacity-scale-out paper identifies as the cause of tail
    latency): with probability ``burstiness`` an arrival opens a burst of
    geometric mean length ``mean_burst_len`` during which inter-arrival
    gaps shrink by ``burst_factor`` — same offered mean load is NOT
    preserved (bursts genuinely overload), which is the point.

    ``factor_of(i)`` (e.g. ``lambda i: plan.arrival_factor(i // B)`` from
    a ``runtime.faults.FaultPlan``) multiplies the instantaneous rate per
    arrival index, so chaos plans drive deterministic load spikes.
    Deterministic per (seed, parameters)."""
    if not 0.0 <= burstiness < 1.0:
        raise ValueError(f"burstiness must be in [0, 1), got {burstiness}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, n]))
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    opens = rng.random(n) < burstiness
    burst_left = 0
    for i in range(n):
        if burst_left <= 0 and opens[i]:
            burst_left = 1 + rng.geometric(1.0 / max(mean_burst_len, 1))
        if burst_left > 0:
            gaps[i] /= burst_factor
            burst_left -= 1
        if factor_of is not None:
            gaps[i] /= max(float(factor_of(i)), 1e-9)
    return np.cumsum(gaps)


def request_stream(cfg: DLRMConfig, n: int, *, rate_rps: float,
                   burstiness: float = 0.0, burst_factor: float = 8.0,
                   mode: str = "powerlaw_hetero",
                   t_pad: Optional[int] = None, factor_of=None,
                   seed: int = 0) -> list:
    """Open-loop request stream: ``n`` single-sample requests with bursty
    arrival times (``open_loop_arrivals``) and ``make_batch``-distributed
    features — the workload the serving frontend's admission control,
    shedding and backpressure are exercised under.  Returns a list of
    :class:`Request` sorted by arrival time."""
    t = open_loop_arrivals(n, rate_rps=rate_rps, burstiness=burstiness,
                           burst_factor=burst_factor, factor_of=factor_of,
                           seed=seed)
    b = make_batch(cfg, n, mode=mode, t_pad=t_pad, seed=seed)
    return [Request(t_arrive=float(t[i]), dense=b.dense[i], idx=b.idx[i],
                    mask=b.mask[i]) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One version's worth of embedding row updates from a (simulated)
    continuous trainer: ``vec[i]`` is the NEW value of row ``row[i]`` of
    (padded) table ``tab[i]``.  Versions are monotone; (tab, row) pairs are
    unique WITHIN a version so the apply order inside one version cannot
    matter — only the order ACROSS versions does, which is what the
    freshness ledger tracks (runtime/freshness.py)."""
    version: int
    tab: np.ndarray      # (n,) int32 padded-stack table index
    row: np.ndarray      # (n,) int32 row within the table
    vec: np.ndarray      # (n, embed_dim) new embedding values

    @property
    def n_rows(self) -> int:
        return int(self.tab.shape[0])


def make_delta_batch(cfg: DLRMConfig, version: int, *,
                     rows_per_version: int = 32, mode: str = "powerlaw",
                     powerlaw_alpha: float = 1.05,
                     dtype=np.float32, seed: int = 0) -> DeltaBatch:
    """The deterministic per-version generator behind :func:`delta_stream`
    — pure in (seed, version), so an oracle can regenerate any version
    independently of the streaming order (the bit-exactness tests in
    tests/test_freshness.py do exactly that).

    ``mode='powerlaw'`` skews updated ROWS the same way serving access is
    skewed (continuous training touches the hot head hardest — the case
    where freshness interacts with the hot cache); 'uniform' spreads them.
    Duplicate (table, row) pairs within the version are dropped keeping
    the LAST occurrence, so a version is a set of row assignments."""
    if version < 1:
        raise ValueError(f"delta versions start at 1, got {version}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5E1F, version]))
    t = cfg.n_tables
    sizes = np.asarray(cfg.table_sizes)
    tab = rng.integers(0, t, size=rows_per_version).astype(np.int32)
    if mode == "powerlaw":
        raw = rng.zipf(powerlaw_alpha, size=rows_per_version)
        row = np.minimum(raw - 1, sizes[tab] - 1).astype(np.int32)
    elif mode == "uniform":
        row = (rng.random(rows_per_version) * sizes[tab]).astype(np.int32)
    else:
        raise ValueError(f"unknown delta mode {mode!r}")
    vec = rng.standard_normal((rows_per_version, cfg.embed_dim)) \
        .astype(dtype)
    # last write wins within a version -> unique (tab, row) pairs
    key = tab.astype(np.int64) * int(sizes.max()) + row
    _, last = np.unique(key[::-1], return_index=True)
    keep = np.sort(rows_per_version - 1 - last)
    return DeltaBatch(version=int(version), tab=tab[keep], row=row[keep],
                      vec=vec[keep])


def delta_stream(cfg: DLRMConfig, *, rows_per_version: int = 32,
                 mode: str = "powerlaw", powerlaw_alpha: float = 1.05,
                 dtype=np.float32, seed: int = 0,
                 start_version: int = 1) -> Iterator[DeltaBatch]:
    """Infinite stream of :class:`DeltaBatch` with monotone versions —
    the synthetic stand-in for a trainer's publish stream.  The serving
    side (``runtime.freshness.FreshnessManager``) pulls from it at
    whatever rate the bounded-staleness gate allows; being a generator,
    nothing is materialized ahead of the pull."""
    v = start_version
    while True:
        yield make_delta_batch(cfg, v, rows_per_version=rows_per_version,
                               mode=mode, powerlaw_alpha=powerlaw_alpha,
                               dtype=dtype, seed=seed)
        v += 1


def hot_counts_stats(b: Batch) -> dict:
    counts = b.mask.sum(axis=2)  # (B, T)
    return {"mean_hot": float(counts.mean()), "max_hot": float(counts.max()),
            "message_cv": float(counts.sum(1).std() /
                                max(counts.sum(1).mean(), 1e-9))}
