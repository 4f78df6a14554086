"""Synthetic DLRM traffic mirroring the paper's §V benchmarks (the port's
own copy of ``repro/data/synthetic.py``'s batch generator).

``uniform``  — every table accessed with exactly one index.
``hetero``   — Setting 1: 1..max_hot indices per (sample, table).
``powerlaw`` — Zipf-skewed row ids.
``powerlaw_hetero`` — both at once.
``drift``    — Zipf row ids and per-table bag sizes from a phase-seeded
               table-heat profile (:func:`table_heat`).

Every draw is made in the reference's order from the same
``SeedSequence``, so a (seed, step) gives byte-identical numpy arrays in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
