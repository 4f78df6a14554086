"""Hot-row embedding cache (the port of ``repro/serving/hot_cache.py``).

The hottest ``cache_rows`` rows of each table are duplicated into a dense
block on the table stack's device; lookups split into cache hits (pooled
locally, nothing exchanged) and misses (the distributed exchange).  The
cache changes WHAT is exchanged; the BLS bound changes WHEN completion is
awaited.

On the card the pooled hits go through the bag kernel
(``ops.embedding_bag_stacked_op`` over the (T, C, s) hot block), so no
(B, T, hot, s) gather is materialized; on the CPU they take the
reference's gather-sum.  Out-of-range (table, row) entries, which the
reference drops through ``mode="drop"`` scatters, are masked out
explicitly: torch indexing would raise or wrap.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.alltoallv import to_numpy
from repro_torch.kernels import ops


@dataclasses.dataclass
class HotCache:
    """Per-table hot-row cache over a stacked (T, R, s) table block."""

    hot_ids: torch.Tensor    # (T, C) int32: cached row ids per table
    hot_rows: torch.Tensor   # (T, C, s): cached embeddings
    slot_of: torch.Tensor    # (T, R) int32: row -> cache slot or -1

    @property
    def cache_rows(self) -> int:
        return self.hot_rows.shape[1]


def build(tables: torch.Tensor, counts: np.ndarray, cache_rows: int
          ) -> HotCache:
    """tables: (T, R, s); counts: (T, R) observed access frequencies.  The
    rows are ranked by the reference's own (unstable) ``np.argsort`` on the
    host, so ties, zero-count rows included, resolve to the same rows."""
    t, r, s = tables.shape
    cache_rows = min(cache_rows, r)
    order = np.argsort(-counts, axis=1)[:, :cache_rows]          # (T, C)
    dev = tables.device
    hot_ids = torch.from_numpy(order.astype(np.int32)).to(dev)
    hot_rows = torch.gather(
        tables, 1, hot_ids.long()[..., None].expand(t, cache_rows, s))
    slot = np.full((t, r), -1, np.int32)
    for ti in range(t):
        slot[ti, order[ti]] = np.arange(cache_rows)
    return HotCache(hot_ids=hot_ids, hot_rows=hot_rows,
                    slot_of=torch.from_numpy(slot).to(dev))


def _hit_flags(slot_of: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor):
    """slot_of (T,R), idx/mask (B,T,hot) -> (slots, hit) both (B,T,hot)."""
    t = idx.shape[1]
    tix = torch.arange(t, device=idx.device)[None, :, None]
    slots = slot_of[tix, idx.long().clamp(0, slot_of.shape[1] - 1)]
    hit = (slots >= 0) & (mask > 0)
    return slots, hit


def miss_mask_of(slot_of: torch.Tensor, idx: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """The residual mask after cache hits are removed: what still has to
    ride the distributed exchange.  Works on a table slice (pass the
    slice's ``slot_of`` rows)."""
    _, hit = _hit_flags(slot_of, idx, mask)
    return mask * (~hit).to(mask.dtype)


def pooled_hits_of(hot_rows: torch.Tensor, slot_of: torch.Tensor,
                   idx: torch.Tensor, mask: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """hot_rows (T,C,s), slot_of (T,R), idx/mask (B,T,hot) -> (B,T,s)
    locally pooled cache hits: the bag sum over the hot block of the ids
    ``clip(slot, 0, C-1)``, each hit weighed 1 (not by its mask value).
    ``impl`` as in ``kernels/ops.py``: the bag kernel for a CUDA hot block
    under 'auto' or 'pallas', the plain gather-sum otherwise.  C == 0 gives
    zeros."""
    b, t, _ = idx.shape
    c, s = hot_rows.shape[1], hot_rows.shape[2]
    if c == 0:
        return hot_rows.new_zeros((b, t, s))
    slots, hit = _hit_flags(slot_of, idx, mask)
    return ops.embedding_bag_stacked_op(hot_rows, slots.clamp(0, c - 1),
                                        hit.to(hot_rows.dtype), impl=impl)


def lookup(cache: HotCache, idx: torch.Tensor, mask: torch.Tensor):
    """idx/mask: (B, T, hot) -> (pooled_hits (B,T,s), miss_mask
    (B,T,hot)): misses keep their mask and take the distributed path."""
    pooled = pooled_hits_of(cache.hot_rows, cache.slot_of, idx, mask)
    return pooled, miss_mask_of(cache.slot_of, idx, mask)


def hit_rate(cache: HotCache, idx, mask) -> float:
    idx, mask = torch.as_tensor(idx), torch.as_tensor(mask)
    _, hit = _hit_flags(cache.slot_of, idx.to(cache.slot_of.device),
                        mask.to(cache.slot_of.device))
    total = max(int((mask > 0).sum()), 1)
    return float(hit.sum()) / total


def _cached(cache: HotCache, tab, row):
    """(tab, row) as int64 tensors on the cache's device, their slots, and
    which entries name a cached row: entries out of range (the scatter
    paths pad with out-of-range-high sentinels) are never cached."""
    dev = cache.slot_of.device
    tab = torch.as_tensor(tab, dtype=torch.int64).to(dev)
    row = torch.as_tensor(row, dtype=torch.int64).to(dev)
    t_all, r_all = cache.slot_of.shape
    in_range = (tab >= 0) & (tab < t_all) & (row >= 0) & (row < r_all)
    slots = cache.slot_of[tab.clamp(0, t_all - 1), row.clamp(0, r_all - 1)]
    return tab, row, slots.long(), in_range & (slots >= 0)


def refresh_rows(cache: HotCache, tab, row, vec):
    """Overwrite the cached copies of rows ``(tab[i], row[i])`` with
    ``vec[i]``; rows not cached, or out of range, are skipped.  Returns
    ``(cache', n_refreshed)``; the input cache is untouched."""
    if cache.cache_rows == 0 or len(tab) == 0:
        return cache, 0
    tab, _, slots, hit = _cached(cache, tab, row)
    vec = torch.as_tensor(vec).to(device=cache.hot_rows.device,
                                  dtype=cache.hot_rows.dtype)
    new_rows = cache.hot_rows.clone()
    new_rows[tab[hit], slots[hit]] = vec[hit]
    return (HotCache(hot_ids=cache.hot_ids, hot_rows=new_rows,
                     slot_of=cache.slot_of), int(hit.sum()))


def invalidate(cache: HotCache, tab, row):
    """Evict rows ``(tab[i], row[i])``: their slots become misses
    (``slot_of`` -> -1, ids -> -1, cached vectors zeroed); entries not
    cached, or out of range, are skipped.  Returns ``(cache',
    n_invalidated)``; the input cache is untouched."""
    if cache.cache_rows == 0 or len(tab) == 0:
        return cache, 0
    tab, row, slots, hit = _cached(cache, tab, row)
    th, rh, sh = tab[hit], row[hit], slots[hit]
    new_slot = cache.slot_of.clone()
    new_slot[th, rh] = -1
    new_rows = cache.hot_rows.clone()
    new_rows[th, sh] = 0.0
    new_ids = cache.hot_ids
    if new_ids is not None:
        new_ids = new_ids.clone()
        new_ids[th, sh] = -1
    return (HotCache(hot_ids=new_ids, hot_rows=new_rows, slot_of=new_slot),
            int(hit.sum()))


def permute_tables(cache: HotCache, order) -> HotCache:
    """Re-order the cache along the table axis, ``order[new] = old``.
    Returns a new cache; the input is untouched."""
    order = torch.as_tensor(order, dtype=torch.int64).to(
        cache.slot_of.device)
    ids = cache.hot_ids
    if ids is not None:
        ids = ids[order]
    return HotCache(hot_ids=ids, hot_rows=cache.hot_rows[order],
                    slot_of=cache.slot_of[order])


def cold(cache: HotCache) -> HotCache:
    """Invalidate everything, keeping shapes: every slot a miss, every
    cached vector zero."""
    ids = cache.hot_ids
    if ids is not None:
        ids = torch.full_like(ids, -1)
    return HotCache(hot_ids=ids, hot_rows=torch.zeros_like(cache.hot_rows),
                    slot_of=torch.full_like(cache.slot_of, -1))


def build_from_batch(tables: torch.Tensor, idx, mask, cache_rows: int
                     ) -> HotCache:
    """Calibrate a cache from one observed batch: count the accesses on
    the host, keep the head."""
    counts = observe(np.zeros(tuple(tables.shape[:2])), to_numpy(idx),
                     to_numpy(mask))
    return build(tables, counts, cache_rows)


def observe(counts: np.ndarray, idx: np.ndarray, mask: np.ndarray
            ) -> np.ndarray:
    """Accumulate access frequencies (host-side).  counts may cover a
    padded table stack (T_pad >= idx.shape[1]); padding tables stay
    cold."""
    t = min(counts.shape[0], idx.shape[1])
    for ti in range(t):
        sel = idx[:, ti][mask[:, ti] > 0]
        np.add.at(counts[ti], sel, 1)
    return counts
