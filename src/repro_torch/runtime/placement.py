"""Skew-aware table placement: the cost model and optimizer half of
DESIGN.md §11 (the executor half lives in ``runtime/reshard.py``).  The
port's own copy of ``repro/runtime/placement.py``, numpy only, on the
port's ``core/schedule_sim.py`` copy.

The paper's BLS bound masks *transient* jitter; a persistently hot table
turns its owner into a CONSISTENT straggler, which §IV proves no bound
absorbs.  The only fix is to move load — re-assign tables to members so
per-member exchange work levels out.  The pieces here are all host-side
and pure:

  * :class:`PartitionMap` — the physical layout as a permutation of the
    padded table stack: ``perm[slot] = original table``.  Member m owns
    physical slots ``[m*t_loc, (m+1)*t_loc)``; the identity map is the
    boot layout every engine starts from (and the layout ``evict``
    canonicalizes back to, so recovery never depends on placement
    state).
  * :class:`TableLoadModel` — per-ORIGINAL-table EWMA of pooled rows ×
    row bytes, fed each flush from the same live-row telemetry
    ``core.alltoallv.dispatch_stats`` summarizes.  Loads live in
    original-table space so they survive cutovers and evictions
    unchanged.
  * :func:`lpt_assign` — greedy Longest-Processing-Time over per-table
    load under an equal-cardinality constraint (each member owns exactly
    ``t_loc`` physical slots — the stacked (T, R, s) shard shape is
    static and jit-compiled, so placement may permute tables across the
    stack but never change per-member counts).  Ties prefer the current
    owner, which is what makes the migration plan minimal.
  * :func:`plan_migration` — assignment → :class:`MigrationPlan`:
    tables that keep their owner keep their physical slot; movers fill
    the freed slots of their destination.  ``row_splits`` reports
    monster tables whose single-table load exceeds a balanced member's
    share — the row-wise split the plan can see but serving applies
    table-wise (DESIGN.md §11 records the honesty gap).
  * :func:`predicted_makespan` — the ``core.schedule_sim`` cost check:
    simulate the BLS schedule with per-member stage times scaled by the
    plan's member loads, before and after, so a rebalance is justified
    by the same discrete-event model the paper's figures come from.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import schedule_sim as sim


@dataclasses.dataclass(frozen=True)
class PartitionMap:
    """The table placement as a permutation of the padded stack.

    ``perm[slot] = original table id`` (physical → original);
    ``inv[table] = slot`` (original → physical) is derived.  Members own
    contiguous slot ranges, so ``owner(table) = inv[table] // t_loc``.
    Frozen: a cutover swaps the engine's reference, never mutates."""

    perm: tuple

    def __post_init__(self):
        t = len(self.perm)
        if sorted(self.perm) != list(range(t)):
            raise ValueError(
                f"perm must be a permutation of 0..{t - 1}: {self.perm}")

    @classmethod
    def identity(cls, t_pad: int) -> "PartitionMap":
        return cls(tuple(range(int(t_pad))))

    @property
    def t_pad(self) -> int:
        return len(self.perm)

    @property
    def is_identity(self) -> bool:
        return self.perm == tuple(range(len(self.perm)))

    def perm_array(self) -> np.ndarray:
        return np.asarray(self.perm, np.int32)

    def inv_array(self) -> np.ndarray:
        inv = np.empty(len(self.perm), np.int32)
        inv[np.asarray(self.perm, np.int64)] = np.arange(
            len(self.perm), dtype=np.int32)
        return inv

    def owner_of(self, table: int, n_members: int) -> int:
        t_loc = len(self.perm) // n_members
        return int(self.inv_array()[table]) // t_loc

    def owners(self, n_members: int) -> np.ndarray:
        """(T,) original table -> owning member under this map."""
        t_loc = len(self.perm) // n_members
        return self.inv_array() // t_loc


class TableLoadModel:
    """Per-original-table EWMA load, the optimizer's only input.

    ``observe`` takes this flush's per-table live (pooled) row counts —
    exactly the quantity ``dispatch_stats`` aggregates per destination —
    plus the wire row size, and folds bytes into the EWMA.  ``min_obs``
    observations gate ``ready`` so one warm flush cannot trigger a
    rebalance."""

    def __init__(self, n_tables: int, *, alpha: float = 0.25,
                 min_obs: int = 4):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.n_tables = int(n_tables)
        self.alpha = float(alpha)
        self.min_obs = int(min_obs)
        self._ewma: Optional[np.ndarray] = None
        self.observations = 0

    def observe(self, table_rows, row_bytes: float = 1.0) -> None:
        load = np.asarray(table_rows, np.float64) * float(row_bytes)
        if load.shape != (self.n_tables,):
            raise ValueError(
                f"expected ({self.n_tables},) per-table rows, "
                f"got {load.shape}")
        if self._ewma is None:
            self._ewma = load.copy()
        else:
            self._ewma = self.alpha * load + (1 - self.alpha) * self._ewma
        self.observations += 1

    @property
    def ready(self) -> bool:
        return self.observations >= self.min_obs

    @property
    def loads(self) -> np.ndarray:
        if self._ewma is None:
            return np.zeros(self.n_tables)
        return self._ewma.copy()

    def reset(self) -> None:
        self._ewma = None
        self.observations = 0


def member_loads(loads, pmap: PartitionMap, n_members: int) -> np.ndarray:
    """(P,) summed table load per member under ``pmap``."""
    owners = pmap.owners(n_members)
    return np.bincount(owners, weights=np.asarray(loads, np.float64),
                       minlength=n_members)


def imbalance(member_load) -> float:
    """max/mean member load — 1.0 is perfectly level, and the ratio the
    rebalance trigger, the telemetry and the bench gate all share."""
    ml = np.asarray(member_load, np.float64)
    mean = ml.mean() if ml.size else 0.0
    if mean <= 0:
        return 1.0
    return float(ml.max() / mean)


def lpt_assign(loads, n_members: int, *, prefer=None):
    """Greedy LPT under the equal-cardinality constraint: heaviest table
    first, each to the least-loaded member that still has a free slot.
    ``prefer`` (the current owner array) breaks near-ties (within 1e-9
    relative) toward the incumbent, which is what keeps migration plans
    minimal without giving up balance.  Returns ``(owner (T,), member
    load (P,))``."""
    loads = np.asarray(loads, np.float64)
    t = loads.shape[0]
    if t % n_members:
        raise ValueError(f"{t} tables do not split over {n_members} members")
    t_loc = t // n_members
    order = np.argsort(-loads, kind="stable")
    owner = np.full(t, -1, np.int32)
    load = np.zeros(n_members)
    slots_left = np.full(n_members, t_loc, np.int64)
    tol = 1e-9 * max(loads.sum(), 1.0)
    for ti in order:
        avail = np.flatnonzero(slots_left > 0)
        best = int(avail[np.argmin(load[avail])])
        if prefer is not None:
            inc = int(prefer[ti])
            if slots_left[inc] > 0 and load[inc] <= load[best] + tol:
                best = inc
        owner[ti] = best
        load[best] += loads[ti]
        slots_left[best] -= 1
    return owner, load


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """What a rebalance will do, before it does it.

    ``moves`` are the owner CHANGES only — ``(table, src, dst, rows)``
    with ``rows`` the table's real (unpadded) row count, i.e. exactly
    what ships over the wire.  Intra-member slot changes are free (the
    commit rebuilds the stack host-side) and never appear here.
    ``row_splits`` is plan-level reporting of monster tables
    (``(table, ways)``) whose load alone exceeds a member's balanced
    share — serving applies placement table-wise, so these are flagged,
    not executed."""

    new_map: PartitionMap
    moves: tuple
    row_splits: tuple
    load_before: tuple
    load_after: tuple

    @property
    def is_noop(self) -> bool:
        return not self.moves

    @property
    def moved_rows(self) -> int:
        return sum(rows for _, _, _, rows in self.moves)

    @property
    def imbalance_before(self) -> float:
        return imbalance(self.load_before)

    @property
    def imbalance_after(self) -> float:
        return imbalance(self.load_after)

    def summary(self) -> dict:
        return {
            "n_moves": len(self.moves),
            "moved_rows": self.moved_rows,
            "imbalance_before": self.imbalance_before,
            "imbalance_after": self.imbalance_after,
            "row_split_candidates": [list(x) for x in self.row_splits],
        }


def plan_migration(current: PartitionMap, loads, n_members: int, *,
                   table_rows, min_gain: float = 0.0,
                   split_threshold: float = 1.0) -> MigrationPlan:
    """Compute the minimal migration from ``current`` to an LPT-balanced
    layout.

    ``table_rows`` are the real per-original-table row counts (padding
    tables are 0 — they move for free).  ``min_gain``: if the LPT layout
    does not improve max/mean imbalance by at least this much, keep the
    current layout (a noop plan) — moving rows has a cost, so marginal
    wins are not worth a cutover.  ``split_threshold``: a table whose
    load exceeds ``threshold ×`` the balanced per-member share is
    reported in ``row_splits`` with the number of ways a row-wise split
    would need."""
    loads = np.asarray(loads, np.float64)
    table_rows = np.asarray(table_rows, np.int64)
    t = current.t_pad
    if loads.shape[0] != t or table_rows.shape[0] != t:
        raise ValueError(
            f"loads/table_rows must cover all {t} padded tables")
    t_loc = t // n_members
    cur_inv = current.inv_array()
    cur_owner = current.owners(n_members)
    load_before = member_loads(loads, current, n_members)
    new_owner, load_after = lpt_assign(loads, n_members, prefer=cur_owner)
    gain = imbalance(load_before) - imbalance(load_after)
    if gain < min_gain + 1e-12:
        return MigrationPlan(
            new_map=current, moves=(), row_splits=_splits(
                loads, n_members, split_threshold),
            load_before=tuple(load_before), load_after=tuple(load_before))
    # build the new permutation: keepers keep their slot; movers fill
    # the slots their destination freed, in ascending (slot, table)
    # order so the plan is deterministic
    new_perm = np.full(t, -1, np.int64)
    for ti in range(t):
        if new_owner[ti] == cur_owner[ti]:
            new_perm[cur_inv[ti]] = ti
    moves = []
    for m in range(n_members):
        lo, hi = m * t_loc, (m + 1) * t_loc
        free = [s for s in range(lo, hi) if new_perm[s] < 0]
        incoming = sorted(ti for ti in range(t)
                          if new_owner[ti] == m and cur_owner[ti] != m)
        for slot, ti in zip(free, incoming):
            new_perm[slot] = ti
            moves.append((int(ti), int(cur_owner[ti]), m,
                          int(table_rows[ti])))
    moves.sort()
    return MigrationPlan(
        new_map=PartitionMap(tuple(int(x) for x in new_perm)),
        moves=tuple(moves),
        row_splits=_splits(loads, n_members, split_threshold),
        load_before=tuple(load_before), load_after=tuple(load_after))


def _splits(loads, n_members: int, threshold: float) -> tuple:
    share = loads.sum() / max(n_members, 1)
    if share <= 0:
        return ()
    out = []
    for ti, ld in enumerate(loads):
        if ld > threshold * share:
            out.append((int(ti), int(np.ceil(ld / share))))
    return tuple(out)


def predicted_makespan(member_load, *, bound: int = 1, n_iters: int = 32,
                       backend: str = "bls", seed: int = 0,
                       **stage_times) -> float:
    """The schedule-simulator cost check: makespan of a BLS run whose
    per-member embedding + wire stage times scale with ``member_load``
    (``core.schedule_sim.make_skew_workload``).  The bench compares this
    before/after a plan so the rebalance decision is backed by the same
    model that reproduces the paper's figures."""
    w = sim.make_skew_workload(len(member_load), n_iters, member_load,
                               seed=seed, **stage_times)
    return sim.simulate(w, bound, backend=backend).makespan
