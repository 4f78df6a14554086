"""Embedding-bag wrappers over the hand-written CUDA pooling kernel
(``csrc/embedding_bag.cu``), the port of ``repro/kernels/embedding_bag.py``.

All three entry points — :func:`embedding_bag` (one table),
:func:`embedding_bag_stacked` (the (T, R, s) model stack) and
:func:`embedding_bag_rows` (packed rows, each against its own table) —
address the stack as one flat (T·R, s) row space with global row id
t·R + clip(idx), and go through the one kernel, :func:`pool_rows`.

For CPU tensors the wrappers take the plain versions in ``kernels/ref.py``;
for CUDA tensors they launch the kernel or raise.  ``row_block`` and
``pool_mode`` keep the reference's value sets and are validated, but they
shaped a TPU VMEM/DMA schedule that has no counterpart here: the kernel
reads each row straight from device memory whatever their value.

The reference's stream plans (:class:`StreamPlan`, built by
:func:`build_stream_plan` and :func:`stacked_stream_plan`) are ported as
torch ops, bit for bit: the same leaves, and None exactly where the
reference has no plan to build (a VMEM-resident regime), because that
geometry still decides when a plan exists.  The entry points take
``plan=`` and check it against the call's geometry (a plan built for
another batch, tile, block height or table raises ``ValueError``); the
kernel reads no plan, so a plan never changes a bit of the output.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import Kernel

POOL = Kernel("embedding_bag.cu", "embedding_bag_pool_f32",
              [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_void_p])


def launch_key(n_bags: int, hot: int, s: int, n_tables: int,
               rows_form: bool = False) -> tuple:
    """What ``POOL.by_key`` counts a launch under: its bags, slots per bag,
    width, tables and whether it is the rows form."""
    return (n_bags, hot, s, n_tables, rows_form)


def launch_plan(n_bags: int, hot: int, s: int, n_tables: int, *,
                rows_form: bool = False) -> dict:
    """The plan the CUDA launcher picks for a call of these shapes on the
    current card (it reads the card's SM count, so it needs one): lanes
    per row, groups per bag (``ref.embedding_bag_split_ref``'s
    ``groups``), whether the schedule is table-major, blocks and bytes of
    dynamic shared memory."""
    fn = _build.library("embedding_bag.cu").embedding_bag_plan
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * 5)()
    err = fn(n_bags, hot, s, n_tables, int(rows_form), out)
    if err:
        raise RuntimeError(f"embedding_bag_plan: CUDA error {err}")
    return dict(zip(("lanes", "groups", "table_major", "blocks", "smem"),
                    map(int, out)))


def check_row_block(row_block: int) -> int:
    """Validate the reference's knob: -1 resident, 0 auto, > 0 streamed."""
    if row_block < -1:
        raise ValueError(f"row_block must be -1, 0 or positive, "
                         f"got {row_block}")
    return row_block


# ---------------------------------------------------------------------------
# the reference's geometry, which decides when a stream plan exists
# ---------------------------------------------------------------------------

# the reference's TPU VMEM budgets (bytes): RESIDENT bounds the one (R, s)
# table block its resident kernel keeps, STREAM the streamed kernel's two
# row-block slots together, STAGE the (tile, hot, s) f32 staging tile.
# The CUDA kernel has no VMEM; these only shape the plans.
RESIDENT_VMEM_BYTES = 4 << 20
STREAM_VMEM_BYTES = 4 << 20
STAGE_VMEM_BYTES = 2 << 20
# the counting-sort plan materializes a (tiles, L, blocks) running count:
# past this many cells 'auto' takes the comparison sort
PLAN_COUNT_WORK = 4 << 20
# chunk of the counting sort's hierarchical running count
RANK_CHUNK = 128
N_PLAN_LEAVES = 8


def fits_resident(rows: int, s: int, itemsize: int) -> bool:
    """Can one (rows, s) table block sit whole in the resident budget?"""
    return rows * s * itemsize <= RESIDENT_VMEM_BYTES


def auto_row_block(total_rows: int, s: int, itemsize: int) -> int:
    """Streamed block height: half the stream budget per slot, rounded
    down to a multiple of 8 rows, clipped to the table."""
    rb = max(8, (STREAM_VMEM_BYTES // (2 * s * itemsize)) // 8 * 8)
    return min(total_rows, rb)


def resolve_row_block(total_rows: int, s: int, itemsize: int,
                      row_block: int) -> tuple[bool, int]:
    """(streamed?, effective row_block) for a table of ``total_rows``, as
    the reference resolves it: 0 auto (resident iff the block fits
    RESIDENT_VMEM_BYTES), > 0 streamed at min(row_block, total_rows), -1
    resident (raises when the block would not fit)."""
    if row_block == -1:
        if not fits_resident(total_rows, s, itemsize):
            raise ValueError(
                f"resident embedding-bag regime: table block "
                f"{total_rows}x{s}x{itemsize}B = "
                f"{total_rows * s * itemsize} B exceeds the "
                f"{RESIDENT_VMEM_BYTES} B budget — use row_block=0 (auto) "
                f"or > 0 to stream row blocks")
        return False, total_rows
    if row_block > 0:
        return True, min(row_block, total_rows)
    check_row_block(row_block)
    if fits_resident(total_rows, s, itemsize):
        return False, total_rows
    return True, auto_row_block(total_rows, s, itemsize)


def _stage_tile(tile: int, b: int, hot: int, s: int) -> int:
    """The reference's batch/row tile, clamped so a (tile, hot, s) f32
    staging tile stays inside STAGE_VMEM_BYTES."""
    return max(1, min(tile, b, STAGE_VMEM_BYTES // max(hot * s * 4, 1)))


def _stream_geometry(total_rows: int, s: int, n: int, hot: int,
                     row_tile: int, rb: int):
    """(nt, tiles, n_pad, L, nbmax, n_slots): the one tiling a plan and the
    call that consumes it share."""
    nt = _stage_tile(row_tile, n, hot, s)
    tiles = -(-n // nt)
    n_pad = tiles * nt
    L = nt * hot
    nbmax = min(-(-total_rows // rb), L)
    n_slots = min(2, nbmax)
    return nt, tiles, n_pad, L, nbmax, n_slots


def _stream_rb(n_tables: int, rows: int, s: int, itemsize: int,
               row_block: int):
    """The block height a stack of ``n_tables`` tables of ``rows`` rows
    streams at, or None when it resolves resident.  Residency is decided
    per table block; the streamed regime addresses the flat (T·R, s) row
    space, so an explicit height clips against T·R."""
    streamed, _ = resolve_row_block(rows, s, itemsize, row_block)
    if not streamed:
        return None
    total = n_tables * rows
    return min(row_block, total) if row_block > 0 \
        else auto_row_block(total, s, itemsize)


# ---------------------------------------------------------------------------
# the stream plan: per-block index bucketing, built on or off the hot path
# ---------------------------------------------------------------------------


class StreamPlan(NamedTuple):
    """Pre-bucketed indices of the reference's streamed kernel: eight int32
    leaves and the geometry they were built for.  sid/pos/inv/cum are
    (..., tiles, L); off/seg0/seg1 (..., tiles, nbmax); nblk (..., tiles,
    1).  ``pos[p]`` is the original flat position of planned entry p,
    ``inv`` its inverse, ``cum`` the compacted block of each planned
    position; ``rb``/``total_rows`` are the block height and row space the
    plan was built for, so a plan of another geometry cannot be consumed
    silently.  Leading axes (the microbatches of a forward) stack plans.
    Weights are not part of a plan, so a plan built from indices alone
    holds for any cache miss mask."""
    sid: torch.Tensor     # planned (block-grouped) flat row ids
    pos: torch.Tensor     # original position of each planned entry
    inv: torch.Tensor     # planned position of each original entry
    off: torch.Tensor     # clamped start row per compacted block
    seg0: torch.Tensor    # segment start per compacted block
    seg1: torch.Tensor    # segment end per compacted block
    nblk: torch.Tensor    # compacted (touched) block count
    cum: torch.Tensor     # compacted block index per planned position
    rb: int = 0
    total_rows: int = 0

    def map(self, fn) -> "StreamPlan":
        """The plan with ``fn`` applied to each of its eight leaves."""
        return StreamPlan(*(fn(a) for a in self[:N_PLAN_LEAVES]),
                          rb=self.rb, total_rows=self.total_rows)


def _resolve_plan_method(plan_method: str, L: int, nb_total: int,
                         tiles: int = 1) -> str:
    if plan_method == "auto":
        return "count" if tiles * L * nb_total <= PLAN_COUNT_WORK \
            else "sort"
    if plan_method not in ("sort", "count"):
        raise ValueError(f"plan_method must be 'sort', 'count' or 'auto', "
                         f"got {plan_method!r}")
    return plan_method


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(a, i, axis=-1)``."""
    return torch.gather(a, -1, i.long())


def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    """Invert a batch of permutations (tiles, L) with one flat scatter."""
    tiles, L = perm.shape
    flat = (perm.long() + torch.arange(tiles, device=perm.device)[:, None]
            * L).reshape(-1)
    out = torch.zeros(tiles * L, dtype=torch.int32, device=perm.device)
    out[flat] = _arange(L, perm).repeat(tiles)
    return out.reshape(tiles, L)


def _plan_sort(gid, rb: int, total_rows: int, nbmax: int) -> StreamPlan:
    """The comparison-sort builder: a stable argsort by row id (as
    ``jnp.argsort``), segments recovered by searchsorted over the
    block-change prefix sum."""
    tiles, L = gid.shape
    pos = torch.argsort(gid, dim=-1, stable=True).to(torch.int32)
    sid = _take(gid, pos)
    inv = _inverse_perm(pos)
    blk = sid // rb
    first = torch.cat([torch.ones((tiles, 1), dtype=torch.bool,
                                  device=gid.device),
                       blk[:, 1:] != blk[:, :-1]], dim=-1)
    cum = torch.cumsum(first, dim=-1, dtype=torch.int32) - 1
    nblk = cum[:, -1:] + 1
    jr = _arange(nbmax, gid).expand(tiles, nbmax).contiguous()
    seg0 = torch.searchsorted(cum, jr, out_int32=True)
    seg1 = torch.searchsorted(cum, jr, right=True, out_int32=True)
    bid = _take(blk, seg0.clamp(max=L - 1))
    off = (bid * rb).clamp(0, total_rows - rb)
    valid = jr < nblk
    zero = torch.zeros((), dtype=torch.int32, device=gid.device)
    return StreamPlan(sid, pos, inv, torch.where(valid, off, zero),
                      torch.where(valid, seg0, zero),
                      torch.where(valid, seg1, zero), nblk, cum,
                      rb=rb, total_rows=total_rows)


def _bucket_rank(key, nb_total: int):
    """(stable within-bucket rank, bucket histogram) of ``key`` (tiles, L)
    int32 in [0, nb_total): a one-hot running count per RANK_CHUNK chunk
    plus exclusive chunk offsets, as the reference computes it."""
    tiles, L = key.shape
    c = min(RANK_CHUNK, L)
    lp = -(-L // c) * c
    kp = torch.cat([key, torch.full((tiles, lp - L), nb_total,
                                    dtype=key.dtype, device=key.device)],
                   dim=-1)
    oh = (kp.reshape(tiles, lp // c, c)[..., None]
          == _arange(nb_total, key)).to(torch.int32)
    within = torch.cumsum(oh, dim=2, dtype=torch.int32)
    per = within[:, :, -1, :]
    coff = torch.cumsum(per, dim=1, dtype=torch.int32) - per
    run = (within + coff[:, :, None, :]).reshape(tiles, lp, nb_total)
    rank = torch.gather(run[:, :L], 2, key.long()[..., None])[..., 0] - 1
    hist = coff[:, -1] + per[:, -1]
    return rank, hist


def _plan_count(gid, rb: int, total_rows: int, nbmax: int) -> StreamPlan:
    """The counting-sort builder: bucket by block id.  The histogram's
    prefix sum is the segment-offset table and the within-bucket order is
    the original (stable) order.  The reference's drop-mode scatters onto
    the compacted blocks send empty buckets to a global out-of-range slot;
    here they land in one sink row past the end, which is cut off."""
    tiles, L = gid.shape
    nb_total = -(-total_rows // rb)
    key = gid // rb
    rank, hist = _bucket_rank(key, nb_total)
    excl = torch.cumsum(hist, dim=-1, dtype=torch.int32) - hist
    dest = _take(excl, key) + rank
    pos = _inverse_perm(dest)
    sid = _take(gid, pos)
    ne = hist > 0
    nblk = ne.sum(dim=-1, keepdim=True).to(torch.int32)
    cidx = torch.cumsum(ne, dim=-1, dtype=torch.int32) - 1
    sink = tiles * nbmax
    cflat = torch.where(ne, _arange(tiles, gid)[:, None] * nbmax + cidx,
                        sink).reshape(-1).long()

    def compact(vals):
        out = torch.zeros(sink + 1, dtype=torch.int32, device=gid.device)
        out[cflat] = vals.reshape(-1).to(torch.int32)
        return out[:sink].reshape(tiles, nbmax)

    bid = compact(_arange(nb_total, gid).expand(tiles, nb_total))
    seg0 = compact(excl)
    seg1 = compact(excl + hist)
    valid = _arange(nbmax, gid)[None, :] < nblk
    zero = torch.zeros((), dtype=torch.int32, device=gid.device)
    off = torch.where(valid, (bid * rb).clamp(0, total_rows - rb), zero)
    cum = _take(cidx, sid // rb)
    return StreamPlan(sid, pos, dest.to(torch.int32), off,
                      torch.where(valid, seg0, zero),
                      torch.where(valid, seg1, zero), nblk, cum,
                      rb=rb, total_rows=total_rows)


def _stream_plan(gid, rb: int, total_rows: int, nbmax: int,
                 plan_method: str = "auto") -> StreamPlan:
    """Pre-bucket a tile batch of flat row ids ``gid`` (tiles, L) int32 in
    [0, total_rows) per row block.  ``plan_method``: 'sort', 'count' or
    'auto' (count while tiles·L·blocks stays under PLAN_COUNT_WORK)."""
    tiles, L = gid.shape
    nb_total = -(-total_rows // rb)
    method = _resolve_plan_method(plan_method, L, nb_total, tiles)
    build = _plan_count if method == "count" else _plan_sort
    return build(gid, rb, total_rows, nbmax)


def build_stream_plan(total_rows: int, s: int, gid, *, row_tile: int,
                      rb: int, plan_method: str = "auto") -> StreamPlan:
    """A :class:`StreamPlan` for ``gid`` (..., n, hot) pre-clipped flat row
    ids, built outside the call that consumes it.  Each leading index (a
    forward's microbatches) gets a plan of its own, 'auto' resolved per
    plan as the reference's ``vmap`` does; the leaves stack on those
    axes."""
    *lead, n, hot = gid.shape
    _, tiles, n_pad, L, nbmax, _ = _stream_geometry(total_rows, s, n, hot,
                                                    row_tile, rb)
    gid = gid.to(torch.int32)
    if n_pad != n:
        gid = torch.cat([gid, gid.new_zeros((*lead, n_pad - n, hot))],
                        dim=-2)
    k = 1
    for d in lead:
        k *= d
    method = _resolve_plan_method(plan_method, L, -(-total_rows // rb),
                                  tiles)
    plan = _stream_plan(gid.reshape(k * tiles, L), rb, total_rows, nbmax,
                        method)
    return plan.map(lambda a: a.reshape(*lead, tiles, a.shape[-1]))


def _check_plan(plan, tiles: int, L: int, nbmax: int, rb: int,
                total_rows: int):
    """Raise unless ``plan`` has exactly this call's geometry."""
    if not isinstance(plan, StreamPlan):
        raise ValueError(f"plan= takes a StreamPlan, got "
                         f"{type(plan).__name__}")
    want = {"sid": (tiles, L), "pos": (tiles, L), "inv": (tiles, L),
            "off": (tiles, nbmax), "seg0": (tiles, nbmax),
            "seg1": (tiles, nbmax), "nblk": (tiles, 1), "cum": (tiles, L),
            "rb": rb, "total_rows": total_rows}
    got = {k: tuple(getattr(plan, k).shape)
           for k in want if k not in ("rb", "total_rows")}
    got.update(rb=plan.rb, total_rows=plan.total_rows)
    if got != want:
        raise ValueError(
            f"precomputed StreamPlan does not match this call's geometry: "
            f"want {want}, got {got} — build it with build_stream_plan/"
            f"stacked_stream_plan at the same batch/row_tile/row_block")


def _stacked_gid(t: int, r: int, idx):
    """Flat (T·R, s) row-space ids of a stacked (..., B, T, hot) index
    tensor: t·R + clip(idx)."""
    return (_arange(t, idx)[:, None] * r
            + idx.to(torch.int32).clamp(0, r - 1))


def stacked_stream_plan(t: int, r: int, s: int, itemsize: int, idx, *,
                        batch_tile: int = 64, row_block: int = 0,
                        plan_method: str = "auto"):
    """:func:`embedding_bag_stacked`'s StreamPlan from indices alone
    (..., B, T, hot), or None when this geometry resolves resident."""
    *lead, b, t2, hot = idx.shape
    if t != t2:
        raise ValueError(f"idx covers {t2} tables, the stack has {t}")
    rb = _stream_rb(t, r, s, itemsize, row_block)
    if rb is None:
        return None
    gid = _stacked_gid(t, r, idx)
    return build_stream_plan(t * r, s, gid.reshape(*lead, b * t, hot),
                             row_tile=batch_tile, rb=rb,
                             plan_method=plan_method)


def check_plan(plan, *, n_tables: int, rows: int, s: int, itemsize: int,
               n_bags: int, hot: int, tile: int, row_block: int) -> None:
    """Hold ``plan`` against the geometry of a call pooling ``n_bags`` bags
    of ``hot`` slots over ``n_tables`` tables of ``rows`` rows: raise
    ``ValueError`` when the call resolves resident (there is no plan to
    consume) or the plan was built for another geometry."""
    rb = _stream_rb(n_tables, rows, s, itemsize, row_block)
    if rb is None:
        raise ValueError("plan= only applies to the streamed regime "
                         "(this call resolved VMEM-resident)")
    _, tiles, _, L, nbmax, _ = _stream_geometry(n_tables * rows, s, n_bags,
                                                hot, tile, rb)
    _check_plan(plan, tiles, L, nbmax, rb, n_tables * rows)


def check_stacked_plan(plan, tables, idx, *, batch_tile: int = 64,
                       row_block: int = 0) -> None:
    """:func:`check_plan` for :func:`embedding_bag_stacked`'s call."""
    t, r, s = tables.shape
    b, _, hot = idx.shape
    check_plan(plan, n_tables=t, rows=r, s=s,
               itemsize=tables.element_size(), n_bags=b * t, hot=hot,
               tile=batch_tile, row_block=row_block)


def resolve_pool_mode(pool_mode: str) -> str:
    """'auto' -> 'vector', as in the reference; 'scalar' and 'vector' are
    the TPU's two pooling loops, both served by the one CUDA kernel."""
    if pool_mode == "auto":
        return "vector"
    if pool_mode not in ("scalar", "vector"):
        raise ValueError(f"pool_mode must be 'scalar', 'vector' or 'auto', "
                         f"got {pool_mode!r}")
    return pool_mode


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"embedding bags run on 'cpu' or 'cuda' tensors, "
                     f"got {t.device}")


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pool_rows(table_flat, idx, w, *, rows: int, n_tables: int, tid=None):
    """The CUDA kernel: table_flat (n_tables·rows, s) float32, idx (N, hot)
    int32, w (N, hot) float32 and optionally tid (N,) int32 -> (N, s).
    Bag n pools against table tid[n], or n % n_tables without tid; ids are
    clamped to [0, rows-1] and table ids to [0, n_tables-1] in the kernel.
    Raises for anything but contiguous CUDA tensors of those types."""
    dev = table_flat.device
    if dev.type != "cuda":
        raise RuntimeError(f"pool_rows launches a CUDA kernel; got a tensor "
                           f"on {dev}")
    if table_flat.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA bag kernel takes float32 tables, got "
            f"{table_flat.dtype} (bf16 tables: ROADMAP B-section)")
    n, hot = idx.shape
    s = table_flat.shape[1]
    _check("table_flat", table_flat, torch.float32, (n_tables * rows, s),
           dev)
    _check("idx", idx, torch.int32, (n, hot), dev)
    _check("w", w, torch.float32, (n, hot), dev)
    if tid is not None:
        _check("tid", tid, torch.int32, (n,), dev)
    if rows < 1 or n_tables < 1:
        raise ValueError(f"empty table stack ({n_tables} x {rows} rows)")
    if table_flat.data_ptr() % 16:
        raise ValueError("table_flat must be 16-byte aligned")
    out = torch.empty((n, s), dtype=torch.float32, device=dev)
    if n == 0 or s == 0:
        return out
    with torch.cuda.device(dev):
        POOL(table_flat.data_ptr(), idx.data_ptr(), w.data_ptr(),
             None if tid is None else tid.data_ptr(), out.data_ptr(),
             n, hot, s, rows, n_tables,
             torch.cuda.current_stream(dev).cuda_stream,
             key=launch_key(n, hot, s, n_tables, tid is not None))
    return out


def _flat(tables):
    """(T, R, s) -> the (T·R, s) row space, as a view: a stack that is not
    contiguous raises here rather than being copied whole."""
    t, r, s = tables.shape
    return tables.view(t * r, s)


def _ids(idx):
    return idx.to(torch.int32).contiguous()


def _weights(mask):
    return mask.to(torch.float32).contiguous()


def embedding_bag(table, idx, mask, *, batch_tile: int = 64,
                  row_block: int = 0, pool_mode: str = "auto", plan=None):
    """table:(R,S) idx:(B,hot) mask:(B,hot) -> (B,S).  ``batch_tile`` is
    the TPU grid tile and has no counterpart (the kernel plans its own
    grid); with ``plan`` it is the tile the plan was built for."""
    check_row_block(row_block)
    resolve_pool_mode(pool_mode)
    if plan is not None:
        r, s = table.shape
        check_plan(plan, n_tables=1, rows=r, s=s,
                   itemsize=table.element_size(), n_bags=idx.shape[0],
                   hot=idx.shape[1], tile=batch_tile, row_block=row_block)
    if _on_cpu(table):
        return ref.embedding_bag_ref(table, idx, mask)
    r, _ = table.shape
    return pool_rows(table, _ids(idx), _weights(mask), rows=r, n_tables=1)


def embedding_bag_stacked(tables, idx, mask, *, batch_tile: int = 64,
                          row_block: int = 0, pool_mode: str = "auto",
                          plan=None):
    """tables:(T,R,s) idx:(B,T,hot) mask:(B,T,hot) -> (B,T,s), the
    model-facing form of ``apply_emb``.  Bag (b, t) is row b·T + t of the
    flattened index list, so its table is that row's index mod T.
    ``plan`` (a :func:`stacked_stream_plan`) is checked against the call
    and changes nothing else."""
    check_row_block(row_block)
    resolve_pool_mode(pool_mode)
    t, r, s = tables.shape
    b, t2, hot = idx.shape
    if t != t2:
        raise ValueError(f"idx covers {t2} tables, the stack has {t}")
    if plan is not None:
        check_stacked_plan(plan, tables, idx, batch_tile=batch_tile,
                           row_block=row_block)
    if _on_cpu(tables):
        return ref.embedding_bag_stacked_ref(tables, idx, mask)
    out = pool_rows(_flat(tables), _ids(idx).reshape(b * t, hot),
                    _weights(mask).reshape(b * t, hot), rows=r, n_tables=t)
    return out.reshape(b, t, s)


def embedding_bag_rows(tables, tid, idx, mask, *, row_tile: int = 64,
                       row_block: int = 0, pool_mode: str = "auto"):
    """tables:(T,R,s) tid:(N,) idx/mask:(N,hot) -> (N,s) masked sums, each
    row pooled against its own table (the pool half of the ragged
    exchange)."""
    check_row_block(row_block)
    resolve_pool_mode(pool_mode)
    t, r, _ = tables.shape
    if _on_cpu(tables):
        return ref.embedding_bag_rows_ref(tables, tid, idx, mask)
    return pool_rows(_flat(tables), _ids(idx), _weights(mask),
                     rows=r, n_tables=t, tid=_ids(tid))
