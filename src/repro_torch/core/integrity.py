"""Shared integrity primitives (the port of ``repro/core/integrity.py``):
ONE checksum fold for every payload that crosses a trust boundary.

  * ``row_checksum``        — the host (numpy) fold.  The row's bytes
    weighted by ``(i mod 251) + 1``, plus the row's identity (flat gid and
    version) mixed in with Knuth's multiplicative constants, wrapped at
    2^32.  The source stamps it and the receiving host verifies the exact
    bytes that arrived, so a flipped byte, a row delivered to the wrong
    gid or the wrong version rejects;
  * ``row_checksum_device`` — the same fold in torch on the rows' device.
    Torch has little uint32 arithmetic and ``sum`` promotes, so the fold
    runs in int32 (byte x weight, at most 255 x 251 a byte) and int64 (the
    row sums and the identity mixing), then masks with ``& 0xFFFFFFFF``:
    congruent mod 2^32 to the host's uint64-then-mask, so either side
    verifies the other's stamp;
  * ``fold_rows`` / ``fold_blocks`` / ``fold_cache_slots`` — the
    scrubber's audit folds on the card, in chunks of rows so the widened
    bytes stay a few hundred MB at full width;
  * ``IntegrityLedger`` — expected per-(table, row-block) checksums in
    ORIGINAL table space, re-folded in O(1) on every authorized write;
    :func:`device_ledger` builds it (and the per-row shadow) with the
    audit's own fold on the card, so only the words come to the host;
  * ``wire_fold`` / ``wire_stamp`` / ``wire_verify`` — the per-destination
    checksum of the fused wire slot, the checksum field's own bytes
    zero-weighted so the stamp does not perturb what it protects.

The words must stay the reference's word for word: both packages verify
each other's stamps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_CS_GID = np.uint64(2654435761)      # Knuth multiplicative constants: mix
_CS_VER = np.uint64(2654435789)      # identity into the byte sum
_CS_MASK = np.uint64(0xFFFFFFFF)
_CS_MOD = 1 << 32
_MASK = 0xFFFFFFFF
# rows folded at once on the device: their widened bytes (int32) stay at
# 256 MB for 64-float rows
FOLD_CHUNK_ROWS = 1 << 18


def row_checksum(vec, gid, ver):
    """Per-row uint32 checksum over the row's wire bytes plus its identity.

    ``vec``: (..., s) array of any fixed-width dtype; ``gid``/``ver``
    broadcast against the leading shape.  Every weight is nonzero, so a
    single-byte flip changes the sum by a nonzero amount < 2^16, which the
    2^32 mask keeps; byte swaps change it too.  Pure numpy on the host."""
    v = np.ascontiguousarray(vec)
    u8 = v.view(np.uint8).reshape(v.shape[:-1] + (-1,)).astype(np.uint64)
    w = (np.arange(u8.shape[-1], dtype=np.uint64) % np.uint64(251)
         + np.uint64(1))
    s = (u8 * w).sum(axis=-1)
    s = s + _CS_GID * np.asarray(gid, np.uint64) \
        + _CS_VER * np.asarray(ver, np.uint64)
    return (s & _CS_MASK).astype(np.uint32)


def to_u32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the same words as a uint32 tensor."""
    return (words - ((words >> 31) << 32)).to(torch.int32) \
        .view(torch.uint32)


def words_of(u32: torch.Tensor) -> torch.Tensor:
    """A uint32 tensor -> its words as int64 in [0, 2^32)."""
    return u32.view(torch.int32).to(torch.int64) & _MASK


def _byte_weights(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device) % 251 + 1


def _byte_fold(vec: torch.Tensor) -> torch.Tensor:
    """(n, s) rows -> (n,) int64 position-weighted byte sums."""
    b = vec.contiguous().view(torch.uint8).reshape(vec.shape[0], -1)
    w = _byte_weights(b.shape[1], b.device)
    return (b.to(torch.int32) * w).sum(dim=1, dtype=torch.int64)


def _mix(s: torch.Tensor, gid, ver) -> torch.Tensor:
    gid = torch.as_tensor(gid, device=s.device).to(torch.int64)
    ver = torch.as_tensor(ver, device=s.device).to(torch.int64)
    return (s + 2654435761 * gid + 2654435789 * ver) & _MASK


def row_checksum_device(vec, gid, ver):
    """The device replica of :func:`row_checksum`: ``vec`` (n, s) on any
    device, ``gid``/``ver`` broadcast to (n,).  Returns (n,) uint32."""
    return to_u32(_mix(_byte_fold(vec), gid, ver))


# ---------------------------------------------------------------------------
# blocked audit folds (the scrubber's device half)
# ---------------------------------------------------------------------------


def _fold_rows_words(tables, phys_t, offs, orig_t) -> torch.Tensor:
    """(nb, bk) int64 per-row words of the audited blocks, padding rows
    (offsets >= R) 0; folded in chunks of rows."""
    r = tables.shape[1]
    dev = tables.device
    phys_t = torch.as_tensor(phys_t, dtype=torch.int64).to(dev)
    offs = torch.as_tensor(offs, dtype=torch.int64).to(dev)
    orig_t = torch.as_tensor(orig_t, dtype=torch.int64).to(dev)
    nb, bk = offs.shape
    tab = phys_t[:, None].expand(nb, bk).reshape(-1)
    off = offs.reshape(-1)
    gid = (orig_t[:, None] * r + offs).reshape(-1)
    valid = off < r
    out = torch.empty(nb * bk, dtype=torch.int64, device=dev)
    for lo in range(0, nb * bk, FOLD_CHUNK_ROWS):
        sl = slice(lo, lo + FOLD_CHUNK_ROWS)
        rows = tables[tab[sl], off[sl].clamp(max=r - 1)]
        out[sl] = _mix(_byte_fold(rows), gid[sl], 0)
    return torch.where(valid, out, 0).reshape(nb, bk)


def fold_rows(tables, phys_t, offs, orig_t):
    """Per-row checksums for a batch of blocks.

    ``tables``: (t_pad, R, s) the live (physical-order) stack; ``phys_t``
    (nb,) the physical slot each audited block lives in now; ``offs`` (nb,
    bk) row offsets (entries >= R are padding and fold to 0); ``orig_t``
    (nb,) the ORIGINAL table id: the identity is ``orig_t * R + off``, so
    the ledger survives resharding.  Returns (nb, bk) uint32."""
    return to_u32(_fold_rows_words(tables, phys_t, offs, orig_t))


def fold_blocks(tables, phys_t, offs, orig_t):
    """Block checksums = per-row checksums summed mod 2^32, (nb,) uint32:
    a sum, so replacing one row shifts its block by (new − old)."""
    w = _fold_rows_words(tables, phys_t, offs, orig_t)
    return to_u32(w.sum(dim=1) & _MASK)


def fold_cache_slots(hot_rows, hot_ids, tables, t_sel, c_sel):
    """Cache-slot audit: does slot (t, c) still hold exactly the bytes of
    its base row?  Compares the checksums of the cached copy and of the
    resident base row (not float ==, which would miss a sign flip on 0.0
    and trip on NaN).  Returns (ids, ok): the slot's row id (−1 =
    unmapped, vacuously ok) and the bitwise-match flag."""
    dev = hot_rows.device
    t_sel = torch.as_tensor(t_sel, dtype=torch.int64).to(dev)
    c_sel = torch.as_tensor(c_sel, dtype=torch.int64).to(dev)
    ids = hot_ids[t_sel, c_sel]
    r = tables.shape[1]
    cached = hot_rows[t_sel, c_sel]
    base = tables[t_sel, ids.long().clamp(0, r - 1)]
    ok = (_byte_fold(cached) == _byte_fold(base)) | (ids < 0)
    return ids, ok


# ---------------------------------------------------------------------------
# IntegrityLedger: host-side expected block checksums
# ---------------------------------------------------------------------------


def _host_block_sums(rcs: np.ndarray, block_rows: int) -> np.ndarray:
    """(R,) per-row uint32 checksums → (nb,) blocked sums mod 2^32."""
    r = rcs.shape[0]
    nb = -(-r // block_rows)
    pad = np.zeros(nb * block_rows, np.uint64)
    pad[:r] = rcs.astype(np.uint64)
    return (pad.reshape(nb, block_rows).sum(axis=1)
            & _CS_MASK).astype(np.uint32)


@dataclasses.dataclass
class IntegrityLedger:
    """Expected block checksums for the whole (padded) table stack, in
    ORIGINAL table space.  ``block_cs[t, b]`` covers original rows
    ``[b*block_rows, min((b+1)*block_rows, R))`` of original table t.
    Established once at load; ``note_update`` re-folds a single row's
    contribution in O(1) when an authorized write (freshness apply, scrub
    repair) lands.  Reshard cutovers permute PHYSICAL slots only, so the
    ledger never moves."""
    block_rows: int
    n_rows: int                      # R (padded per-table row count)
    block_cs: np.ndarray             # (t_pad, nb) uint32

    @classmethod
    def from_tables(cls, tables: np.ndarray, block_rows: int
                    ) -> "IntegrityLedger":
        """``tables``: (t_pad, R, s) host array in ORIGINAL order."""
        t_pad, r = tables.shape[:2]
        gids = (np.arange(t_pad)[:, None] * r + np.arange(r)[None, :])
        rcs = row_checksum(tables, gids, 0)              # (t_pad, R)
        cs = np.stack([_host_block_sums(rcs[t], block_rows)
                       for t in range(t_pad)])
        return cls(block_rows=block_rows, n_rows=r, block_cs=cs)

    @property
    def n_blocks(self) -> int:
        return self.block_cs.shape[1]

    def block_of(self, gid: int):
        t, row = divmod(int(gid), self.n_rows)
        return t, row // self.block_rows

    def note_update(self, gid: int, old_vec, new_vec) -> None:
        """O(1) incremental refold when row ``gid`` is overwritten."""
        t, b = self.block_of(gid)
        old_cs = int(row_checksum(np.asarray(old_vec), gid, 0))
        new_cs = int(row_checksum(np.asarray(new_vec), gid, 0))
        cur = int(self.block_cs[t, b])
        self.block_cs[t, b] = np.uint32((cur - old_cs + new_cs) % _CS_MOD)

    def expected(self, orig_t, blk) -> np.ndarray:
        return self.block_cs[np.asarray(orig_t), np.asarray(blk)]

    def refit(self, tables: np.ndarray) -> "IntegrityLedger":
        """Rebuild for a new geometry (post-evict t_pad change)."""
        return IntegrityLedger.from_tables(tables, self.block_rows)


def device_ledger(tables: torch.Tensor, block_rows: int, *, inv=None):
    """(per-row shadow (t_pad, R) uint32, :class:`IntegrityLedger`) of a
    stack in ORIGINAL table space, folded on the stack's device with the
    audit's fold (:func:`fold_rows`), table by table: only the shadow and
    the block words come to the host (the host fold widens every byte to
    uint64, ~8x the stack).  ``inv`` (original -> physical slot) reads a
    stack stored under a placement.  Equal to
    :meth:`IntegrityLedger.from_tables` on the original-order stack."""
    t_pad, r = tables.shape[:2]
    nb = -(-r // block_rows)
    offs = torch.arange(nb * block_rows, device=tables.device)[None]
    row_cs = np.empty((t_pad, r), np.uint32)
    block_cs = np.empty((t_pad, nb), np.uint32)
    for t in range(t_pad):
        phys = int(inv[t]) if inv is not None else t
        # offsets past R are padding and fold to 0
        w = _fold_rows_words(tables, [phys], offs, [t])[0]
        bsum = w.reshape(nb, block_rows).sum(dim=1) & _MASK
        row_cs[t] = to_u32(w[:r]).cpu().numpy()
        block_cs[t] = to_u32(bsum).cpu().numpy()
    return row_cs, IntegrityLedger(block_rows=int(block_rows), n_rows=r,
                                   block_cs=block_cs)


def compact_mismatches(bad: torch.Tensor, cols, k: int) -> torch.Tensor:
    """The first ``k`` flagged entries of ``bad`` (any shape, bool), in
    flat order, without a host round trip: a (1 + k * len(cols),) int32
    vector, the flagged count, then each of ``cols`` (``bad``'s shape, any
    integer type, truncated to int32) at those entries, −1 padded.  A
    count above ``k`` says entries were left out."""
    f = bad.reshape(-1)
    # the flagged entries first, each group in flat order (a stable sort
    # of 0/1 keys)
    order = torch.sort(f.logical_not().to(torch.uint8), stable=True)[1]
    sel = order[:k]
    keep = f[sel]
    out = [f.sum(dtype=torch.int64).to(torch.int32).reshape(1)]
    for c in cols:
        v = c.reshape(-1)[sel].to(torch.int32)
        v = torch.where(keep, v, torch.full_like(v, -1))
        if v.numel() < k:
            v = torch.cat([v, v.new_full((k - v.numel(),), -1)])
        out.append(v)
    return torch.cat(out)


# ---------------------------------------------------------------------------
# end-to-end wire verification (the "wcs" field)
# ---------------------------------------------------------------------------


def wire_fold(buf: torch.Tensor, skip_off: int, skip_len: int):
    """Checksum a fused wire slot's bytes with [skip_off, skip_off +
    skip_len) ZERO-weighted (where the stamp lives).  ``buf`` (..., nb)
    uint8; returns (...,) int64 words.  The weights of ``row_checksum``,
    no identity mixing (the slot position fixes src and dst)."""
    pos = torch.arange(buf.shape[-1], dtype=torch.int64, device=buf.device)
    w = pos % 251 + 1
    w[skip_off:skip_off + skip_len] = 0
    return (buf.to(torch.int64) * w).sum(dim=-1) & _MASK


def wire_stamp(buf: torch.Tensor, layout) -> torch.Tensor:
    """Stamp every destination row of a fused (P, slot_bytes) buffer with
    its segment checksum in the layout's ``wcs`` field, in place; returns
    ``buf``."""
    off = layout.field("wcs").offset
    cs = to_u32(wire_fold(buf, off, 4))
    buf[:, off:off + 4] = cs.view(torch.uint8).reshape(-1, 4)
    return buf


def wire_verify(buf: torch.Tensor, layout) -> torch.Tensor:
    """Recompute a received slot's fold and compare with its stamp:
    ``buf`` (..., slot_bytes) -> (...,) bool."""
    off = layout.field("wcs").offset
    got = wire_fold(buf, off, 4)
    want = buf[..., off:off + 4].contiguous().view(torch.uint32)
    return got == words_of(want).reshape(got.shape)
