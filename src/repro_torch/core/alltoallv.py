"""alltoallv on ``torch.distributed``: the ragged exchange as counts plus a
bucket-padded payload (the port of ``repro/core/alltoallv.py``).

Collectives move fixed shapes, so the paper's variable message sizes
become padding: each (source, destination) pair gets a fixed ``cap``-row
bucket plus an exchanged count.  ``dispatch_stats`` measures the padding.

Wire codecs (:func:`encode_wire` / :func:`decode_wire`) compress the
pooled payload: bf16 halves the exchanged bytes, int8 with a per-row bf16
scale quarters them.  Given the same float32 inputs both give the
reference's bytes: bf16 rounds to nearest even, int8 rounds half to even
against the up-nudged bf16 scale.

The ragged pooled exchange packs the live pooled rows into cap-padded
per-destination buckets (:func:`pack_ragged_segments`), ships them with
their counts and scatters them back densely on the receive side
(:func:`unpack_ragged`).  Overflowing a bucket drops rows; every packing
path returns the drop count.

The fused wire collapses the exchange to ONE collective: ``fuse_wire``
bitcasts every payload leaf (codec rows, scales, slot ids, counts) into
one contiguous ``(P, slot_bytes)`` uint8 bucket per destination under a
static ``WireLayout`` (fields sorted by name, packed back to back, the slot
padded to 4 bytes), so one exchange is one ``all_to_all_single``
(:func:`alltoallv_fused`).  Bytes move by ``.view(torch.uint8)``, never by
a value cast, so the fused buffer is byte-identical to the reference's.
:func:`ring_exchange` decomposes that collective into P−1 rounds of
``isend``/``irecv``, posting round r+1 before round r's chunk is consumed.

Out-of-range targets are masked explicitly where the reference leans on
``mode="drop"`` scatters: torch indexing would raise or wrap.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.bls import Issued

WIRE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
# bytes of per-row side data: int8 ships one bf16 scale per pooled vector
WIRE_SCALE_BYTES = {"float32": 0, "bfloat16": 0, "int8": 2}
_WIRE_ALIASES = {None: "float32", "f32": "float32", "bf16": "bfloat16"}

# the fused slot is padded to a word multiple so the uint8 buffer can be
# re-viewed as int32 words by transports that prefer them
WIRE_ALIGN = 4

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64,
           "uint32": torch.uint32}


@dataclasses.dataclass(frozen=True)
class A2AVStats:
    payload_bytes: int      # bytes actually exchanged (padded buffers)
    useful_bytes: int       # bytes of real (non-padding) rows
    padding_fraction: float


def _dtype_name(dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"unsupported wire dtype {dtype!r}")
    return name


def _tree_map(fn, tree):
    """``fn`` over a tensor or the values of a dict of tensors."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def to_numpy(a) -> np.ndarray:
    """A tensor (on any device) or an array-like as a host numpy array.
    numpy has no bf16: a bf16 tensor comes back as its raw 16-bit
    patterns, ``np.uint16`` (the bytes a wire or a checksum sees)."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    a = a.detach().cpu()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view(np.uint16)
    return a.numpy()


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a host copy of ``dtype`` elements takes: its own,
    or ``np.uint16`` bit patterns for bf16."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=dtype).numpy().dtype


def round_to_host(a, dtype: torch.dtype) -> np.ndarray:
    """Values (any real array) rounded once to ``dtype`` (to nearest, ties
    to even, as a cast on either framework rounds), as a host array of
    :func:`host_dtype`: a bf16 row ships as its 16-bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)
    return to_numpy(t)


def from_host(a, dtype=None) -> torch.Tensor:
    """A host array as a CPU tensor, the inverse of :func:`to_numpy`: a
    ``np.uint16`` copy of bf16 rows, for a bf16 ``dtype``, and an array of
    numpy's ``bfloat16`` extension type (known by its name: the port does
    not import the package that defines it) come back as the bf16 bits
    they hold; any other array is converted to ``dtype`` (kept as it is
    without one).  Shares the array's memory where no conversion is
    needed."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16" or (dtype == torch.bfloat16
                                      and a.dtype == np.uint16):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def canon_wire(wire_dtype) -> str:
    """Normalize a wire-dtype spelling to the canonical codec name."""
    wire = _WIRE_ALIASES.get(wire_dtype, wire_dtype)
    if wire not in WIRE_ITEMSIZE:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    return wire


# ---------------------------------------------------------------------------
# wire codecs for the pooled exchange
# ---------------------------------------------------------------------------


def encode_wire(x: torch.Tensor, wire_dtype: str = "float32") -> dict:
    """x (..., D) -> codec payload whose leaves keep the leading axes of x.

    float32 ships x verbatim; bf16 rounds to nearest even; int8 carries one
    bf16 scale per pooled vector, ``max(|x|, 1e-12) / 127`` nudged up by
    one bf16 ulp before the down-cast so quantizing against the stored
    scale never pushes |q| past 127, and rounds half to even."""
    wire = canon_wire(wire_dtype)
    if wire == "float32":
        return {"q": x}
    if wire == "bfloat16":
        return {"q": x.to(torch.bfloat16)}
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True),
                        min=1e-12) / 127.0
    scale = (scale * (1.0 + 2.0 ** -7)).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / scale.to(torch.float32)),
                    -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def decode_wire(payload: dict, out_dtype=torch.float32) -> torch.Tensor:
    q = payload["q"]
    if "scale" in payload:
        return (q.to(torch.float32) *
                payload["scale"].to(torch.float32)).to(out_dtype)
    return q.to(out_dtype)


def butterfly_pooled(x: torch.Tensor, group=None,
                     wire_dtype: str = "float32") -> torch.Tensor:
    """Reference-DLRM butterfly: x (B, T_local, D) per member, batch split
    and table concat -> (B / P, T_local · P, D), through ``wire_dtype``'s
    codec.  Each leaf moves as bytes through one ``all_to_all_single``."""
    p = dist.get_world_size(group)
    b = x.shape[0]
    out = {}
    for name, a in encode_wire(x, wire_dtype).items():
        send = a.reshape(p, b // p, *a.shape[1:]).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv.view(torch.uint8).reshape(p, -1),
                               send.view(torch.uint8).reshape(p, -1),
                               group=group)
        # (P_src, B/P, T_loc, ...) -> (B/P, P·T_loc, ...)
        out[name] = recv.transpose(0, 1).reshape(
            b // p, p * a.shape[1], *a.shape[2:])
    return decode_wire(out, x.dtype)


# ---------------------------------------------------------------------------
# fused single-buffer wire
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WireField:
    """One leaf of the fused wire slot: ``shape`` is per-destination (no
    leading n_dest axis); ``offset``/``nbytes`` locate its bytes in the
    slot."""
    name: str
    offset: int
    shape: tuple
    dtype: str

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * _DTYPES[self.dtype].itemsize


@dataclasses.dataclass(frozen=True)
class WireLayout:
    """Static layout of a fused exchange buffer: ``n_dest`` slots of
    ``slot_bytes`` bytes, each holding every payload leaf at a fixed
    offset."""
    n_dest: int
    fields: tuple  # of WireField, offset-ordered
    slot_bytes: int

    def field(self, name: str) -> WireField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"wire layout has no field {name!r}; "
                       f"have {[f.name for f in self.fields]}")

    @property
    def names(self) -> tuple:
        return tuple(f.name for f in self.fields)

    @property
    def wire_bytes(self) -> int:
        """Bytes the fused exchange physically moves per member, layout
        padding included: ONE (P, slot_bytes) buffer, nothing else."""
        return self.n_dest * self.slot_bytes


def wire_layout(n_dest: int, fields: dict) -> WireLayout:
    """Build a WireLayout from ``{name: (per_dest_shape, dtype)}``: fields
    in name order, offsets back to back, the slot padded up to
    ``WIRE_ALIGN`` bytes."""
    out, off = [], 0
    for name in sorted(fields):
        shape, dtype = fields[name]
        f = WireField(name, off, tuple(int(d) for d in shape),
                      _dtype_name(dtype))
        out.append(f)
        off += f.nbytes
    slot = -(-off // WIRE_ALIGN) * WIRE_ALIGN
    return WireLayout(int(n_dest), tuple(out), slot)


def fuse_wire(payload: dict, layout: WireLayout) -> torch.Tensor:
    """Pack a ``{name: (n_dest, ...)}`` payload into ONE contiguous
    ``(n_dest, slot_bytes)`` uint8 buffer per the layout (bitcasts only).
    A one-field layout without padding is a zero-copy view."""
    if sorted(payload) != sorted(layout.names):
        raise ValueError(f"payload fields {sorted(payload)} != layout "
                         f"fields {sorted(layout.names)}")
    parts = []
    for f in layout.fields:
        a = payload[f.name]
        if a.shape[0] != layout.n_dest:
            raise ValueError(
                f"field {f.name!r}: leading dim {a.shape[0]} != n_dest "
                f"{layout.n_dest}")
        if a.dtype != _DTYPES[f.dtype]:
            raise ValueError(f"field {f.name!r}: dtype {a.dtype} != layout "
                             f"{f.dtype}")
        b = a.contiguous().reshape(a.shape[0], -1).view(torch.uint8)
        if b.shape[1] != f.nbytes:
            raise ValueError(f"field {f.name!r}: {b.shape[1]} B != layout "
                             f"{f.nbytes} B (shape {tuple(a.shape)} vs "
                             f"{f.shape})")
        parts.append(b)
    pad = layout.slot_bytes - sum(f.nbytes for f in layout.fields)
    if pad:
        parts.append(torch.zeros((layout.n_dest, pad), dtype=torch.uint8,
                                 device=parts[0].device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def defuse_wire(buf: torch.Tensor, layout: WireLayout) -> dict:
    """Unpack a fused ``(n_src, slot_bytes)`` buffer (or one
    ``(slot_bytes,)`` chunk) back into its ``{name: leaf}`` payload."""
    single = buf.dim() == 1
    if single:
        buf = buf[None]
    if buf.shape[-1] != layout.slot_bytes:
        raise ValueError(f"buffer slot is {buf.shape[-1]} B, layout says "
                         f"{layout.slot_bytes} B")
    out = {}
    for f in layout.fields:
        b = buf[:, f.offset:f.offset + f.nbytes]
        dt = _DTYPES[f.dtype]
        if not b.is_contiguous() or b.storage_offset() % dt.itemsize:
            # a bitcast view needs contiguous, itemsize-aligned bytes
            b = b.clone(memory_format=torch.contiguous_format)
        leaf = b.view(dt).reshape((buf.shape[0],) + f.shape)
        out[f.name] = leaf[0] if single else leaf
    return out


def slot_id_dtype(n_slots: int):
    """Narrowest signed dtype addressing ``n_slots`` ragged-exchange slots
    (int16 when it fits, int32 above): ids ship narrow and widen only after
    the exchange."""
    return torch.int16 if n_slots <= 2 ** 15 else torch.int32


def exchange_wire_layout(*, ragged: bool, n_dest: int, cap: int, bs: int,
                         t_loc: int, embed_dim: int,
                         wire_dtype: str = "float32",
                         emb_dtype=torch.float32, n_slots: int = 0,
                         delta_bytes: int = 0, mig_bytes: int = 0,
                         rep_bytes: int = 0,
                         wire_check: bool = False) -> WireLayout:
    """The ONE layout both halves of a DLRM exchange agree on.

    ragged: per destination ``cap`` codec rows, narrow slot ids and an
    int32 count.  dense: the destination's full ``(bs, t_loc)`` pooled
    block.  int8 adds its per-row bf16 ``scale``.  ``emb_dtype`` is what a
    float32 codec ships verbatim; ``n_slots`` (default bs·t_loc) picks the
    id width.  ``delta_bytes``, ``mig_bytes`` and ``rep_bytes`` add the
    opaque rider fields ``xdelta``, ``xmig`` and ``xrep``; ``wire_check``
    adds the uint32 segment checksum ``wcs`` (``models/dlrm.py`` fills
    them)."""
    wire = canon_wire(wire_dtype)
    qdt = {"float32": emb_dtype, "bfloat16": torch.bfloat16,
           "int8": torch.int8}[wire]
    if ragged:
        fields = {"q": ((cap, embed_dim), qdt),
                  "ids": ((cap,), slot_id_dtype(n_slots or bs * t_loc)),
                  "counts": ((1,), torch.int32)}
        if wire == "int8":
            fields["scale"] = ((cap, 1), torch.bfloat16)
    else:
        fields = {"q": ((bs, t_loc, embed_dim), qdt)}
        if wire == "int8":
            fields["scale"] = ((bs, t_loc, 1), torch.bfloat16)
    if delta_bytes:
        fields["xdelta"] = ((int(delta_bytes),), torch.uint8)
    if mig_bytes:
        fields["xmig"] = ((int(mig_bytes),), torch.uint8)
    if rep_bytes:
        fields["xrep"] = ((int(rep_bytes),), torch.uint8)
    if wire_check:
        fields["wcs"] = ((1,), torch.uint32)
    return wire_layout(n_dest, fields)


def delta_wire_layout(n_dest: int, cap: int, embed_dim: int,
                      emb_dtype=torch.float32) -> WireLayout:
    """Sub-layout of the versioned row-delta blob (``xdelta``): up to
    ``cap`` rows, their flat gids, per-row checksums, the count and the
    version."""
    return wire_layout(n_dest, {
        "dvec": ((cap, embed_dim), emb_dtype),
        "dgid": ((cap,), torch.int32),
        "dcs": ((cap,), torch.uint32),
        "dcnt": ((1,), torch.int32),
        "dver": ((1,), torch.int32),
    })


def mig_wire_layout(n_dest: int, cap: int, embed_dim: int,
                    emb_dtype=torch.float32) -> WireLayout:
    """Sub-layout of the live-resharding blob (``xmig``): up to ``cap``
    rows, their original flat gids, checksums, the count and the
    migration epoch."""
    return wire_layout(n_dest, {
        "mvec": ((cap, embed_dim), emb_dtype),
        "mgid": ((cap,), torch.int32),
        "mcs": ((cap,), torch.uint32),
        "mcnt": ((1,), torch.int32),
        "mepoch": ((1,), torch.int32),
    })


def rep_wire_layout(n_dest: int, cap: int, embed_dim: int,
                    emb_dtype=torch.float32) -> WireLayout:
    """Sub-layout of the integrity-repair blob (``xrep``): up to ``cap``
    known-good rows, their original flat gids, checksums and the count."""
    return wire_layout(n_dest, {
        "rvec": ((cap, embed_dim), emb_dtype),
        "rgid": ((cap,), torch.int32),
        "rcs": ((cap,), torch.uint32),
        "rcnt": ((1,), torch.int32),
    })


def alltoallv_fused(buf: torch.Tensor, group=None) -> Issued:
    """Issue the whole exchange as ONE ``all_to_all_single``: buf
    (P, slot_bytes) uint8, destination-major.  Returns the in-flight
    exchange; its ``wait()`` gives the (P, slot_bytes) buffer whose row q
    holds what source q sent here."""
    recv = torch.empty_like(buf)
    work = dist.all_to_all_single(recv, buf, group=group, async_op=True)
    return Issued(recv, work, keep=buf)


def ring_exchange(buf: torch.Tensor, group, n_dest: int, consume, init):
    """The fused exchange as P−1 point-to-point rounds with per-peer
    consumption.

    buf (P, slot_bytes) destination-major; ``consume(carry, src, chunk)``
    folds one source's ``(slot_bytes,)`` chunk into the carry.  Round r
    (r = 1..P−1) sends slot (m+r) mod P to member (m+r) mod P and receives
    source (m−r) mod P's chunk; round r+1 is posted before round r's chunk
    is consumed, so decoding a chunk overlaps the next one's flight.  The
    own chunk never touches the wire and is consumed first, while round 1
    flies.  Consumption order is m, m−1, …, so ``consume`` must not depend
    on it (the DLRM consumers write disjoint table slices, which is why the
    result is bit-identical to the monolithic exchange)."""
    p = int(n_dest)
    m = dist.get_rank(group)

    def post(r):
        dst, src = (m + r) % p, (m - r) % p
        chunk = torch.empty_like(buf[0])
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf[dst],
                       dist.get_global_rank(group, dst), group),
            dist.P2POp(dist.irecv, chunk,
                       dist.get_global_rank(group, src), group)])
        return src, chunk, works

    flight = post(1) if p > 1 else None
    out = consume(init, m, buf[m])
    for r in range(1, p):
        src, chunk, works = flight
        for w in works:
            w.wait()
        flight = post(r + 1) if r + 1 < p else None
        out = consume(out, src, chunk)
    return out


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WireStats:
    """Byte accounting for one pooled butterfly exchange."""
    dense_bytes: int     # bytes the padded dense exchange moves at this codec
    live_bytes: int      # bytes of rows that carry information (>=1 miss)
    ref_bytes: int       # the f32 dense reference exchange
    live_rows: int
    total_rows: int

    @property
    def reduction_vs_ref(self) -> float:
        return 1.0 - self.live_bytes / max(self.ref_bytes, 1)


def wire_stats(miss_mask, embed_dim: int,
               wire_dtype: str = "float32") -> WireStats:
    """miss_mask (B, T, hot): the residual mask pooled onto the wire (the
    full mask without a cache).  ``live_bytes`` counts only (sample, table)
    rows with >= 1 surviving index, what a ragged exchange would move;
    ``dense_bytes`` what the equal-split butterfly moves regardless."""
    wire = canon_wire(wire_dtype)
    miss_mask = to_numpy(miss_mask)
    rows_total = int(miss_mask.shape[0] * miss_mask.shape[1])
    rows_live = int((miss_mask > 0).any(axis=-1).sum())
    item = WIRE_ITEMSIZE[wire]
    scale_bytes = WIRE_SCALE_BYTES[wire]
    return WireStats(
        dense_bytes=rows_total * (embed_dim * item + scale_bytes),
        live_bytes=rows_live * (embed_dim * item + scale_bytes),
        ref_bytes=rows_total * embed_dim * 4,
        live_rows=rows_live,
        total_rows=rows_total,
    )


def ragged_wire_bytes(n_dest: int, cap: int, embed_dim: int,
                      wire_dtype: str = "float32", *,
                      n_slots: int) -> int:
    """Bytes ONE member moves through the fused ragged exchange: cap-padded
    codec rows (+ int8's scales), narrow slot ids, the count and the
    layout's padding."""
    return exchange_wire_layout(
        ragged=True, n_dest=n_dest, cap=cap, bs=0, t_loc=0,
        embed_dim=embed_dim, wire_dtype=wire_dtype,
        n_slots=n_slots).wire_bytes


def dense_wire_bytes(n_dest: int, bs: int, t_loc: int, embed_dim: int,
                     wire_dtype: str = "float32",
                     emb_dtype=torch.float32) -> int:
    """Bytes ONE member moves through the fused dense butterfly, the number
    the ragged exchange must undercut."""
    return exchange_wire_layout(
        ragged=False, n_dest=n_dest, cap=0, bs=bs, t_loc=t_loc,
        embed_dim=embed_dim, wire_dtype=wire_dtype,
        emb_dtype=emb_dtype).wire_bytes


def dispatch_stats(counts, cap: int, row_bytes: int,
                   slot_bytes: int = 0) -> A2AVStats:
    """Padding accounting for one alltoallv call (host-side).
    ``slot_bytes`` (a fused layout's) makes ``payload_bytes`` the bytes the
    fused exchange physically moves instead of ``cap · row_bytes``."""
    counts = to_numpy(counts)
    n_dest = counts.size
    total_slots = n_dest * cap
    useful = int(counts.sum())
    payload = n_dest * slot_bytes if slot_bytes else total_slots * row_bytes
    return A2AVStats(
        payload_bytes=payload,
        useful_bytes=useful * row_bytes,
        padding_fraction=1.0 - useful * row_bytes / max(payload, 1),
    )


# ---------------------------------------------------------------------------
# the ragged exchange: pack, move, unpack
# ---------------------------------------------------------------------------


def _gather_padded(rows_tree, src: torch.Tensor, n: int):
    """Gather rows ``src`` from every (N, ...) leaf, index ``n`` reading a
    zero pad row (the empty-bucket-slot encoding)."""

    def take(a):
        a_s = torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))])
        return a_s[src]

    return _tree_map(take, rows_tree)


def pack_ragged_tree(rows_tree, dest: torch.Tensor, n_dest: int, cap: int):
    """Scatter a tree of row tensors (N, ...) sharing the leading axis into
    per-destination buckets (n_dest, cap, ...), with the counts (n_dest,)
    int32 and the drop count (a 0-dim int32 tensor).

    Rows with dest outside [0, n_dest) are excluded and never counted as
    drops; rows whose bucket is already full are drops."""
    n = dest.shape[0]
    dev = dest.device
    order = torch.argsort(dest, stable=True)
    ds = dest[order].long()
    bounds = torch.searchsorted(ds, torch.arange(n_dest + 1, device=dev))
    count_all = bounds[1:] - bounds[:-1]
    counts = torch.clamp(count_all, max=cap).to(torch.int32)
    drops = (count_all - counts).sum().to(torch.int32)
    slot = torch.arange(cap, device=dev)[None, :]
    src = torch.where(slot < counts[:, None], bounds[:-1, None] + slot, n)
    # compose the sort permutation into the gather: position n reads the
    # zero pad row
    src = torch.cat([order, order.new_full((1,), n)])[src]
    return _gather_padded(rows_tree, src, n), counts, drops


def pack_ragged(rows: torch.Tensor, dest: torch.Tensor, n_dest: int,
                cap: int):
    """Single-tensor :func:`pack_ragged_tree`: rows (N, D) -> (buckets
    (n_dest, cap, D), counts (n_dest,), drops)."""
    return pack_ragged_tree(rows, dest, n_dest, cap)


def pack_ragged_segments(rows_tree, live: torch.Tensor, n_dest: int,
                         cap: int):
    """:func:`pack_ragged_tree` for destination-grouped rows: row n belongs
    to destination n // (N / n_dest) and ships iff ``live[n]``.  A prefix
    sum and a binary search over the live flags replace the sort.  Same
    contract: (buckets, counts, drops)."""
    n = live.shape[0]
    dev = live.device
    l = live.to(torch.int64)
    csum = torch.cumsum(l, 0)
    count_all = l.reshape(n_dest, n // n_dest).sum(1)
    starts = torch.cumsum(count_all, 0) - count_all
    counts = torch.clamp(count_all, max=cap).to(torch.int32)
    drops = (count_all - counts).sum().to(torch.int32)
    slot = torch.arange(cap, device=dev)[None, :]
    valid = slot < counts[:, None]
    # flat index of the g-th live row = first n with cumsum(live) == g+1
    g = starts[:, None] + slot
    src = torch.where(valid, torch.searchsorted(csum, g + 1), n)
    return _gather_padded(rows_tree, src, n), counts, drops


def alltoallv_ragged(payload, counts: torch.Tensor, group=None):
    """Tree-shaped alltoallv: every leaf of ``payload`` is a (P, cap, ...)
    per-destination bucket stack; counts (P,) int32 valid rows per bucket.
    Returns (recv tree, recv_counts) where recv leaf [q] holds what source
    q sent here, of which recv_counts[q] rows are valid.  Leaves move as
    bytes, so any dtype crosses any backend."""

    def move(a):
        send = a.contiguous()
        recv = torch.empty_like(send)
        n = send.shape[0]
        dist.all_to_all_single(recv.view(torch.uint8).reshape(n, -1),
                               send.view(torch.uint8).reshape(n, -1),
                               group=group)
        return recv

    return _tree_map(move, payload), move(counts.reshape(-1, 1)).reshape(-1)


def alltoallv_raw(send: torch.Tensor, counts: torch.Tensor, group=None):
    """send (P, cap, D) padded per-destination buckets, counts (P,) ->
    (recv (P, cap, D), recv_counts (P,)): the single-tensor form of
    :func:`alltoallv_ragged`."""
    return alltoallv_ragged(send, counts, group)


def unpack_ragged(rows: torch.Tensor, slot_ids: torch.Tensor,
                  counts: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Scatter received bucket rows back into a dense row layout.

    rows (P, cap, D); slot_ids (P, cap) flat target slots; counts (P,)
    valid rows per bucket.  Entries beyond a bucket's count, and targets
    outside [-n_slots, n_slots), are dropped (negative targets count from
    the end, as in the reference's ``mode="drop"`` scatter): the scatter
    writes an (n_slots + 1)-row buffer whose last row is cut off.  Slots
    nothing was sent for stay exactly zero.  Returns (n_slots, D)."""
    p, cap = slot_ids.shape
    dev = rows.device
    valid = torch.arange(cap, device=dev)[None, :] < \
        counts.to(dev).long()[:, None]
    tgt = slot_ids.long()
    tgt = torch.where(tgt < 0, tgt + n_slots, tgt)
    keep = valid & (tgt >= 0) & (tgt < n_slots)
    tgt = torch.where(keep, tgt, n_slots)
    flat = rows.reshape(p * cap, *rows.shape[2:])
    out = flat.new_zeros((n_slots + 1,) + tuple(flat.shape[1:]))
    out[tgt.reshape(-1)] = flat
    return out[:n_slots]
