"""The fused exchange wire on ``torch.distributed`` (the float32 dense
subset of ``repro/core/alltoallv.py``).

``fuse_wire`` bitcasts every payload leaf into ONE contiguous
``(P, slot_bytes)`` uint8 bucket per destination under a static
``WireLayout`` (fields sorted by name, packed back to back, the slot padded
to 4 bytes), so one exchange is one ``all_to_all_single``
(:func:`alltoallv_fused`).  Bytes move by ``.view(torch.uint8)``, never by
a value cast, so the fused buffer is byte-identical to the reference's.

Not ported yet (ROADMAP): the bf16/int8 codecs, the ragged exchange
layouts and packing, the rider layouts and the ring exchange.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.bls import Issued

WIRE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
_WIRE_ALIASES = {None: "float32", "f32": "float32", "bf16": "bfloat16"}

# the fused slot is padded to a word multiple so the uint8 buffer can be
# re-viewed as int32 words by transports that prefer them
WIRE_ALIGN = 4

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64}


def _dtype_name(dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"unsupported wire dtype {dtype!r}")
    return name


def canon_wire(wire_dtype) -> str:
    """Normalize a wire-dtype spelling to the canonical codec name."""
    wire = _WIRE_ALIASES.get(wire_dtype, wire_dtype)
    if wire not in WIRE_ITEMSIZE:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    return wire


def require_float32_wire(wire_dtype) -> str:
    wire = canon_wire(wire_dtype)
    if wire != "float32":
        raise NotImplementedError(
            f"wire_dtype {wire!r}: the bf16/int8 codecs are not ported "
            "(ROADMAP 'the bf16/int8 codecs')")
    return wire


def encode_wire(x: torch.Tensor, wire_dtype: str = "float32") -> dict:
    """x (..., D) -> codec payload whose leaves keep the leading axes of x.
    float32 ships x verbatim."""
    require_float32_wire(wire_dtype)
    return {"q": x}


def decode_wire(payload: dict, out_dtype=torch.float32) -> torch.Tensor:
    if "scale" in payload:
        raise NotImplementedError("int8 wire payloads are not ported "
                                  "(ROADMAP 'the bf16/int8 codecs')")
    return payload["q"].to(out_dtype)


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

    @property
    def names(self) -> tuple:
        return tuple(f.name for f in self.fields)


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


def exchange_wire_layout(*, ragged: bool, n_dest: int, cap: int, bs: int,
                         t_loc: int, embed_dim: int,
                         wire_dtype: str = "float32",
                         emb_dtype=torch.float32) -> WireLayout:
    """The layout both halves of a DLRM exchange agree on — the dense
    branch: each destination's full ``(bs, t_loc)`` pooled block."""
    require_float32_wire(wire_dtype)
    if ragged:
        raise NotImplementedError("the ragged exchange is not ported "
                                  "(ROADMAP 'the ragged exchange')")
    return wire_layout(n_dest, {"q": ((bs, t_loc, embed_dim), emb_dtype)})


def alltoallv_fused(buf: torch.Tensor, group=None) -> Issued:
    """Issue the whole exchange as ONE ``all_to_all_single``: buf
    (P, slot_bytes) uint8, destination-major.  Returns the in-flight
    exchange; its ``wait()`` gives the (P, slot_bytes) buffer whose row q
    holds what source q sent here."""
    recv = torch.empty_like(buf)
    work = dist.all_to_all_single(recv, buf, group=group, async_op=True)
    return Issued(recv, work, keep=buf)
