"""The row checksum every shipped embedding row carries (the port of the
uint32 fold of ``repro/core/integrity.py``).

The fold: the row's bytes weighted by ``(i mod 251) + 1``, plus the row's
identity (flat gid and version) mixed in with Knuth's multiplicative
constants, wrapped at 2^32.  The source stamps it, the receiving host
verifies the exact bytes that arrived, so a flipped byte, a row delivered
to the wrong gid or the wrong version rejects.  It must stay the
reference's word for word: both packages verify each other's stamps.  The
audit folds, the integrity ledger and the wire stamp are ROADMAP A12.
"""
from __future__ import annotations

import numpy as np

_CS_GID = np.uint64(2654435761)      # Knuth multiplicative constants: mix
_CS_VER = np.uint64(2654435789)      # identity into the byte sum
_CS_MASK = np.uint64(0xFFFFFFFF)


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
