"""Plain-PyTorch versions of the hand-written kernels (the port of
``repro/kernels/ref.py``).  The kernel wrappers take these for CPU tensors,
the tests hold the port against the reference with them, and
``chip_smoke.py`` compares every kernel with them on the card.

Ids are clamped to ``[0, R-1]`` (and table ids to ``[0, T-1]``) explicitly:
JAX clamps out-of-bounds gathers silently, torch indexing raises.
"""
from __future__ import annotations

import torch


def dot_interaction_ref(z: torch.Tensor) -> torch.Tensor:
    """z:(B,F,S) -> (B, F(F-1)/2) lower triangle of Z @ Z^T (reference DLRM
    interact_features), in ``np.tril_indices(F, -1)`` order."""
    _, f, _ = z.shape
    zf = z.float()
    zz = torch.bmm(zf, zf.transpose(1, 2))
    ii, jj = torch.tril_indices(f, f, -1, device=z.device)
    return zz[:, ii, jj].to(z.dtype)


def _clamped(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.long().clamp(0, n - 1)


def embedding_bag_ref(table, idx, mask):
    """table:(R,S) idx:(B,hot) mask:(B,hot) -> (B,S) masked-sum bags."""
    rows = table[_clamped(idx, table.shape[0])]             # (B,hot,S)
    return (rows * mask[..., None].to(rows.dtype)).sum(1)


def embedding_bag_stacked_ref(tables, idx, mask):
    """tables:(T,R,S) idx/mask:(B,T,hot) -> (B,T,S) per-table masked sums.
    Materializes the (B,T,hot,S) gather the kernel avoids."""
    t, r, _ = tables.shape
    tab = torch.arange(t, device=tables.device)[None, :, None]
    rows = tables[tab, _clamped(idx, r)]                      # (B,T,hot,S)
    return (rows * mask[..., None].to(rows.dtype)).sum(2)


def embedding_bag_rows_ref(tables, tid, idx, mask):
    """tables:(T,R,S) tid:(N,) idx/mask:(N,hot) -> (N,S) masked sums, each
    row pooled against its own table."""
    t, r, _ = tables.shape
    rows = tables[_clamped(tid, t)[:, None], _clamped(idx, r)]
    return (rows * mask[..., None].to(rows.dtype)).sum(1)
