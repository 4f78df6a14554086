"""Dispatch over the kernels (the port of ``repro/kernels/ops.py``), selected
by ``DLRMConfig.sparse_backend`` for the bags and the interaction, by the
model's ``attn_impl`` argument for attention and by ``wkv_impl`` for the
RWKV-6 WKV:

- ``ref``: the plain PyTorch version;
- ``pallas``: the CUDA kernel; raises for a tensor that is not on the card;
- ``interpret``: the plain version (there is no GPU interpreter);
- ``auto``: the kernel for a CUDA tensor, the plain version for a CPU one.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.dot_interaction import DOT, dot_interaction
from repro_torch.kernels.embedding_bag import (POOL, check_plan,
                                               check_stacked_plan,
                                               embedding_bag,
                                               embedding_bag_rows,
                                               embedding_bag_stacked)
from repro_torch.kernels.flash_attention import FLASH, flash_attention
from repro_torch.kernels.rwkv6_wkv import WKV, rwkv6_wkv

IMPLS = ("ref", "pallas", "interpret", "auto")


def kernels():
    """Every hand-written kernel of the port, by name."""
    return {"embedding_bag_pool": POOL, "dot_interaction": DOT,
            "flash_attention": FLASH, "rwkv6_wkv": WKV}


def reset_launches() -> None:
    for k in kernels().values():
        k.reset()


def use_kernel(impl: str, t) -> bool:
    """Whether ``impl`` sends tensor ``t`` to the CUDA kernel."""
    if impl in ("ref", "interpret"):
        return False
    if impl == "pallas":
        if t.device.type != "cuda":
            raise RuntimeError(
                f"impl='pallas' runs the CUDA kernel and needs a CUDA "
                f"tensor, got one on {t.device}")
        return True
    if impl == "auto":
        return t.device.type == "cuda"
    raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")


def _no_ref_plan(impl: str) -> None:
    """A plan on the plain path: 'ref' has none to consume, as in the
    reference; the other impls check it against the call."""
    if impl == "ref":
        raise ValueError("a precomputed stream plan only applies to the "
                         "kernel backends, not 'ref'")


def dot_interaction_op(z, *, impl: str = "auto", batch_tile: int = 128):
    if not use_kernel(impl, z):
        return ref.dot_interaction_ref(z)
    return dot_interaction(z, batch_tile=batch_tile)


def embedding_bag_op(table, idx, mask, *, impl: str = "auto",
                     batch_tile: int = 64, row_block: int = 0,
                     pool_mode: str = "auto", plan=None):
    if not use_kernel(impl, table):
        if plan is not None:
            _no_ref_plan(impl)
            r, s = table.shape
            check_plan(plan, n_tables=1, rows=r, s=s,
                       itemsize=table.element_size(), n_bags=idx.shape[0],
                       hot=idx.shape[1], tile=batch_tile,
                       row_block=row_block)
        return ref.embedding_bag_ref(table, idx, mask)
    return embedding_bag(table, idx, mask, batch_tile=batch_tile,
                         row_block=row_block, pool_mode=pool_mode, plan=plan)


def embedding_bag_stacked_op(tables, idx, mask, *, impl: str = "auto",
                             batch_tile: int = 64, row_block: int = 0,
                             pool_mode: str = "auto", plan=None):
    """(T,R,s) stacked embedding bags -> (B,T,s); the model hot path."""
    if not use_kernel(impl, tables):
        if plan is not None:
            _no_ref_plan(impl)
            check_stacked_plan(plan, tables, idx, batch_tile=batch_tile,
                               row_block=row_block)
        return ref.embedding_bag_stacked_ref(tables, idx, mask)
    return embedding_bag_stacked(tables, idx, mask, batch_tile=batch_tile,
                                 row_block=row_block, pool_mode=pool_mode,
                                 plan=plan)


def embedding_bag_rows_op(tables, tid, idx, mask, *, impl: str = "auto",
                          row_tile: int = 64, row_block: int = 0,
                          pool_mode: str = "auto"):
    """(N, hot) packed rows pooled against their own tables -> (N, s)."""
    if not use_kernel(impl, tables):
        return ref.embedding_bag_rows_ref(tables, tid, idx, mask)
    return embedding_bag_rows(tables, tid, idx, mask, row_tile=row_tile,
                              row_block=row_block, pool_mode=pool_mode)


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0,
                       softcap: float = 0.0, impl: str = "auto"):
    """q (B,S,H,hd), k/v (B,T,Kh,hd) GQA -> (B,S,H,hd); every prefill
    layer's attention."""
    if not use_kernel(impl, q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)


def rwkv6_wkv_op(r, k, v, logw, u, state0, *, impl: str = "auto"):
    """r, k, logw (B,S,H,K), v (B,S,H,V), u (H,K), state0 (B,H,K,V) ->
    (out (B,S,H,V), final state (B,H,K,V)); every rwkv6 prefill layer's
    WKV.  The plain version is the chunked form (chunk 32)."""
    if not use_kernel(impl, r):
        return ref.rwkv6_wkv_chunked_ref(r, k, v, logw, u, state0)
    return rwkv6_wkv(r, k, v, logw, u, state0)
