"""Dispatch over the kernels (the port of ``repro/kernels/ops.py``), selected
by ``DLRMConfig.sparse_backend`` for the bags and the interaction, by the
model's ``attn_impl`` argument for attention and by ``wkv_impl`` for the
RWKV-6 WKV:

- ``ref``: the plain PyTorch version;
- ``pallas``: the CUDA kernel; raises for a tensor that is not on the card;
- ``interpret``: the plain version (there is no GPU interpreter);
- ``auto``: the kernel for a CUDA tensor, the plain version for a CPU one.

Every op takes the reference's full keyword set with its defaults.  The
TPU tiling and planning knobs (``cq``/``ck``, ``chunk``, ``plan_method``)
are validated and change no value: see each op.

Autograd.  The kernels compute forwards only.  With grad enabled and an
input that requires grad, attention goes through :class:`FlashAttentionFn`,
the WKV through :class:`Rwkv6WkvFn`, each bag form through
:class:`EmbeddingBagFn` and the interaction through
:class:`DotInteractionFn`, whose forwards are the kernels on the card (or
the plain versions on the CPU) and whose backwards are plain PyTorch, as
the reference's are jnp autodiff: the bags' is ``ref.embedding_bag_grad_ref``
(a dense gradient of the table), the interaction's
``ref.dot_interaction_grad_ref``.  A bag's ``mask`` has no gradient: one
that requires grad is refused on every path rather than returned cut from
the graph.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dot_interaction import (DOT, DOT_BF16,
                                                 dot_interaction)
from repro_torch.kernels.embedding_bag import (POOL, POOL_BF16, check_plan,
                                               check_stacked_plan,
                                               embedding_bag,
                                               embedding_bag_rows,
                                               embedding_bag_stacked)
from repro_torch.kernels.flash_attention import FLASH, flash_attention
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.rwkv6_wkv import WKV, rwkv6_wkv

IMPLS = ("ref", "pallas", "interpret", "auto")


def kernels():
    """Every entry point of the port's hand-written kernels, by name (the
    bag and the interaction have one for f32 and one for bf16)."""
    return {"embedding_bag_pool": POOL, "embedding_bag_pool_bf16": POOL_BF16,
            "dot_interaction": DOT, "dot_interaction_bf16": DOT_BF16,
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


def wants_grad(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _no_grad_mask(mask) -> None:
    """The bags differentiate their table only: a mask that autograd
    tracks is refused on every path."""
    if wants_grad(mask):
        raise RuntimeError("the embedding bag has no backward for its mask; "
                           "call it under torch.no_grad() or with a mask "
                           "that does not require grad")


def _no_ref_plan(impl: str) -> None:
    """A plan on the plain path: 'ref' has none to consume, as in the
    reference; the other impls check it against the call."""
    if impl == "ref":
        raise ValueError("a precomputed stream plan only applies to the "
                         "kernel backends, not 'ref'")


PLAN_METHODS = ("sort", "count", "auto")


def _check_plan_method(plan_method: str) -> None:
    """The reference's stream-plan methods.  None of the ops builds a plan
    (the CUDA bag kernel reads none, and a ``plan=`` is built by the
    caller through ``build_stream_plan`` / ``stacked_stream_plan``, which
    take the same knob), and 'sort' and 'count' give the same plan bit for
    bit, so the method changes no value."""
    if plan_method not in PLAN_METHODS:
        raise ValueError(f"plan_method must be one of {PLAN_METHODS}, got "
                         f"{plan_method!r}")


def _check_positive(**kw) -> None:
    for name, val in kw.items():
        if isinstance(val, bool) or not isinstance(val, int) or val < 1:
            raise ValueError(f"{name} must be a positive int, got {val!r}")


def dot_interaction_op(z, *, impl: str = "auto", batch_tile: int = 128):
    kernel = use_kernel(impl, z)
    if wants_grad(z):
        return DotInteractionFn.apply(z, kernel)
    if not kernel:
        return ref.dot_interaction_ref(z)
    return dot_interaction(z, batch_tile=batch_tile)


def embedding_bag_op(table, idx, mask, *, impl: str = "auto",
                     batch_tile: int = 64, row_block: int = 0,
                     pool_mode: str = "auto", plan=None,
                     plan_method: str = "auto"):
    """``plan_method`` ('sort', 'count' or 'auto') is validated: both
    methods give the same plan bit for bit, and no plan is built here."""
    _check_plan_method(plan_method)
    _no_grad_mask(mask)
    kernel = use_kernel(impl, table)
    if not kernel and plan is not None:
        _no_ref_plan(impl)
        r, s = table.shape
        check_plan(plan, n_tables=1, rows=r, s=s,
                   itemsize=table.element_size(), n_bags=idx.shape[0],
                   hot=idx.shape[1], tile=batch_tile, row_block=row_block)

    def pool(tab):
        if not kernel:
            return ref.embedding_bag_ref(tab, idx, mask)
        return embedding_bag(tab, idx, mask, batch_tile=batch_tile,
                             row_block=row_block, pool_mode=pool_mode,
                             plan=plan)

    if wants_grad(table):
        return EmbeddingBagFn.apply(
            table, ref.clamped_ids(idx, table.shape[0]), mask, pool)
    return pool(table)


def embedding_bag_stacked_op(tables, idx, mask, *, impl: str = "auto",
                             batch_tile: int = 64, row_block: int = 0,
                             pool_mode: str = "auto", plan=None,
                             plan_method: str = "auto"):
    """(T,R,s) stacked embedding bags -> (B,T,s); the model hot path.
    ``plan_method`` as in :func:`embedding_bag_op`."""
    _check_plan_method(plan_method)
    _no_grad_mask(mask)
    kernel = use_kernel(impl, tables)
    if not kernel and plan is not None:
        _no_ref_plan(impl)
        check_stacked_plan(plan, tables, idx, batch_tile=batch_tile,
                           row_block=row_block)

    def pool(tab):
        if not kernel:
            return ref.embedding_bag_stacked_ref(tab, idx, mask)
        return embedding_bag_stacked(tab, idx, mask, batch_tile=batch_tile,
                                     row_block=row_block,
                                     pool_mode=pool_mode, plan=plan)

    if wants_grad(tables):
        t, r, _ = tables.shape
        tab = torch.arange(t, device=idx.device)[None, :, None]
        return EmbeddingBagFn.apply(
            tables, tab * r + ref.clamped_ids(idx, r), mask, pool)
    return pool(tables)


def embedding_bag_rows_op(tables, tid, idx, mask, *, impl: str = "auto",
                          row_tile: int = 64, row_block: int = 0,
                          pool_mode: str = "auto",
                          plan_method: str = "auto"):
    """(N, hot) packed rows pooled against their own tables -> (N, s).
    ``plan_method`` as in :func:`embedding_bag_op`."""
    _check_plan_method(plan_method)
    _no_grad_mask(mask)
    kernel = use_kernel(impl, tables)

    def pool(tab):
        if not kernel:
            return ref.embedding_bag_rows_ref(tab, tid, idx, mask)
        return embedding_bag_rows(tab, tid, idx, mask, row_tile=row_tile,
                                  row_block=row_block, pool_mode=pool_mode)

    if wants_grad(tables):
        t, r, _ = tables.shape
        gid = ref.clamped_ids(tid, t)[:, None] * r + ref.clamped_ids(idx, r)
        return EmbeddingBagFn.apply(tables, gid, mask, pool)
    return pool(tables)


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0,
                       softcap: float = 0.0, cq: int = 256, ck: int = 256,
                       impl: str = "auto"):
    """q (B,S,H,hd), k/v (B,T,Kh,hd) GQA -> (B,S,H,hd); every prefill
    layer's attention, and whisper's encoder with ``causal=False``.
    ``cq``/``ck`` are the reference's TPU query and key tiles: validated as
    positive, they change no value, since the CUDA kernel tiles by its own
    128 queries (64 below hd 128) and 64 or 128 keys, and the plain version
    takes every key at once."""
    _check_positive(cq=cq, ck=ck)
    kernel = use_kernel(impl, q)
    if wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                      kernel)
    if not kernel:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)


def rwkv6_wkv_op(r, k, v, logw, u, state0, *, impl: str = "auto",
                 chunk: int = 64):
    """r, k, logw (B,S,H,K), v (B,S,H,V), u (H,K), state0 (B,H,K,V) ->
    (out (B,S,H,V), final state (B,H,K,V)); every rwkv6 prefill layer's
    WKV.  ``impl='ref'`` is the exact recurrence
    (``ref.rwkv6_wkv_ref``), as the reference's 'ref' forces its oracle;
    'interpret', and 'auto' on a CPU tensor, the chunked form at ``chunk``
    tokens a chunk.  The CUDA kernel's chunk is fixed by its design
    (``rwkv6_wkv.CHUNK``): there ``chunk`` is validated and changes no
    value.  Types: the chunked paths (kernel and plain) widen to f32 and
    return out in r's type and the state in f32, as the reference's Pallas
    kernel; 'ref' promotes as the reference's oracle."""
    _check_positive(chunk=chunk)
    if impl == "ref":
        return ref.rwkv6_wkv_ref(r, k, v, logw, u, state0)
    kernel = use_kernel(impl, r)
    if wants_grad(r, k, v, logw, u, state0):
        return Rwkv6WkvFn.apply(r, k, v, logw, u, state0, kernel, chunk)
    if not kernel:
        return ref.rwkv6_wkv_chunked_ref(r, k, v, logw, u, state0,
                                         chunk=chunk)
    return rwkv6_wkv(r, k, v, logw, u, state0)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention under autograd (the reference's ``flash_attention``
    custom VJP, ``repro/models/attention.py:175-283``).  Forward: the CUDA
    kernel asked for the rows' log-sum-exp (``kernel`` true: a CUDA
    tensor), or the plain version on the CPU; it saves q, k, v, out and
    lse.  Backward: :func:`flash_attention_bwd`, plain PyTorch, as the
    reference's VJP is jnp.  The head dim's own scale holds for a padded
    one (hd 8, 88, ...), and f16 goes through the same entry."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, kernel):
        kw = {"causal": causal, "window": window, "softcap": softcap}
        if kernel:
            out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        else:
            out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


class Rwkv6WkvFn(torch.autograd.Function):
    """The chunked WKV under autograd.  Forward: the CUDA kernel
    (``kernel`` true) or the plain chunked form at ``chunk`` tokens a
    chunk.  Backward: the plain chunked form recomputed with grad and its
    vector-Jacobian product taken, since the reference differentiates its
    jnp ``wkv_chunked``; the final state's cotangent is honoured.  The
    recomputation widens 16-bit inputs to f32, so each gradient comes back
    in its input's own type."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0, kernel, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, logw, u, state0)
        if kernel:
            return rwkv6_wkv(r, k, v, logw, u, state0)
        return ref.rwkv6_wkv_chunked_ref(r, k, v, logw, u, state0,
                                         chunk=chunk)

    @staticmethod
    def backward(ctx, dout, dstate):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out, state = ref.rwkv6_wkv_chunked_ref(*inputs, chunk=ctx.chunk)
        wrt = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad((out, state), wrt, (dout, dstate),
                                         allow_unused=True))
        return (*(next(grads) if x.requires_grad else None
                  for x in inputs), None, None)


class EmbeddingBagFn(torch.autograd.Function):
    """A bag form under autograd (the reference differentiates its jnp
    bags).  Forward: ``pool(table)``, the form's CUDA kernel on the card
    or its plain version on the CPU, exactly as without autograd.
    Backward: :func:`ref.embedding_bag_grad_ref`, ``mask * dout``
    scatter-added into the rows the forward read (``gid``: each slot's
    flat row in the table's (rows, s) row space, clamped as the forward
    clamps), a dense gradient of the table in its type."""

    @staticmethod
    def forward(ctx, table, gid, mask, pool):
        ctx.shape, ctx.dtype = table.shape, table.dtype
        ctx.save_for_backward(gid, mask)
        return pool(table)

    @staticmethod
    def backward(ctx, dout):
        gid, mask = ctx.saved_tensors
        return ref.embedding_bag_grad_ref(ctx.shape, ctx.dtype, gid, mask,
                                          dout), None, None, None


class DotInteractionFn(torch.autograd.Function):
    """The interaction under autograd.  Forward: the CUDA kernel
    (``kernel`` true) or the plain version.  Backward:
    :func:`ref.dot_interaction_grad_ref`, dZ = (G + G^T) Z with G the
    output gradient scattered into the strict lower triangle."""

    @staticmethod
    def forward(ctx, z, kernel):
        ctx.save_for_backward(z)
        return dot_interaction(z) if kernel else ref.dot_interaction_ref(z)

    @staticmethod
    def backward(ctx, dout):
        z, = ctx.saved_tensors
        return ref.dot_interaction_grad_ref(z, dout), None
