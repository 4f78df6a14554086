"""DLRM (Naumov et al., arXiv:1906.00091) — the port of
``repro/models/dlrm.py``: the single-device forward and the core of the
table-parallel forward (dense exchange, mono pipeline, float32 wire).

Architecture: dense features -> bottom MLP; categorical features ->
embedding bags over (T_pad, R_max, s) stacked tables; pairwise dot
interaction; top MLP -> CTR logit.  The bags and the interaction go through
the hand-written CUDA kernels on the card (``kernels/ops.py``); the MLPs
and concatenations are plain torch, as the reference leaves them to XLA.

Distribution follows the reference: tables are TABLE-parallel across the
model-axis process group (each member owns T_pad/P whole tables), each
member pools its tables for the WHOLE batch, and one fused all_to_all hands
every member the full feature set for its 1/P batch slice, under the BLS
bound k (``core/bls.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import alltoallv as a2a_mod
from repro_torch.core import bls as bls_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def padded_tables(cfg: DLRMConfig, n_shards: int) -> int:
    t = cfg.n_tables
    return ((t + n_shards - 1) // n_shards) * n_shards


def init_dlrm(seed: int, cfg: DLRMConfig, *, n_shards: int,
              device="cuda"):
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    made on ``device``.  ``n_shards`` (the model-axis size) sets the table
    padding; the reference defaults it to 16, which pads Kaggle's 26 tables
    to 32, so the port asks for it."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t_pad = padded_tables(cfg, n_shards)
    r_max = max(cfg.table_sizes)

    def mlp_params(dims):
        return [L.init_dense(gen, dims[i], dims[i + 1], cfg.dtype, dev,
                             bias=True) for i in range(len(dims) - 1)]

    # N.B. a (T_pad, R_max, s) stack; rows beyond a table's true size are
    # never indexed (synthetic data clips indices per true table size).
    tables = L.truncated_normal(gen, (t_pad, r_max, cfg.embed_dim),
                                1.0 / cfg.embed_dim, L.dtype_of(cfg.dtype),
                                dev)
    bot_dims = (cfg.n_dense_features, *cfg.bottom_mlp)
    n_feat = cfg.n_tables + 1
    n_inter = n_feat * (n_feat - 1) // 2 if cfg.arch_interaction_op == "dot" \
        else n_feat * cfg.embed_dim
    top_dims = (n_inter + cfg.embed_dim, *cfg.top_mlp)
    return {"tables": tables, "bot": mlp_params(bot_dims),
            "top": mlp_params(top_dims)}


def params_from_jax(np_params, device="cuda"):
    """The reference's parameter pytree (``repro.models.dlrm.init_dlrm``),
    its leaves as numpy arrays, -> the port's parameters on ``device``.
    The layouts agree, so this is a plain copy."""
    dev = resolve_device(device)

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return {"tables": conv(np_params["tables"]),
            "bot": [{k: conv(v) for k, v in lp.items()}
                    for lp in np_params["bot"]],
            "top": [{k: conv(v) for k, v in lp.items()}
                    for lp in np_params["top"]]}


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def apply_mlp(params, x):
    """Reference DLRM MLP: ReLU between layers, logits out."""
    for i, lp in enumerate(params):
        x = L.dense(lp, x)
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def resolve_sparse_backend(backend: str, device) -> str:
    """'auto' -> the CUDA kernel ('pallas') for tensors on the card, the
    plain version ('ref') elsewhere."""
    if backend == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "ref"
    if backend not in ("ref", "pallas", "interpret"):
        raise ValueError(f"unknown sparse_backend {backend!r}")
    return backend


def apply_emb(tables, idx, mask, backend: str = "ref", row_block: int = 0,
              pool_mode: str = "auto", plan=None):
    """Embedding bags.  tables:(T,R,s) idx:(B,T,hot) mask:(B,T,hot)
    -> (B,T,s).  The paper's dominant stage (its Fig. 5 flame graph)."""
    if plan is not None:
        raise NotImplementedError(
            "apply_emb: precomputed stream plans are not ported (ROADMAP "
            "'StreamPlan builders and plan_pipeline')")
    impl = resolve_sparse_backend(backend, tables.device)
    return ops.embedding_bag_stacked_op(tables, idx, mask, impl=impl,
                                        row_block=row_block,
                                        pool_mode=pool_mode)


def dot_interaction(z, backend: str = "auto"):
    """z:(B,F,s) -> (B, F(F-1)/2) lower-triangle pairwise dots.  The
    reference computes this with ``einsum``; the port sends it through the
    interaction kernel, which computes the same function."""
    impl = resolve_sparse_backend(backend, z.device)
    return ops.dot_interaction_op(z, impl=impl)


def forward_local(params, cfg: DLRMConfig, dense, idx, mask):
    """Single-device forward (the oracle for the distributed path)."""
    t = cfg.n_tables
    z0 = apply_mlp(params["bot"], dense)                       # (B, s)
    emb = apply_emb(params["tables"][:t], idx[:, :t], mask[:, :t],
                    backend=cfg.sparse_backend, row_block=cfg.row_block,
                    pool_mode=cfg.pool_mode)
    z = torch.cat([z0[:, None, :], emb], dim=1)                # (B, T+1, s)
    inter = dot_interaction(z, cfg.sparse_backend)
    top_in = torch.cat([z0, inter.to(z0.dtype)], dim=-1)
    return apply_mlp(params["top"], top_in)[..., 0]            # (B,) logit


# ---------------------------------------------------------------------------
# distributed forward (reference-DLRM butterfly over the model group)
# ---------------------------------------------------------------------------


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def resolve_slice(cfg: DLRMConfig, *, cache=None,
                  wire_dtype: Optional[str] = None,
                  exchange: Optional[str] = None,
                  exchange_pipeline: Optional[str] = None) -> str:
    """Check that a configuration stays on the slice the port serves —
    dense exchange, mono pipeline, float32 wire, no cache — and return its
    wire codec.  Anything else raises ``NotImplementedError``.
    ``exchange='auto'`` resolves dense without a cache, as in the
    reference.  ``exchange_pipeline='auto'`` resolves mono: the reference
    goes ring at P >= 4, whose output it proves bit-identical to mono."""
    if cache is not None:
        raise _unported("the hot-row cache", "'the hot cache'")
    wire = a2a_mod.require_float32_wire(
        wire_dtype if wire_dtype is not None else cfg.wire_dtype)
    ex = exchange if exchange is not None else cfg.exchange
    if ex not in ("dense", "ragged", "auto"):
        raise ValueError(f"unknown exchange {ex!r}")
    if ex == "ragged":
        raise _unported("exchange='ragged'",
                        "'the ragged exchange with apply_emb_rows'")
    pipe = exchange_pipeline if exchange_pipeline is not None \
        else cfg.exchange_pipeline
    if pipe not in ("mono", "ring", "auto"):
        raise ValueError(f"unknown exchange_pipeline {pipe!r}")
    if pipe == "ring":
        raise _unported("exchange_pipeline='ring'", "'the ring pipeline'")
    return wire


def forward_distributed(params, cfg: DLRMConfig, dense, idx, mask, *,
                        bound: int = 0, microbatches: int = 1,
                        cache=None, wire_dtype: Optional[str] = None,
                        exchange: Optional[str] = None,
                        exchange_pipeline: Optional[str] = None,
                        row_block: Optional[int] = None,
                        pool_mode: Optional[str] = None,
                        plan=None, deltas=None, migration=None, repair=None,
                        quarantine=None, wire_check: bool = False,
                        table_inv=None, degraded_members: tuple = (),
                        return_diag: bool = False, group=None):
    """dense:(B, n_dense) idx/mask:(B, T_pad, hot), the same full batch on
    every member; ``params["tables"]`` either the full (T_pad, R, s) stack
    or this member's (T_pad/P, R, s) shard.  Returns (B,) CTR logits in
    input order on every member.

    Each member pools its t_loc tables for the whole batch of every
    microbatch, reshapes the result destination-major and fuses it into one
    (P, slot_bytes) uint8 buffer; one ``all_to_all_single`` per microbatch
    moves it; each member then defuses its (P, bs, t_loc, s) source-major
    block into (bs, T_pad, s), runs the interaction and the top MLP for its
    own bs-row slice, and the slices are all-gathered.  bound > 0 runs the
    BLS pipeline over the ``microbatches`` slices; the bound changes the
    schedule, never the values.  With one data row the pipeline's order is
    input order, so the reference's ``restore_order`` has no counterpart.

    ``group`` defaults to the model group of ``launch/mesh.py``; with none
    the forward falls back to :func:`forward_local`, as the reference does
    without a model mesh.  The riders, degraded serving, plans and
    diagnostics raise ``NotImplementedError``."""
    wire = resolve_slice(cfg, cache=cache, wire_dtype=wire_dtype,
                         exchange=exchange,
                         exchange_pipeline=exchange_pipeline)
    if plan is not None:
        raise _unported("plan=", "'StreamPlan builders and plan_pipeline'")
    riders = {"deltas": deltas, "migration": migration, "repair": repair,
              "quarantine": quarantine, "table_inv": table_inv}
    for name, val in riders.items():
        if val is not None:
            raise _unported(f"{name}=", "A8-A12 (riders and chaos)")
    if wire_check or degraded_members or return_diag:
        raise _unported("wire_check / degraded_members / return_diag",
                        "A8-A12 (riders and chaos)")
    group = group if group is not None else mesh_mod.current_group()
    if group is None:
        return forward_local(params, cfg, dense, idx, mask)

    n_shards = dist.get_world_size(group)
    m = dist.get_rank(group)
    t_pad = idx.shape[1]
    if t_pad % n_shards:
        raise ValueError(f"{t_pad} padded tables do not split over "
                         f"{n_shards} members (use padded_tables)")
    t_loc = t_pad // n_shards
    tables = params["tables"]
    if tables.shape[0] == t_pad:
        tables = tables[m * t_loc:(m + 1) * t_loc]
    elif tables.shape[0] != t_loc:
        raise ValueError(f"tables hold {tables.shape[0]} tables: expected "
                         f"the full stack ({t_pad}) or this member's shard "
                         f"({t_loc})")
    b = dense.shape[0]
    mb = microbatches
    if b % (mb * n_shards):
        raise ValueError(f"batch {b} does not split into {mb} microbatches "
                         f"x {n_shards} members")
    b_mb = b // mb
    bs = b_mb // n_shards            # rows per (microbatch, member)
    backend = cfg.sparse_backend
    rblk = row_block if row_block is not None else cfg.row_block
    pool = pool_mode if pool_mode is not None else cfg.pool_mode
    emb_dtype = tables.dtype
    s = tables.shape[2]
    t = cfg.n_tables
    layout = a2a_mod.exchange_wire_layout(
        ragged=False, n_dest=n_shards, cap=bs * t_loc, bs=bs, t_loc=t_loc,
        embed_dim=s, wire_dtype=wire, emb_dtype=emb_dtype)
    idx_loc = idx[:, m * t_loc:(m + 1) * t_loc]
    mask_loc = mask[:, m * t_loc:(m + 1) * t_loc]

    def stage_a(j):
        rows = slice(j * b_mb, (j + 1) * b_mb)
        pooled = apply_emb(tables, idx_loc[rows], mask_loc[rows], backend,
                           row_block=rblk, pool_mode=pool)
        # destination-major: all_to_all's split groups are the leading
        # bs-row blocks, a free reshape
        payload = {k: v.reshape(n_shards, bs, *v.shape[1:])
                   for k, v in a2a_mod.encode_wire(pooled, wire).items()}
        buf = a2a_mod.fuse_wire(payload, layout)
        # member m's dense rows of microbatch j (matches a2a delivery)
        dm = dense[j * b_mb + m * bs:j * b_mb + (m + 1) * bs]
        return buf, apply_mlp(params["bot"], dm)               # (bs, s)

    def collective(buf):
        return a2a_mod.alltoallv_fused(buf, group)

    def stage_b(recv, z0):
        q = a2a_mod.decode_wire(a2a_mod.defuse_wire(recv, layout), emb_dtype)
        # (P, bs, t_loc, s) source-major -> (bs, t_pad, s)
        emb_all = q.permute(1, 0, 2, 3).reshape(bs, n_shards * t_loc, s)
        z = torch.cat([z0[:, None, :], emb_all[:, :t]], dim=1)
        inter = dot_interaction(z, backend)
        top_in = torch.cat([z0, inter.to(z0.dtype)], dim=-1)
        return apply_mlp(params["top"], top_in)[..., 0]

    outs, _ = bls_mod.bls_pipeline(stage_a, collective, stage_b,
                                   list(range(mb)), bound)
    out = torch.stack(outs)                                    # (mb, bs)
    parts = [torch.empty_like(out) for _ in range(n_shards)]
    dist.all_gather(parts, out, group=group)
    # (P, mb, bs) -> input order (mb, P, bs)
    return torch.stack(parts).permute(1, 0, 2).reshape(-1)
