"""DLRM (Naumov et al., arXiv:1906.00091) — the port of
``repro/models/dlrm.py``: the single-device forward and the table-parallel
forward with the hot-row cache, the dense and ragged exchanges, the mono
and ring pipelines, the float32, bf16 and int8 wire codecs, precomputed
stream plans (:func:`build_forward_plans`), degraded serving around
slow members, and the riders of the exchange: versioned embedding-row
deltas, migrating rows and integrity repairs, with a non-identity table
placement, a row quarantine and a checksum on every wire segment.

Architecture: dense features -> bottom MLP; categorical features ->
embedding bags over (T_pad, R_max, s) stacked tables; pairwise dot
interaction; top MLP -> CTR logit.  The bags and the interaction go through
the hand-written CUDA kernels on the card (``kernels/ops.py``); the MLPs
and concatenations are plain torch, as the reference leaves them to XLA.

Distribution follows the reference: tables are TABLE-parallel across the
model-axis process group (each member owns T_pad/P whole tables), each
member pools its tables for the WHOLE batch, and one fused all_to_all hands
every member the full feature set for its 1/P batch slice, under the BLS
bound k (``core/bls.py``).  With a cache each member pools its own slice's
hits locally and only the miss residual rides the wire; the ragged exchange
ships only the live (sample, table) rows, pooled through the bag kernel's
rows form.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import alltoallv as a2a_mod
from repro_torch.core import bls as bls_mod
from repro_torch.core import integrity as integ
from repro_torch.device import resolve_device
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L
from repro_torch.serving import hot_cache as hc_mod

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
    -> (B,T,s).  The paper's dominant stage (its Fig. 5 flame graph).
    ``plan`` (``kernels.embedding_bag.stacked_stream_plan``) is checked
    against the call; the 'ref' backend has none to consume and raises."""
    impl = resolve_sparse_backend(backend, tables.device)
    return ops.embedding_bag_stacked_op(tables, idx, mask, impl=impl,
                                        row_block=row_block,
                                        pool_mode=pool_mode, plan=plan)


@dataclasses.dataclass
class ExchangeDiag:
    """Per-step exchange diagnostics (the cap autotuner's observation).
    ``live_max``, ``drops`` and ``approx_rows`` are 0-dim int32 tensors
    (reduced over the model group) or ints; ``approx_rows`` counts the live
    (sample, table) bags served from a degraded member's fallback."""
    live_max: object        # max per-(microbatch, dest) live rows
    drops: object           # rows the cap dropped (0 when dense)
    approx_rows: object = 0
    exchange: str = "dense"  # resolved decision: dense | ragged | local
    cap: int = 0
    dense_rows: int = 0     # what the dense butterfly moves per destination
    staged: object = None   # the harvested delta rows (forward's deltas=)
    staged_mig: object = None  # the harvested migration rows (migration=)
    staged_rep: object = None  # the harvested repair rows (repair=)
    wbad: object = None     # (P_dst, mb, P_src) int32 corrupt-segment flags
    audit: object = None    # (P, n) int32 gathered audit words (audit_words=)


def apply_emb_rows(tables, tid, idx, mask, backend: str = "ref",
                   row_block: int = 0, pool_mode: str = "auto"):
    """Row-wise embedding bags: tables (T,R,s), tid (N,), idx/mask (N,hot)
    -> (N,s) masked sums, each row against its own table.  The packed
    analogue of :func:`apply_emb`: it pools ONLY the rows that ride the
    ragged exchange (O(P·cap·hot) gathers instead of O(B·T·hot)), through
    the bag kernel's rows form on the card."""
    impl = resolve_sparse_backend(backend, tables.device)
    return ops.embedding_bag_rows_op(tables, tid, idx, mask, impl=impl,
                                     row_block=row_block,
                                     pool_mode=pool_mode)


def resolve_pipeline(pipeline: str, n_shards: int) -> str:
    """'mono' is one fused all_to_all per exchange; 'ring' decomposes it
    into P−1 point-to-point rounds consumed per peer.  'auto' goes ring at
    P >= 4, as in the reference."""
    if pipeline not in ("mono", "ring", "auto"):
        raise ValueError(f"unknown exchange_pipeline {pipeline!r}")
    if pipeline == "auto":
        return "ring" if n_shards >= 4 else "mono"
    return pipeline


def resolve_exchange(exchange: str, *, use_cache: bool, cap: int,
                     dense_rows: int) -> tuple[bool, int]:
    """Exchange selection -> (use_ragged, cap).  ``dense_rows`` (= bs ·
    t_loc) is what the dense butterfly moves per destination; ``cap`` 0
    means dense-equivalent (lossless).  'auto' goes ragged only when a
    cache shrinks the live set AND the cap undercuts the dense buffer."""
    if exchange not in ("dense", "ragged", "auto"):
        raise ValueError(f"unknown exchange {exchange!r}")
    cap = max(1, min(int(cap), dense_rows)) if cap else dense_rows
    if exchange == "dense":
        return False, cap
    if exchange == "ragged":
        return True, cap
    return bool(use_cache) and cap < dense_rows, cap


def ragged_exchange_pack(tables, idx, miss_mask, *, n_dest: int, cap: int,
                         wire: str = "float32", backend: str = "ref",
                         row_block: int = 0, pool_mode: str = "auto"):
    """Stage-a half of the ragged miss-residual exchange for ONE member.

    idx/miss_mask (B_mb, t_loc, hot) cover this member's local tables for
    every destination's batch slice (B_mb = n_dest · bs).  Live rows (>= 1
    surviving index) are packed into cap-padded per-destination buckets
    BEFORE pooling, only the packed rows are pooled (:func:`apply_emb_rows`)
    and the pooled vectors are codec-encoded.  Returns (payload, drops),
    payload {"q" (n_dest, cap, s) [, "scale"], "ids" (n_dest, cap),
    "counts" (n_dest, 1) int32}, already the fused wire's field shapes; an
    id is sample-within-slice · t_loc + local table, in the narrowest dtype
    addressing the bs·t_loc slots."""
    b_mb, t_loc, hot = idx.shape
    bs = b_mb // n_dest
    dev = idx.device
    live = (miss_mask > 0).any(dim=-1)                     # (B_mb, t_loc)
    samp = torch.arange(b_mb, dtype=torch.int32, device=dev)[:, None]
    lt = torch.arange(t_loc, dtype=torch.int32, device=dev)[None, :]
    ids = ((samp % bs) * t_loc + lt).to(a2a_mod.slot_id_dtype(bs * t_loc))
    rows = {"idx": idx.reshape(b_mb * t_loc, hot).to(torch.int32),
            "mask": miss_mask.reshape(b_mb * t_loc, hot),
            "ids": ids.reshape(-1)}
    # the flattened (sample, table) order is destination-grouped
    # (destination = sample // bs), so the sort-free segment pack applies
    packed, counts, drops = a2a_mod.pack_ragged_segments(
        rows, live.reshape(-1), n_dest, cap)
    # dead slots carry ids 0 / mask 0 and pool to an exact zero
    tid = packed["ids"] % t_loc
    pooled = apply_emb_rows(tables, tid.reshape(-1),
                            packed["idx"].reshape(n_dest * cap, hot),
                            packed["mask"].reshape(n_dest * cap, hot),
                            backend=backend, row_block=row_block,
                            pool_mode=pool_mode)
    payload = a2a_mod.encode_wire(pooled.reshape(n_dest, cap, -1), wire)
    payload.update(ids=packed["ids"], counts=counts.reshape(n_dest, 1))
    return payload, drops


def ragged_exchange_unpack(recv, *, t_loc: int, bs: int,
                           out_dtype=torch.float32):
    """Stage-b half: decode the received buckets and scatter them into the
    dense (bs, t_pad, s) layout.  Bucket q came from source q, which owns
    global tables [q·t_loc, (q+1)·t_loc); rows nobody sent (all-hit or
    empty bags) stay exactly zero, as they pool in the dense exchange.
    Narrow ids widen here, after the exchange."""
    n_dest, _ = recv["ids"].shape
    t_pad = n_dest * t_loc
    rows = a2a_mod.decode_wire(
        {k: v for k, v in recv.items() if k in ("q", "scale")}, out_dtype)
    ids = recv["ids"].long()
    src = torch.arange(n_dest, device=ids.device)[:, None]
    samp = ids // t_loc
    table = src * t_loc + ids % t_loc
    flat = samp * t_pad + table
    out = a2a_mod.unpack_ragged(rows, flat, recv["counts"].reshape(-1),
                                bs * t_pad)
    return out.reshape(bs, t_pad, rows.shape[-1])


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


def resolve_slice(cfg: DLRMConfig, *, wire_dtype: Optional[str] = None,
                  exchange: Optional[str] = None,
                  exchange_pipeline: Optional[str] = None) -> str:
    """Validate the exchange options and return the canonical wire codec.
    Unknown exchanges, pipelines and codecs raise ``ValueError``; every
    value the reference takes serves."""
    wire = a2a_mod.canon_wire(
        wire_dtype if wire_dtype is not None else cfg.wire_dtype)
    ex = exchange if exchange is not None else cfg.exchange
    if ex not in ("dense", "ragged", "auto"):
        raise ValueError(f"unknown exchange {ex!r}")
    pipe = exchange_pipeline if exchange_pipeline is not None \
        else cfg.exchange_pipeline
    if pipe not in ("mono", "ring", "auto"):
        raise ValueError(f"unknown exchange_pipeline {pipe!r}")
    return wire


def forward_distributed(params, cfg: DLRMConfig, dense, idx, mask, *,
                        bound: int = 0, microbatches: int = 1,
                        restore_order: bool = True,
                        cache=None, wire_dtype: Optional[str] = None,
                        exchange: Optional[str] = None,
                        ragged_cap: Optional[int] = None,
                        exchange_pipeline: Optional[str] = None,
                        row_block: Optional[int] = None,
                        pool_mode: Optional[str] = None,
                        plan=None, deltas=None, migration=None, repair=None,
                        quarantine=None, wire_check: bool = False,
                        wire_flip=None, table_inv=None,
                        audit_words=None,
                        degraded_members: tuple = (),
                        degraded_fallback: str = "zero",
                        return_diag: bool = False, group=None):
    """dense:(B, n_dense) idx/mask:(B, T_pad, hot), the same full batch on
    every member; ``params["tables"]`` either the full (T_pad, R, s) stack
    or this member's (T_pad/P, R, s) shard.  Returns (B,) CTR logits in
    input order on every member (and an :class:`ExchangeDiag` with
    ``return_diag``).

    Per microbatch, stage_a on member m pools the cache hits of its own
    bs-row batch slice over ALL tables from the replicated hot block
    (``cache``, a ``serving/hot_cache.HotCache`` over the full stack),
    then either packs the live rows of its t_loc tables for the whole
    microbatch and pools only those (the ragged exchange) or pools the
    miss residual dense; the payload goes through the ``wire_dtype`` codec
    and is fused into one (P, slot_bytes) uint8 buffer.  The exchange is
    one ``all_to_all_single`` ('mono') or P−1 point-to-point rounds inside
    stage_b ('ring'); stage_b decodes each source's chunk, scatters it if
    ragged, adds that source's pooled hits, then runs the interaction and
    the top MLP for its slice.  The slices are all-gathered.  bound > 0
    runs the BLS pipeline over the ``microbatches`` slices; the bound
    changes the schedule, never the values, and ring and mono give the
    same bits.  With one data row the pipeline's order is input order, so
    ``restore_order`` changes nothing.

    ``exchange``: 'dense', 'ragged' (``ragged_cap`` rows a destination, 0
    meaning dense-equivalent) or 'auto' (:func:`resolve_exchange`).
    ``plan`` is this member's :func:`build_forward_plans` (leaves stacked
    over microbatches): each microbatch's bags are checked against their
    plan and pooled as without one, bit for bit; a plan with an exchange
    that resolves ragged raises ``ValueError``.

    ``degraded_members`` (group ranks) serves around slow or suspect
    members: every member still takes part in the collective, but a
    degraded source's chunk is masked on receipt, so its tables' miss
    residual is served from ``degraded_fallback``: 'zero' (the residual
    vanishes; cache hits, which never ride the wire, still land) or 'mean'
    (each table's mean row times the residual weight sum; needs a cache).
    ``approx_rows`` in the diagnostics counts exactly the live bags so
    served, summed over the group.

    ``deltas`` threads versioned embedding-row updates through the SAME
    fused exchange: a dict of ``(P, microbatches, ...)`` leaves built by
    ``runtime.freshness.FreshnessManager.next_wire`` (``dvec`` (.., dcap,
    s) new rows, ``dgid`` flat table·R+row ids, ``dcs`` source-stamped
    checksums, ``dcnt``/``dver`` each slice's count and version).  Member
    m repacks its slices ``[m]`` by owning member (every microbatch in one
    pack) and each microbatch's stage_a fuses its buckets into the
    ``"xdelta"`` field (a slice holds <= dcap rows, so nothing drops); the
    rows travel in the table's dtype whatever the codec.  stage_b keeps
    each source's sub-blob, and the harvest of every member, leaves
    ``(P_dst, microbatches, P_src, ...)``, is the diagnostics' ``staged``
    (so deltas need ``return_diag``): it rides the all-gather of the
    logits, as the diagnostics' counters do, so neither adds a collective.
    The forward never writes a table; the manager's apply window does.

    ``migration`` threads live-resharding rows through the same exchange
    as the ``"xmig"`` field: ``(P, microbatches, ...)`` leaves built by
    ``runtime.reshard.ReshardExecutor.next_wire`` (``mgid`` flat ORIGINAL
    gids of rows the member owns now, ``mdst`` each row's future owner,
    ``mcnt``/``mepoch`` each slice's count and the reshard's epoch).
    Member m gathers each row from its own shard, stamps it with
    ``row_checksum_device`` (the epoch as the version) over the bytes that
    ship and routes it to its future owner.  ``repair`` threads the
    scrubber's mirror rows as the ``"xrep"`` field (``rvec``, ``rgid``
    ORIGINAL gids, ``rcs`` stamped by the mirror, ``rcnt``; built by
    ``runtime.scrub.Scrubber.next_wire``), each routed to the owner of the
    quarantined row.  Their harvests come back as the diagnostics'
    ``staged_mig`` and ``staged_rep``, leaves ``(P_dst, microbatches,
    P_src, ...)``, like ``staged``.

    ``quarantine`` is a ``(Q,)`` int32 vector of PHYSICAL flat gids (slot ·
    R + row, −1 padding) masked out of every bag before the cache/residual
    split, so neither the cached copy nor the resident row of a corrupt
    gid is served while its repair is in flight; membership is a binary
    search in the sorted vector.  ``wire_check=True`` adds the ``"wcs"``
    segment checksum: stage_a stamps every destination slot after fusing,
    then XORs the first payload byte of its slot to dst with
    ``wire_flip[m, dst]`` (a (P, P) uint8 fault hook, zeros by default:
    XOR 0 is the identity); stage_b verifies each received segment (mono:
    per source row; ring: per chunk), zeroes a corrupt source's embedding
    contribution (``torch.where``: corrupt bytes may decode to NaN) and,
    ragged, its counts, so no garbage slot id scatters.  The per-(dst,
    microbatch, src) corrupt flags come back as the diagnostics' ``wbad``.
    ``audit_words`` (n,) int32, the same length on every member (the
    scrubber's compacted audit mismatches, ``Scrubber.audit_words``), ride
    the all-gather of the logits and come back as the diagnostics'
    ``audit``, (P, n): every member sees every member's words.

    ``table_inv`` (T_pad,) maps original table -> physical slot under a
    non-identity placement: the caller permutes idx/mask/tables/cache into
    physical order; the forward routes delta and repair rows to ``inv[gid
    // R] // t_loc`` and gathers the exchanged columns back to original
    order before the interaction.

    Every rider comes back in the diagnostics, so each needs
    ``return_diag``.  ``group`` defaults to the model group of
    ``launch/mesh.py``; with none the forward falls back to
    :func:`forward_local`, as the reference does without a model mesh
    (``deltas``, ``migration``, ``repair``, ``wire_check`` and
    ``audit_words`` then raise ``ValueError``)."""
    wire = resolve_slice(cfg, wire_dtype=wire_dtype, exchange=exchange,
                         exchange_pipeline=exchange_pipeline)
    group = group if group is not None else mesh_mod.current_group()
    rides = {"deltas": deltas is not None,
             "migration rows": migration is not None,
             "repair rows / wire verification / audit words":
             repair is not None or wire_check or audit_words is not None}
    for name, on in rides.items():
        if on and group is None:
            raise ValueError(
                f"forward_distributed: {name} ride the model-group "
                f"exchange — set up a model group with launch/mesh.py")
    if any(rides.values()) and not return_diag:
        raise ValueError(
            "forward_distributed: the rider harvests and the wire flags "
            "are returned in the diagnostics (staged, staged_mig, "
            "staged_rep, wbad, audit) — pass return_diag=True")
    if group is None:
        if cache is not None or (wire_dtype or cfg.wire_dtype) != "float32":
            warnings.warn(
                "forward_distributed: no model group set up — falling back "
                "to forward_local; cache/wire_dtype are inactive (set one "
                "up with launch/mesh.py)", stacklevel=2)
        logits = forward_local(params, cfg, dense, idx, mask)
        if return_diag:
            return logits, ExchangeDiag(0, 0, 0, "local")
        return logits

    n_shards = dist.get_world_size(group)
    m = dist.get_rank(group)
    t_pad = idx.shape[1]
    if t_pad % n_shards:
        raise ValueError(f"{t_pad} padded tables do not split over "
                         f"{n_shards} members (use padded_tables)")
    t_loc = t_pad // n_shards
    use_cache = cache is not None and cache.cache_rows > 0
    if use_cache and cache.slot_of.shape[0] != t_pad:
        raise ValueError(
            f"cache covers {cache.slot_of.shape[0]} tables but idx has "
            f"{t_pad} (padded) — build the cache over the full (T_pad, R, "
            f"s) stack")
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
    r_rows, s = tables.shape[1], tables.shape[2]
    t = cfg.n_tables
    dev = idx.device
    dense_rows = bs * t_loc
    use_ragged, cap = resolve_exchange(
        exchange if exchange is not None else cfg.exchange,
        use_cache=use_cache,
        cap=ragged_cap if ragged_cap is not None else cfg.ragged_cap,
        dense_rows=dense_rows)
    pipe = resolve_pipeline(
        exchange_pipeline if exchange_pipeline is not None
        else cfg.exchange_pipeline, n_shards)
    # the riders, each an opaque sub-blob of the fused slot: (wire field,
    # its leaves' prefix, sub-layout, the member's (mb, ...) slices, their
    # bucket cap)
    riders = []
    for field, p, leaves, make in (
            ("xdelta", "d", deltas, a2a_mod.delta_wire_layout),
            ("xmig", "m", migration, a2a_mod.mig_wire_layout),
            ("xrep", "r", repair, a2a_mod.rep_wire_layout)):
        if leaves is not None:
            rcap = int(leaves[p + "gid"].shape[-1])
            riders.append((field, p, make(n_shards, rcap, s, emb_dtype),
                           {k: torch.as_tensor(v)[m].to(dev)
                            for k, v in leaves.items()}, rcap))
    sub = {f: lay for f, _, lay, _, _ in riders}
    # the ONE layout both exchange halves (and the BLS ring slot) agree on,
    # the riders included as opaque bytes
    layout = a2a_mod.exchange_wire_layout(
        ragged=use_ragged, n_dest=n_shards, cap=cap, bs=bs, t_loc=t_loc,
        embed_dim=s, wire_dtype=wire, emb_dtype=emb_dtype,
        delta_bytes=sub["xdelta"].slot_bytes if "xdelta" in sub else 0,
        mig_bytes=sub["xmig"].slot_bytes if "xmig" in sub else 0,
        rep_bytes=sub["xrep"].slot_bytes if "xrep" in sub else 0,
        wire_check=wire_check)
    # each source's harvest bytes: the rider sub-blobs, then its int32
    # corrupt flag
    h_off, hbytes = {}, 0
    for f, _, lay, _, _ in riders:
        h_off[f] = hbytes
        hbytes += lay.slot_bytes
    hbytes += 4 * int(wire_check)
    if plan is not None:
        if use_ragged:
            raise ValueError(
                "forward_distributed: precomputed stream plans describe the "
                "dense pooling path; the ragged exchange packs a data-"
                "dependent row set per step — build plans only when the "
                "exchange resolves dense")
        if not isinstance(plan, eb.StreamPlan) or plan.sid.dim() < 1 or \
                plan.sid.shape[0] != mb:
            raise ValueError(f"plan must be build_forward_plans' StreamPlan "
                             f"with {mb} microbatches")
    deg = tuple(sorted({int(d) for d in degraded_members}))
    fb_rows = None
    if deg:
        if degraded_fallback not in ("zero", "mean"):
            raise ValueError(
                f"unknown degraded_fallback {degraded_fallback!r}")
        if any(d < 0 or d >= n_shards for d in deg):
            raise ValueError(f"degraded_members {deg} out of range for "
                             f"{n_shards} members")
        if len(deg) >= n_shards:
            raise ValueError("forward_distributed: every member degraded — "
                             "nothing would serve the exchange; evict "
                             "instead")
        if degraded_fallback == "mean":
            if not use_cache:
                raise ValueError(
                    "degraded_fallback='mean' needs the cache layout: the "
                    "fallback weight sums come from each member's own "
                    "(idx, mask) slice over ALL tables, which only the "
                    "cache path reads — use 'zero' or serve with a cache")
            fb_rows = table_means(params["tables"], t_pad, group)
    deg_mask = [1 if i in deg else 0 for i in range(n_shards)]
    # 1 on every table column a degraded member owns
    deg_cols = torch.tensor(deg_mask, device=dev) \
        .repeat_interleave(t_loc) if deg else None
    cols = slice(m * t_loc, (m + 1) * t_loc)
    hit_impl = resolve_sparse_backend(backend, tables.device)
    inv_t = None
    if table_inv is not None:
        inv_t = torch.as_tensor(np.asarray(table_inv) if not isinstance(
            table_inv, torch.Tensor) else table_inv).to(dev, torch.int64)
    if wire_check:
        flip = torch.zeros((n_shards, n_shards), dtype=torch.uint8,
                           device=dev) if wire_flip is None else \
            torch.as_tensor(wire_flip).to(dev, torch.uint8)

    if quarantine is not None:
        # row-level zero fallback: every id naming a quarantined PHYSICAL
        # row leaves its bag, before the cache/residual split; membership
        # by binary search in the sorted vector (padding -1 included, as
        # the reference compares against every entry)
        q = torch.as_tensor(quarantine).to(dev, torch.int64).sort().values
        if q.numel():
            colt = torch.arange(t_pad, dtype=torch.int64, device=dev)
            gid_b = colt[None, :, None] * r_rows + idx.long()
            pos = torch.searchsorted(q, gid_b).clamp_(max=q.numel() - 1)
            mask = mask * (q[pos] != gid_b).to(mask.dtype)

    def slot_of(gid):
        """The PHYSICAL slot of each flat ORIGINAL gid's table now."""
        tab = gid.long() // r_rows
        return tab if inv_t is None else inv_t[tab.clamp(0, t_pad - 1)]

    def local_miss(ix, mk):
        """This member's local-table (idx, residual mask) slice."""
        ix_loc, mk_loc = ix[:, cols], mk[:, cols]
        if not use_cache:
            return ix_loc, mk_loc
        return ix_loc, hc_mod.miss_mask_of(cache.slot_of[cols], ix_loc,
                                           mk_loc)

    def pack_rider(field, p, lay, dl, rcap):
        """This member's rider slices -> every microbatch's sub-blobs,
        (mb, P, sub-slot bytes): each valid row routed to its destination
        and repacked into rcap-row buckets (a slice holds <= rcap rows, so
        nothing drops), one pack for all the microbatches (bucket j·P +
        destination).  Delta and repair rows go to the member owning
        their table and carry the checksums stamped at their source;
        migration rows are gathered here from this member's shard, stamped
        on the device over the bytes that ship, and go to their future
        owner.  Checksums travel as int32 bits (the pack gathers rows;
        uint32 is a reinterpretation of the same bytes)."""
        gid = dl[p + "gid"].to(torch.int32)
        valid = torch.arange(rcap, device=dev)[None] < dl[p + "cnt"]
        if field == "xmig":
            # the executor fills only rows this member owns; anything
            # else clamps into its shard, as the reference's gather does
            g = gid.long()
            local = (slot_of(g) - m * t_loc).clamp(0, t_loc - 1)
            vec = tables[local, g % r_rows]               # (mb, mcap, s)
            epoch = dl["mepoch"].to(torch.int64).expand(mb, rcap)
            cs = integ.row_checksum_device(
                vec.reshape(mb * rcap, s), g.reshape(-1),
                epoch.reshape(-1)).view(torch.int32)
            dest = dl["mdst"].long()
        else:
            vec = dl[p + "vec"].to(emb_dtype)
            cs = dl[p + "cs"].view(torch.int32).reshape(-1)
            dest = slot_of(gid) // t_loc
        j = torch.arange(mb, device=dev)[:, None]
        dest = torch.where(valid, j * n_shards + dest, -1).reshape(-1)
        bk, cnts, _ = a2a_mod.pack_ragged_tree(
            {"vec": vec.reshape(mb * rcap, s), "gid": gid.reshape(-1),
             "cs": cs}, dest, mb * n_shards, rcap)
        fields = {p + "vec": bk["vec"], p + "gid": bk["gid"],
                  p + "cs": bk["cs"].view(torch.uint32),
                  p + "cnt": cnts.reshape(-1, 1)}
        tag = {"xdelta": "dver", "xmig": "mepoch"}.get(field)
        if tag is not None:
            fields[tag] = dl[tag].to(torch.int32).reshape(mb, 1, 1) \
                .expand(mb, n_shards, 1).reshape(mb * n_shards, 1)
        big = dataclasses.replace(lay, n_dest=mb * n_shards)
        return a2a_mod.fuse_wire(fields, big).reshape(mb, n_shards, -1)

    packed = {r[0]: pack_rider(*r) for r in riders}
    if wire_check:
        # the first payload byte of the slot: what the fault hook flips
        first = next(f.offset for f in layout.fields if f.name != "wcs")

    def stage_a(j):
        rows = slice(j * b_mb, (j + 1) * b_mb)
        ix, mk = idx[rows], mask[rows]
        ix_loc, miss_mk = local_miss(ix, mk)
        hits = None
        if use_cache:
            # member m's own batch slice over ALL tables: pool the cache
            # hits locally from the replicated hot block
            mine = slice(m * bs, (m + 1) * bs)
            hits = hc_mod.pooled_hits_of(cache.hot_rows, cache.slot_of,
                                         ix[mine], mk[mine],
                                         impl=hit_impl).to(emb_dtype)
            if fb_rows is not None:
                # degraded tables' residuals never arrive: fold in mean
                # row x residual weight sum with the hit correction, zero
                # exactly where nothing was live
                w = hc_mod.miss_mask_of(cache.slot_of, ix[mine],
                                        mk[mine]).sum(-1)
                hits = hits + ((w * deg_cols.to(w.dtype))[..., None]
                               * fb_rows[None]).to(emb_dtype)
        if use_ragged:
            # pack the live rows first, pool only what ships
            payload, _ = ragged_exchange_pack(
                tables, ix_loc, miss_mk, n_dest=n_shards, cap=cap,
                wire=wire, backend=backend, row_block=rblk, pool_mode=pool)
        else:
            pooled = apply_emb(tables, ix_loc, miss_mk, backend,
                               row_block=rblk, pool_mode=pool,
                               plan=None if plan is None
                               else plan.map(lambda a: a[j]))
            # destination-major: all_to_all's split groups are the leading
            # bs-row blocks, a free reshape
            payload = {k: v.reshape(n_shards, bs, *v.shape[1:])
                       for k, v in a2a_mod.encode_wire(pooled, wire).items()}
        for f, blob in packed.items():
            payload[f] = blob[j]
        if wire_check:
            payload["wcs"] = torch.zeros((n_shards, 1), dtype=torch.uint32,
                                         device=dev)
        buf = a2a_mod.fuse_wire(payload, layout)
        if wire_check:
            # stamp each destination's segment, THEN the injected
            # corruption: the receiver's verify must catch it
            integ.wire_stamp(buf, layout)
            buf[:, first] ^= flip[m]
        # member m's dense rows of microbatch j (matches a2a delivery)
        dm = dense[j * b_mb + m * bs:j * b_mb + (m + 1) * bs]
        return buf, (apply_mlp(params["bot"], dm), hits)      # z0 (bs, s)

    def collective(buf):
        if pipe == "ring":
            # the exchange is deferred to stage_b's rounds: the send buffer
            # itself rides the BLS ring slot
            return bls_mod.Issued(buf)
        return a2a_mod.alltoallv_fused(buf, group)

    def chunk_slice(f, hits, src, wok=None):
        """One source's defused chunk as its dense (bs, t_loc, s) table
        slice: decode (and scatter if ragged), add that source's pooled
        hits.  Sources own disjoint table ranges, so per-peer consumption
        gives the monolithic defuse's bits.  ``wok`` (wire_check) is the
        chunk's verify flag: a corrupt chunk's counts and contribution are
        zeroed; its hits, which never rode the wire, still land."""
        if use_ragged:
            if wok is not None:
                f = dict(f, counts=f["counts"] * wok.to(f["counts"].dtype))
            # a one-source exchange: the flat slot is the shipped id
            sl = ragged_exchange_unpack({k: v[None] for k, v in f.items()},
                                        t_loc=t_loc, bs=bs,
                                        out_dtype=emb_dtype)
        else:
            sl = a2a_mod.decode_wire(f, emb_dtype)             # (bs, t_loc, s)
        if deg_mask[src]:
            sl = torch.zeros_like(sl)
        if wok is not None:
            sl = torch.where(wok, sl, torch.zeros_like(sl))
        if use_cache:
            sl = sl + hits[:, src * t_loc:(src + 1) * t_loc]
        return sl

    def stage_b(recv, side):
        z0, hits = side
        # the harvest stays bytes, (P_src, rider bytes + flag; 0 without
        # riders), until every member's is gathered
        harvest = torch.zeros((n_shards, hbytes), dtype=torch.uint8,
                              device=recv.device)
        if pipe == "ring":
            def consume(carry, src, chunk):
                emb, got = carry
                f = a2a_mod.defuse_wire(chunk, layout)
                wok = integ.wire_verify(chunk, layout) if wire_check \
                    else None
                emb[:, src * t_loc:(src + 1) * t_loc] = chunk_slice(
                    f, hits, src, wok)
                for name, o in h_off.items():
                    got[src, o:o + sub[name].slot_bytes] = f[name]
                if wire_check:
                    got[src, -4:] = (~wok).to(torch.int32).reshape(1) \
                        .view(torch.uint8)
                return emb, got

            emb_all, harvest = a2a_mod.ring_exchange(
                recv, group, n_shards, consume,
                (torch.empty((bs, t_pad, s), dtype=emb_dtype,
                             device=recv.device), harvest))
        else:
            f = a2a_mod.defuse_wire(recv, layout)
            for name, o in h_off.items():
                harvest[:, o:o + sub[name].slot_bytes] = f[name]
            if wire_check:
                wok = integ.wire_verify(recv, layout)           # (P,)
                harvest[:, -4:] = (~wok).to(torch.int32)[:, None] \
                    .view(torch.uint8)
                if use_ragged:
                    # corrupt sources' slot ids are garbage and the mono
                    # scatter spans every source's slots: zero their counts
                    f = dict(f, counts=f["counts"]
                             * wok.to(f["counts"].dtype)[:, None])
            if use_ragged:
                emb_all = ragged_exchange_unpack(f, t_loc=t_loc, bs=bs,
                                                 out_dtype=emb_dtype)
            else:
                # (P, bs, t_loc, s) source-major -> (bs, t_pad, s)
                q = a2a_mod.decode_wire(f, emb_dtype)
                emb_all = q.permute(1, 0, 2, 3).reshape(bs, t_pad, s)
            if deg:
                # drop degraded sources' table columns (x * 1.0 is
                # bit-exact for the survivors)
                emb_all = emb_all * (1 - deg_cols.to(emb_all.dtype))[
                    None, :, None]
            if wire_check:
                keep = wok.repeat_interleave(t_loc)[None, :, None]
                emb_all = torch.where(keep, emb_all,
                                      torch.zeros_like(emb_all))
            if use_cache:
                emb_all = emb_all + hits              # pooled-hit correction
        # placement: the exchanged columns are PHYSICAL slots; gather the
        # real tables back into original order for the interaction
        emb_t = emb_all[:, inv_t[:t]] if inv_t is not None \
            else emb_all[:, :t]
        z = torch.cat([z0[:, None, :], emb_t], dim=1)
        inter = dot_interaction(z, backend)
        top_in = torch.cat([z0, inter.to(z0.dtype)], dim=-1)
        logit = apply_mlp(params["top"], top_in)[..., 0]
        return logit, harvest

    outs, _ = bls_mod.bls_pipeline(stage_a, collective, stage_b,
                                   list(range(mb)), bound)
    outs, harvest = zip(*outs)
    out = torch.stack(outs)                                    # (mb, bs)
    words = torch.empty(0, dtype=torch.int32, device=out.device)
    if return_diag:
        # live-count / drop diagnostics for the cap autotuner: per
        # (microbatch, destination) live rows of this member's tables; the
        # degraded ledger: every live residual bag of a degraded member's
        # tables was served from the fallback, counted on the owning member
        _, miss_all = local_miss(idx, mask)
        cnt = (miss_all > 0).any(dim=-1).reshape(mb, n_shards, bs, t_loc) \
            .sum(dim=(2, 3)).to(torch.int32)
        over = (cnt - cap).clamp(min=0).sum() if use_ragged \
            else cnt.new_zeros(())
        words = torch.stack([w.to(torch.int32) for w in (
            cnt.max(), over, cnt.sum() * deg_mask[m])])
    # ONE all-gather carries every member's logits, diagnostic words,
    # audit words, rider harvests and wire flags as bytes, so none adds a
    # collective
    aw = torch.empty(0, dtype=torch.int32, device=out.device) \
        if audit_words is None else \
        torch.as_tensor(audit_words).to(out.device, torch.int32).reshape(-1)
    n_out = out.numel() * out.element_size()
    n_w = words.numel() * 4
    n_a = aw.numel() * 4
    flat = torch.cat([out.view(torch.uint8).reshape(-1),
                      words.view(torch.uint8), aw.view(torch.uint8),
                      torch.stack(harvest).reshape(-1)])
    got = [torch.empty_like(flat) for _ in range(n_shards)]
    dist.all_gather(got, flat, group=group)
    got = torch.stack(got)
    # (P, mb, bs) -> input order (mb, P, bs): with one data row this is
    # also the pipeline order, so restore_order changes nothing
    logits = got[:, :n_out].contiguous().view(out.dtype) \
        .reshape((n_shards,) + out.shape).permute(1, 0, 2).reshape(-1)
    if not return_diag:
        return logits
    ctr = got[:, n_out:n_out + n_w].contiguous().view(torch.int32)
    audit = got[:, n_out + n_w:n_out + n_w + n_a].contiguous() \
        .view(torch.int32) if audit_words is not None else None
    # every member's harvest: (P_dst, mb, P_src, ...) a leaf
    rows = got[:, n_out + n_w + n_a:].reshape(-1, hbytes) if hbytes \
        else None
    lead = (n_shards, mb, n_shards)
    staged = {}
    for name, o in h_off.items():
        lay = sub[name]
        part = rows[:, o:o + lay.slot_bytes].contiguous()
        staged[name] = {k: v.reshape(lead + v.shape[1:]) for k, v in
                        a2a_mod.defuse_wire(part, lay).items()}
    wbad = rows[:, -4:].contiguous().view(torch.int32).reshape(lead) \
        if wire_check else None
    return logits, ExchangeDiag(
        ctr[:, 0].max(), ctr[:, 1].sum(dtype=torch.int32),
        ctr[:, 2].sum(dtype=torch.int32),
        "ragged" if use_ragged else "dense", cap, dense_rows,
        staged.get("xdelta"), staged.get("xmig"), staged.get("xrep"), wbad,
        audit)


def table_means(tables, t_pad: int, group):
    """(t_pad, s) per-table mean rows, the degraded 'mean' fallback (what a
    deployment keeps as the cold-start embedding).  A member holding only
    its shard gathers the other members' means over ``group``."""
    means = tables.float().mean(dim=1).to(tables.dtype)
    if means.shape[0] == t_pad:
        return means
    parts = [torch.empty_like(means)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, means.contiguous(), group=group)
    return torch.cat(parts)


def build_forward_plans(params, cfg: DLRMConfig, idx, *,
                        microbatches: int = 1, batch_tile: int = 64,
                        cache=None, exchange: Optional[str] = None,
                        ragged_cap: Optional[int] = None,
                        row_block: Optional[int] = None,
                        plan_method: str = "auto", group=None):
    """This member's embedding-bag StreamPlans for
    ``forward_distributed(..., plan=...)``: the plans of its table slice
    for each microbatch of ``idx`` (B, T_pad, hot), leaves stacked over the
    microbatches (the reference returns every member's, for its
    ``shard_map`` to hand out).  None where the reference has no plan to
    build: no model group, the 'ref' backend, a resident regime, or an
    exchange that resolves ragged.  Plans are built from indices alone, so
    a cache's miss masks never invalidate them."""
    group = group if group is not None else mesh_mod.current_group()
    if group is None:
        return None
    tables = params["tables"]
    if resolve_sparse_backend(cfg.sparse_backend, tables.device) == "ref":
        return None
    n_shards = dist.get_world_size(group)
    m = dist.get_rank(group)
    mb = microbatches
    rblk = row_block if row_block is not None else cfg.row_block
    r, s = tables.shape[1], tables.shape[2]
    item = tables.element_size()
    try:
        streamed, _ = eb.resolve_row_block(r, s, item, rblk)
    except ValueError:
        return None                 # the forward raises on its own terms
    if not streamed:
        return None
    use_cache = cache is not None and cache.cache_rows > 0
    b, t_pad, hot = idx.shape
    t_loc = t_pad // n_shards
    use_ragged, _ = resolve_exchange(
        exchange if exchange is not None else cfg.exchange,
        use_cache=use_cache,
        cap=ragged_cap if ragged_cap is not None else cfg.ragged_cap,
        dense_rows=(b // (mb * n_shards)) * t_loc)
    if use_ragged:
        return None
    ix = idx[:, m * t_loc:(m + 1) * t_loc]
    return eb.stacked_stream_plan(t_loc, r, s, item,
                                  ix.reshape(mb, b // mb, t_loc, hot),
                                  batch_tile=batch_tile, row_block=rblk,
                                  plan_method=plan_method)
