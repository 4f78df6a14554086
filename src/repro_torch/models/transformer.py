"""Decoder-only LM backbone (the port of ``repro/models/transformer.py``,
dense, MoE and VLM families).

A config with a ``frontend`` (llava's ``vision_patches``) gets a
``frontend_proj`` that projects precomputed frontend embeddings (B, N,
d_frontend) to the model width; they are put ahead of the token
embeddings, so the patches take positions 0..N-1 of the joint sequence,
for the rope and the causal mask alike.

Layers are stacked into *groups* matching the config's ``layer_pattern``
(gemma2 alternates local/global, so its group is 2 layers; uniform archs use
groups of 1), and every per-layer leaf carries a leading group axis, as in
the reference's ``layers/sub{i}/...`` pytree.  Where the reference scans
over the group axis, the port loops over it in Python, taking views of each
group's leaves.

Serving parameters live in ``cfg.dtype``: :func:`init_lm` draws each leaf
in f32 and casts it before drawing the next, which gives the bits the
reference's apply-time ``cast_params`` of its f32 masters gives, without
holding the f32 masters (37 GB at gemma2-9b).  Training keeps f32 masters
(``init_lm(..., dtype="float32")``, the same draws uncast): the forward
casts the layer stack to ``cfg.dtype`` once a call, so the gradients reach
the masters through the cast, and each layer group runs under the
reference's ``_remat`` policy (``cfg.remat``: "full", "dots" or "none").
:func:`lm_loss` is the reference's token cross-entropy.

Over a mesh (``sharding/partition.py::axis_rules``) the model reads the
ambient mesh and rules where the reference calls ``constrain``: each
member holds its block of every parameter (``api.param_layout``) and
:func:`sharding.tp.plan` says which; attention, the MLP or MoE FFN, the
embedding and the head issue their collectives over the model group, and
the cache holds the member's KV heads.  Under the train rules'
``res_seq`` the residual stream between blocks is this member's block of
the sequence (Megatron's sequence parallelism, ``sharding/tp.py``): the
embedding leaves into it, the norms run on it (their scales' gradients
summed over the members), attention and the FFN gather it on entry and
reduce-scatter on exit, and it is gathered whole before the final norm,
so the loss is the one-device one.  Under ``kv_seq`` the cache holds a
block of positions for every KV head (``attention.decode_step``).  No
argument of the entry points changes.  The batch is the caller's: the
forward runs the batch it is given, which a data member of a training
step has already cut.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.sharding import fsdp, partition
from repro_torch.sharding import tp as TP

# ---------------------------------------------------------------------------
# layer pattern / grouping
# ---------------------------------------------------------------------------


def layer_pattern(cfg: ModelConfig) -> tuple[str, ...]:
    if cfg.layer_pattern == "global":
        return ("global",)
    if cfg.layer_pattern == "local_global":
        return ("local", "global")
    raise ValueError(cfg.layer_pattern)


def n_groups(cfg: ModelConfig) -> int:
    pat = layer_pattern(cfg)
    if cfg.n_layers % len(pat):
        raise ValueError(f"{cfg.n_layers} layers do not group by {pat}")
    return cfg.n_layers // len(pat)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _init_sublayer(gen, cfg: ModelConfig, dev, n_shards: int):
    p = {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, dev, cfg.norm_plus_one),
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, dev, cfg.norm_plus_one),
        "attn": A.init_attention(gen, cfg, dev),
    }
    if cfg.moe is not None:
        p["ffn"] = M.init_moe(gen, cfg, dev, n_shards)
    else:
        p["ffn"] = L.init_glu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, dev)
    if cfg.post_norms:
        p["ln1_post"] = L.init_rmsnorm(cfg.d_model, cfg.dtype, dev,
                                       cfg.norm_plus_one)
        p["ln2_post"] = L.init_rmsnorm(cfg.d_model, cfg.dtype, dev,
                                       cfg.norm_plus_one)
    return p


def _sublayer_specs(cfg: ModelConfig):
    p = {
        "ln1": L.rmsnorm_specs(),
        "ln2": L.rmsnorm_specs(),
        "attn": A.attention_specs(cfg),
        "ffn": M.moe_specs(cfg) if cfg.moe is not None else L.glu_mlp_specs(),
    }
    if cfg.post_norms:
        p["ln1_post"] = L.rmsnorm_specs()
        p["ln2_post"] = L.rmsnorm_specs()
    return p


def lm_specs(cfg: ModelConfig):
    pat = layer_pattern(cfg)
    sub = _sublayer_specs(cfg)
    # prepend the stacked "layers" axis to every per-layer leaf
    stacked = L.stack_specs({f"sub{i}": sub for i in range(len(pat))},
                            "layers")
    p = {
        "embed": L.embedding_specs(),
        "layers": stacked,
        "final_norm": L.rmsnorm_specs(),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.lm_head_specs()
    if cfg.frontend != "none":
        p["frontend_proj"] = L.dense_specs(None, "embed")
    return p


def cache_specs(cfg: ModelConfig):
    return {"k": (None, None, "batch", "kv_seq", "kv_heads", None),
            "v": (None, None, "batch", "kv_seq", "kv_heads", None),
            "pos": ()}


def _fill(dst, src, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _fill(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def stack_draws(draw, n: int):
    """``n`` parameter trees from ``draw()``, drawn one after another and
    stacked along a leading axis, as the reference's ``vmap`` over per-layer
    keys lays them out; one tree is held beside the stack at a time."""
    out = None
    for i in range(n):
        sub = draw()
        if out is None:
            out = _map(lambda a: a.new_empty((n,) + tuple(a.shape)), sub)
        _fill(out, sub, i)
    return out


def _init_stacked(gen, cfg: ModelConfig, dev, g: int, n_shards: int,
                  cut=lambda t: t):
    """``g`` sublayers stacked along a leading group axis, each ``cut``
    as it is drawn."""
    return stack_draws(lambda: cut(_init_sublayer(gen, cfg, dev, n_shards)),
                       g)


def init_lm(seed: int, cfg: ModelConfig, device="cuda", n_shards: int = 16,
            dtype: Optional[str] = None, layout=None):
    """Random parameters in ``cfg.dtype`` (or ``dtype``: "float32" gives
    the f32 training masters) from a ``torch.Generator`` seeded with
    ``seed``, on ``device``, with the reference's distributions and layout
    (``truncated_normal`` scales; norms at 0 with ``norm_plus_one``, at 1
    without; MoE routers in f32, routed experts padded to a multiple of
    ``n_shards``; a ``frontend_proj`` with a frontend)."""
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    dev = resolve_device(device)
    gen = L.generator(seed, dev)
    pat, g = layer_pattern(cfg), n_groups(cfg)

    def cut(path, tree):
        if layout is None:
            return tree
        specs = layout.specs
        for k in path:
            specs = specs[k]
        if path[0] == "layers":   # drawn without the stacked axis
            specs = partition.map_specs(lambda _, t: t[1:], specs)
        return partition.shard_tree(tree, partition.Layout(layout.mesh,
                                                           specs))

    p = {
        "embed": cut(("embed",), L.init_embedding(
            gen, cfg.vocab_size, cfg.d_model, cfg.dtype, dev)),
        "layers": {f"sub{i}": _init_stacked(
            gen, cfg, dev, g, n_shards,
            functools.partial(cut, ("layers", f"sub{i}")))
            for i in range(len(pat))},
        "final_norm": cut(("final_norm",), L.init_rmsnorm(
            cfg.d_model, cfg.dtype, dev, cfg.norm_plus_one)),
    }
    if not cfg.tie_embeddings:
        p["head"] = cut(("head",), L.init_lm_head(
            gen, cfg.d_model, cfg.vocab_size, cfg.dtype, dev))
    if cfg.frontend != "none":
        p["frontend_proj"] = cut(("frontend_proj",), L.init_dense(
            gen, cfg.d_frontend, cfg.d_model, cfg.dtype, dev))
    return p


def params_from_jax(np_params, device="cuda", dtype: Optional[str] = None):
    """The reference's ``api.init`` pytree, its leaves as numpy arrays, ->
    the port's parameters on ``device``: the same nested dictionaries, so
    a plain copy.  ``dtype`` casts the f32 leaves except MoE routers, as
    the reference's apply-time ``cast_params`` of its f32 masters does;
    "float32" (or None) keeps the reference's f32 masters, as training
    takes them."""
    dev = resolve_device(device)
    tree = _map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                np_params)
    if dtype is not None:
        tree = cast_params(tree, L.dtype_of(dtype))
    return _map(lambda t: t.to(dev), tree)


def cast_params(tree, dtype: torch.dtype):
    """f32 leaves -> ``dtype``, except MoE router weights (the reference's
    ``cast_params``); a leaf already in ``dtype`` is returned as is."""
    def cast(path, a):
        if a.dtype == torch.float32 and "router" not in path:
            return a.to(dtype)
        return a

    return _map_with_path(cast, tree)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _ffn(params, cfg: ModelConfig, h, tp=None):
    """-> (out, aux): the GLU MLP, or the MoE FFN and its balance loss;
    over a mesh (``tp``) the MoE FFN runs ``moe.moe_members`` and the MLP
    is column/row-parallel where its width is cut."""
    if cfg.moe is not None:
        if tp is None:
            return M.moe_ffn(params, cfg, h)
        return M.moe_members(params, cfg, h, tp)
    group = tp.group if tp is not None and tp.mlp else None
    seq = TP.seq_group(tp)
    if seq is not None and group is None:
        # a whole MLP runs token by token on the block: its leaves see
        # this member's positions
        params = A._shared(params, seq)
    return L.glu_mlp(params, h, cfg.act, group, seq=seq is not None), \
        h.new_zeros((), dtype=torch.float32)


# the sublayer's norms: on the sequence-cut stream they see this member's
# positions only
NORMS = ("ln1", "ln2", "ln1_post", "ln2_post")


def seq_norms(params, tp):
    """``params`` with its norm scales through ``tp.copy_to`` over the
    model group under ``res_seq`` (their gradients summed over the
    members), else as they are."""
    seq = TP.seq_group(tp)
    if seq is None:
        return params
    return {k: A._shared(v, seq) if k in NORMS else v
            for k, v in params.items()}


def block_full(params, cfg: ModelConfig, x, kind: str, *,
               attn_impl: str = "auto", tp=None):
    """One sublayer over a full sequence (prefill).  Returns (x, aux_loss,
    (k, v)); k, v build the cache.  Under ``res_seq`` ``x`` is this
    member's block of the sequence and the norms run on it (the
    reference's "Megatron LN placement"); k, v are the whole sequence's."""
    window = cfg.sliding_window if kind == "local" else 0
    params = seq_norms(params, tp)
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps, cfg.norm_plus_one)
    attn, kv = A.attend_full(params["attn"], cfg, h, window=window,
                             attn_impl=attn_impl, tp=tp)
    if cfg.post_norms:
        attn = L.rmsnorm(params["ln1_post"], attn, cfg.norm_eps,
                         cfg.norm_plus_one)
    x = x + attn
    h = L.rmsnorm(params["ln2"], x, cfg.norm_eps, cfg.norm_plus_one)
    ffn, aux = _ffn(params["ffn"], cfg, h, tp)
    if cfg.post_norms:
        ffn = L.rmsnorm(params["ln2_post"], ffn, cfg.norm_eps,
                        cfg.norm_plus_one)
    return x + ffn, aux, kv


def block_decode(params, cfg: ModelConfig, x, kind: str, cache_k, cache_v,
                 pos: int, tp=None, cut=None, length=None):
    window = cfg.sliding_window if kind == "local" else 0
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps, cfg.norm_plus_one)
    attn, (ck, cv) = A.decode_step(params["attn"], cfg, h, cache_k, cache_v,
                                   pos, window=window, tp=tp, cut=cut,
                                   length=length)
    if cfg.post_norms:
        attn = L.rmsnorm(params["ln1_post"], attn, cfg.norm_eps,
                         cfg.norm_plus_one)
    x = x + attn
    h = L.rmsnorm(params["ln2"], x, cfg.norm_eps, cfg.norm_plus_one)
    ffn, aux = _ffn(params["ffn"], cfg, h, tp)
    if cfg.post_norms:
        ffn = L.rmsnorm(params["ln2_post"], ffn, cfg.norm_eps,
                        cfg.norm_plus_one)
    return x + ffn, aux, (ck, cv)


# ---------------------------------------------------------------------------
# embedding-in / logits-out
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg: ModelConfig, tokens, frontend_embeds=None,
                 tp=None):
    """Token embeddings (B, S, D); with ``frontend_embeds`` (B, N,
    d_frontend), their projection (in the compute type) ahead of them ->
    (B, N + S, D).  Under ``res_seq`` this member's block of that
    sequence: the vocab-parallel sum reduce-scattered to it, or the joint
    sequence (or a whole table's rows) split."""
    scale = cfg.d_model ** 0.5 if cfg.scale_embeds else None
    group = tp.group if tp is not None and tp.emb_vocab else None
    seq = TP.seq_group(tp)
    scatter = seq is not None and group is not None and \
        frontend_embeds is None
    x = L.embed_tokens(params["embed"], tokens, scale, group, seq=scatter)
    if frontend_embeds is not None:
        fe = L.dense(params["frontend_proj"], frontend_embeds.to(x.dtype))
        x = torch.cat([fe, x], dim=1)
    return x if scatter else TP.split_seq(x, seq)


def logits_out(params, cfg: ModelConfig, x, tp=None):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, cfg.norm_plus_one)
    if cfg.tie_embeddings:
        group = tp.group if tp is not None and tp.emb_vocab else None
        return L.tied_lm_head(params["embed"], x, cfg.final_logit_softcap,
                              group)
    group = tp.group if tp is not None and tp.vocab else None
    return L.lm_head(params["head"], x, cfg.final_logit_softcap, group)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------


REMATS = ("full", "dots", "none")


def _save_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of "dots": keep the outputs of
    products without batch dimensions (``jax.checkpoint_policies.
    checkpoint_dots_with_no_batch_dims``), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the reference's ``_remat`` policy ``cfg.remat``: "full"
    recomputes the whole call in the backward, "dots" keeps the
    non-batched products' outputs and recomputes the rest, "none" saves
    everything.  With grad disabled (serving) it is ``fn`` itself."""
    if cfg.remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {cfg.remat!r}")
    if cfg.remat == "none":
        return fn
    from torch.utils import checkpoint as ckpt
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, **kw)

    return run


def unbind_groups(tree, n: int) -> list:
    """A stacked tree's ``n`` per-group trees of views.  Each leaf is split
    once (``unbind``), so its backward stacks the groups' gradients in one
    pass, where a select per group would add a full-size zero tensor per
    group."""
    split = _map(lambda a: a.unbind(0), tree)
    return [_map(lambda t: t[i], split) for i in range(n)]


def _forward(params, cfg: ModelConfig, tokens, frontend_embeds, *,
             collect_cache, pad_to, last_only, attn_impl, remat=False):
    """The layers over the whole (joint) sequence of S positions; with
    ``collect_cache`` the k, v of every layer land in a (groups, group, B,
    max(pad_to or S, S), Kh, hd) cache, zero past the sequence.  With
    ``remat`` each group runs under :func:`_remat`."""
    pat = layer_pattern(cfg)
    n_front = 0 if frontend_embeds is None else frontend_embeds.shape[1]
    tp = TP.for_sequence(TP.plan(cfg), n_front + tokens.shape[1])
    cdt = L.dtype_of(cfg.dtype)
    specs = lm_specs(cfg)
    # FSDP: the non-layer leaves are gathered over data here, each group's
    # at the top of its (remat) body
    pc = fsdp.gathered(cast_params(
        {k: v for k, v in params.items() if k != "layers"}, cdt), specs)
    # the stack is cast once a call (the f32 masters' gradients flow back
    # through the cast), then split into groups of views
    groups = unbind_groups(cast_params(params["layers"], cdt), n_groups(cfg))
    x = embed_inputs(pc, cfg, tokens, frontend_embeds, tp)
    b, s = x.shape[0], n_front + tokens.shape[1]
    cache = make_cache(cfg, b, max(pad_to or s, s), device=x.device) \
        if collect_cache else None
    cut = TP.cache_cut(tp)

    gather = fsdp.gatherer(specs["layers"], skip=1)

    def group_fn(x, gp):
        gp = gather(gp)
        aux, kvs = x.new_zeros((), dtype=torch.float32), []
        for i, kind in enumerate(pat):
            x, a, kv = block_full(gp[f"sub{i}"], cfg, x, kind,
                                  attn_impl=attn_impl, tp=tp)
            aux = aux + a
            kvs.append(kv)
        return x, aux, kvs

    body = _remat(group_fn, cfg) if remat else group_fn
    aux = x.new_zeros((), dtype=torch.float32)
    for gi, gp in enumerate(groups):
        x, a, kvs = body(x, gp)
        aux = aux + a
        if cache is not None:
            for i, (k, v) in enumerate(kvs):
                if cut is None:
                    cache["k"][gi, i, :, :s] = k
                    cache["v"][gi, i, :, :s] = v
                    continue
                cache["k"][gi, i], cache["v"][gi, i] = A.cache_block(
                    cfg, k, v, tp, cut, cache["k"].shape[3])
        del kvs
    # the head and the loss see the whole stream (the gather's backward
    # keeps this member's block of their gradient, whole on every member)
    x = TP.gather_from(x, TP.seq_group(tp), dim=1)
    logits = logits_out(pc, cfg, x[:, -1:] if last_only else x, tp)
    return logits, aux, cache


def forward(params, cfg: ModelConfig, tokens, frontend_embeds=None, *,
            remat: bool = True, last_only: bool = False,
            attn_impl: str = "auto"):
    """Returns (logits, aux_loss) over the full sequence: N + S positions
    with ``frontend_embeds`` (B, N, d_frontend).  ``remat`` runs each layer
    group under ``cfg.remat`` when grad is enabled (training), as the
    reference's does.  ``last_only`` slices the stream before the LM head.
    ``attn_impl`` picks the attention of ``kernels/ops.py`` ("auto": the
    CUDA kernel on the card; "ref": the plain version).  The reference's
    ``collect_cache`` serves its own prefill; the port's :func:`prefill`
    builds the cache."""
    logits, aux, _ = _forward(params, cfg, tokens, frontend_embeds,
                              collect_cache=False, pad_to=None,
                              last_only=last_only, attn_impl=attn_impl,
                              remat=remat)
    return logits, aux


def prefill(params, cfg: ModelConfig, tokens, frontend_embeds=None,
            pad_to: Optional[int] = None, *, attn_impl: str = "auto"):
    """Full-sequence forward that also returns a KV cache sized ``pad_to``
    (defaults to the sequence length: N + S positions with
    ``frontend_embeds``) -> (last position's logits (B,1,V), cache whose
    ``pos`` is N + S)."""
    logits, _, cache = _forward(params, cfg, tokens, frontend_embeds,
                                collect_cache=True, pad_to=pad_to,
                                last_only=True, attn_impl=attn_impl)
    cache["pos"] = (0 if frontend_embeds is None
                    else frontend_embeds.shape[1]) + tokens.shape[1]
    return logits, cache


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Zero cache {"k", "v": (groups, group, batch, max_len, Kh, hd),
    "pos": 0}; ``pos`` is a host int.  Over a mesh Kh is this member's KV
    heads; under ``kv_seq`` (``tp.kv_cut``) the cache is this member's
    block of ``cut.size(max_len)`` positions for every KV head (the last
    block padded where ``max_len`` does not divide), and "len" keeps
    ``max_len``."""
    dev = resolve_device(device)
    dt = L.dtype_of(dtype or cfg.dtype)
    tp = TP.plan(cfg)
    cut = TP.cache_cut(tp)
    kh = tp.kv_n if tp is not None and tp.heads else cfg.n_kv_heads
    t = max_len
    if cut is not None:
        kh, t = cfg.n_kv_heads, cut.size(max_len)
    shape = (n_groups(cfg), len(layer_pattern(cfg)), batch, t,
             kh, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}
    if cut is not None:
        cache["len"] = max_len
    return cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_step(params, cfg: ModelConfig, tokens, cache, *,
                attn_impl: str = "auto"):
    """One decode step.  tokens: (B,1) int; cache from make_cache/prefill.
    Returns (logits (B,1,V), cache advanced by one position); the cache's
    tensors are updated in place.  ``attn_impl`` changes nothing: decode
    attention is plain PyTorch for every value (the reference computes it
    outside any kernel).  The argument is only validated, so that decode
    takes the same keywords as :func:`prefill`."""
    if attn_impl not in ops.IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; have {ops.IMPLS}")
    pat = layer_pattern(cfg)
    tp = TP.plan(cfg)
    cdt = L.dtype_of(cfg.dtype)
    pc = cast_params({k: v for k, v in params.items() if k != "layers"}, cdt)
    layers = cast_params(params["layers"], cdt)
    pos = cache["pos"]
    tp = TP.for_sequence(tp, 1)      # one position: the stream stays whole
    cut = TP.cache_cut(tp)
    x = embed_inputs(pc, cfg, tokens, tp=tp)
    for gi in range(n_groups(cfg)):
        for i, kind in enumerate(pat):
            sub = _map(lambda a: a[gi], layers[f"sub{i}"])
            x, _, _ = block_decode(sub, cfg, x, kind, cache["k"][gi, i],
                                   cache["v"][gi, i], pos, tp, cut,
                                   cache.get("len"))
    logits = logits_out(pc, cfg, x, tp)
    return logits, dict(cache, pos=pos + 1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def lm_loss(logits, labels, aux=None, aux_weight: float = 0.01):
    """Mean token cross-entropy in f32; labels < 0 are masked.  With
    ``aux`` (the MoE balance loss) adds ``aux_weight * aux``."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels.clamp_min(0).long()[..., None],
                              dim=-1)[..., 0]
    mask = (labels >= 0).float()
    loss = torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)
    if aux is not None:
        loss = loss + aux_weight * aux
    return loss
