"""Decoder-only LM backbone (the port of ``repro/models/transformer.py``,
dense and MoE families).

Layers are stacked into *groups* matching the config's ``layer_pattern``
(gemma2 alternates local/global, so its group is 2 layers; uniform archs use
groups of 1), and every per-layer leaf carries a leading group axis, as in
the reference's ``layers/sub{i}/...`` pytree.  Where the reference scans
over the group axis, the port loops over it in Python, taking views of each
group's leaves.

Parameters live in ``cfg.dtype``: :func:`init_lm` draws each leaf in f32
and casts it before drawing the next, which gives the bits the reference's
apply-time ``cast_params`` of its f32 masters gives, without holding the f32
masters (37 GB at gemma2-9b).  :func:`cast_params` still runs at apply time
and is a no-op on such parameters.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

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


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the options of the reference's transformer the port does
    not run yet."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is not ported yet "
            "(ROADMAP A14)")


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


def _fill(dst, src, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _fill(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def _init_stacked(gen, cfg: ModelConfig, dev, g: int, n_shards: int):
    """``g`` sublayers drawn one after another, stacked along a leading
    group axis as the reference's ``vmap`` over group keys lays them out."""
    out = None
    for i in range(g):
        sub = _init_sublayer(gen, cfg, dev, n_shards)
        if out is None:
            out = _map(lambda a: a.new_empty((g,) + tuple(a.shape)), sub)
        _fill(out, sub, i)
    return out


def init_lm(seed: int, cfg: ModelConfig, device="cuda", n_shards: int = 16):
    """Random parameters in ``cfg.dtype`` from a ``torch.Generator`` seeded
    with ``seed``, on ``device``, with the reference's distributions and
    layout (``truncated_normal`` scales; norms at 0 with ``norm_plus_one``,
    at 1 without; MoE routers in f32, routed experts padded to a multiple
    of ``n_shards``)."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pat, g = layer_pattern(cfg), n_groups(cfg)
    p = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.dtype, dev),
        "layers": {f"sub{i}": _init_stacked(gen, cfg, dev, g, n_shards)
                   for i in range(len(pat))},
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.dtype, dev,
                                     cfg.norm_plus_one),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.init_lm_head(gen, cfg.d_model, cfg.vocab_size,
                                   cfg.dtype, dev)
    return p


def params_from_jax(np_params, device="cuda", dtype: Optional[str] = None):
    """The reference's ``api.init`` pytree, its leaves as numpy arrays, ->
    the port's parameters on ``device``: the same nested dictionaries, so
    a plain copy.  ``dtype`` casts the f32 leaves except MoE routers, as
    the reference's apply-time ``cast_params`` of its f32 masters does."""
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


def _ffn(params, cfg: ModelConfig, h):
    """-> (out, aux): the GLU MLP, or the MoE FFN and its balance loss.
    The LM runs on one device: no process group reaches the MoE FFN."""
    if cfg.moe is not None:
        return M.moe_ffn(params, cfg, h)
    return L.glu_mlp(params, h, cfg.act), h.new_zeros((), dtype=torch.float32)


def block_full(params, cfg: ModelConfig, x, kind: str, *,
               attn_impl: str = "auto"):
    """One sublayer over a full sequence (prefill).  Returns (x, aux_loss,
    (k, v)); k, v build the cache."""
    window = cfg.sliding_window if kind == "local" else 0
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps, cfg.norm_plus_one)
    attn, kv = A.attend_full(params["attn"], cfg, h, window=window,
                             attn_impl=attn_impl)
    if cfg.post_norms:
        attn = L.rmsnorm(params["ln1_post"], attn, cfg.norm_eps,
                         cfg.norm_plus_one)
    x = x + attn
    h = L.rmsnorm(params["ln2"], x, cfg.norm_eps, cfg.norm_plus_one)
    ffn, aux = _ffn(params["ffn"], cfg, h)
    if cfg.post_norms:
        ffn = L.rmsnorm(params["ln2_post"], ffn, cfg.norm_eps,
                        cfg.norm_plus_one)
    return x + ffn, aux, kv


def block_decode(params, cfg: ModelConfig, x, kind: str, cache_k, cache_v,
                 pos: int):
    window = cfg.sliding_window if kind == "local" else 0
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps, cfg.norm_plus_one)
    attn, (ck, cv) = A.decode_step(params["attn"], cfg, h, cache_k, cache_v,
                                   pos, window=window)
    if cfg.post_norms:
        attn = L.rmsnorm(params["ln1_post"], attn, cfg.norm_eps,
                         cfg.norm_plus_one)
    x = x + attn
    h = L.rmsnorm(params["ln2"], x, cfg.norm_eps, cfg.norm_plus_one)
    ffn, aux = _ffn(params["ffn"], cfg, h)
    if cfg.post_norms:
        ffn = L.rmsnorm(params["ln2_post"], ffn, cfg.norm_eps,
                        cfg.norm_plus_one)
    return x + ffn, aux, (ck, cv)


# ---------------------------------------------------------------------------
# embedding-in / logits-out
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg: ModelConfig, tokens):
    scale = cfg.d_model ** 0.5 if cfg.scale_embeds else None
    return L.embed_tokens(params["embed"], tokens, scale)


def logits_out(params, cfg: ModelConfig, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, cfg.norm_plus_one)
    if cfg.tie_embeddings:
        return L.tied_lm_head(params["embed"], x, cfg.final_logit_softcap)
    return L.lm_head(params["head"], x, cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _forward(params, cfg: ModelConfig, tokens, *, cache_len, last_only,
             attn_impl):
    """The layers over the whole sequence; with ``cache_len`` the k, v of
    every layer land in a (groups, group, B, cache_len, Kh, hd) cache,
    zero past the sequence."""
    check_ported(cfg)
    pat = layer_pattern(cfg)
    cdt = L.dtype_of(cfg.dtype)
    pc = cast_params({k: v for k, v in params.items() if k != "layers"}, cdt)
    layers = cast_params(params["layers"], cdt)
    x = embed_inputs(pc, cfg, tokens)
    b, s = tokens.shape
    cache = None if cache_len is None else \
        make_cache(cfg, b, cache_len, device=x.device)
    aux = x.new_zeros((), dtype=torch.float32)
    for gi in range(n_groups(cfg)):
        for i, kind in enumerate(pat):
            sub = _map(lambda a: a[gi], layers[f"sub{i}"])
            x, a, (k, v) = block_full(sub, cfg, x, kind, attn_impl=attn_impl)
            aux = aux + a
            if cache is not None:
                cache["k"][gi, i, :, :s] = k
                cache["v"][gi, i, :, :s] = v
    logits = logits_out(pc, cfg, x[:, -1:] if last_only else x)
    return logits, aux, cache


def forward(params, cfg: ModelConfig, tokens, *, last_only: bool = False,
            attn_impl: str = "auto"):
    """Returns (logits, aux_loss) over the full sequence.  ``last_only``
    slices the stream before the LM head.  ``attn_impl`` picks the attention
    of ``kernels/ops.py`` ("auto": the CUDA kernel on the card; "ref": the
    plain version).  The reference's ``remat``, frontend and
    ``collect_cache`` arguments serve training, frontends and its own
    prefill; the port's :func:`prefill` builds the cache."""
    logits, aux, _ = _forward(params, cfg, tokens, cache_len=None,
                              last_only=last_only, attn_impl=attn_impl)
    return logits, aux


def prefill(params, cfg: ModelConfig, tokens, pad_to: Optional[int] = None,
            *, attn_impl: str = "auto"):
    """Full-sequence forward that also returns a KV cache sized ``pad_to``
    (defaults to the prompt length) -> (last position's logits (B,1,V),
    cache)."""
    s = tokens.shape[1]
    logits, _, cache = _forward(params, cfg, tokens,
                                cache_len=max(pad_to or s, s),
                                last_only=True, attn_impl=attn_impl)
    cache["pos"] = s
    return logits, cache


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Zero cache {"k", "v": (groups, group, batch, max_len, Kh, hd),
    "pos": 0}; ``pos`` is a host int."""
    dev = resolve_device(device)
    dt = L.dtype_of(dtype or cfg.dtype)
    shape = (n_groups(cfg), len(layer_pattern(cfg)), batch, max_len,
             cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


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
    check_ported(cfg)
    pat = layer_pattern(cfg)
    cdt = L.dtype_of(cfg.dtype)
    pc = cast_params({k: v for k, v in params.items() if k != "layers"}, cdt)
    layers = cast_params(params["layers"], cdt)
    pos = cache["pos"]
    x = embed_inputs(pc, cfg, tokens)
    for gi in range(n_groups(cfg)):
        for i, kind in enumerate(pat):
            sub = _map(lambda a: a[gi], layers[f"sub{i}"])
            x, _, _ = block_decode(sub, cfg, x, kind, cache["k"][gi, i],
                                   cache["v"][gi, i], pos)
    logits = logits_out(pc, cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
