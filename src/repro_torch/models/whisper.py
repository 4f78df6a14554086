"""Whisper-style encoder-decoder (arXiv:2212.04356) with a stubbed conv
frontend: the port of ``repro/models/whisper.py``, function by function.

Precomputed (B, S, d_frontend) frame embeddings stand in for the mel
frames, and one linear projection for the two-conv stem; positions are
sinusoidal on both sides and the projections biasless, as in the
reference.  The encoder's self-attention is non-causal and reaches the
flash kernel through ``attention.attend_full(causal=False)``; the decoder's
self-attention is causal (the kernel at prefill, plain at decode) and its
cross attention over the encoder's keys is plain ``_sdpa``, as in the
reference.

Parameters keep the reference's layout: ``enc_layers`` and ``dec_layers``
stack each layer's leaves along a leading axis, as its ``vmap`` over layer
keys does, so ``transformer.params_from_jax`` converts them by a plain
copy.  :func:`init_whisper` draws each leaf in f32 and casts it to
``cfg.dtype``, the bits the reference's apply-time cast of its f32 masters
gives.  :func:`decode_step` writes the self-attention cache in place, as
``attention.decode_step`` does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def sinusoids(length: int, channels: int, device=None):
    """(length, channels) f32 positions, sines then cosines, with the
    reference's arithmetic (its ``channels // 2 - 1`` divisor included)."""
    t = torch.arange(length, device=device)[:, None].float()
    half = torch.arange(channels // 2, device=device)[None, :].float()
    inv = torch.exp(-torch.tensor(math.log(10000.0), device=device) * half
                    / (channels // 2 - 1))
    ang = t * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_enc_layer(gen, cfg: ModelConfig, dev):
    return {
        "ln1": L.init_layernorm(cfg.d_model, cfg.dtype, dev),
        "ln2": L.init_layernorm(cfg.d_model, cfg.dtype, dev),
        "attn": A.init_attention(gen, cfg, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, dev),
    }


def _init_dec_layer(gen, cfg: ModelConfig, dev):
    return {
        "ln1": L.init_layernorm(cfg.d_model, cfg.dtype, dev),
        "ln_c": L.init_layernorm(cfg.d_model, cfg.dtype, dev),
        "ln2": L.init_layernorm(cfg.d_model, cfg.dtype, dev),
        "attn": A.init_attention(gen, cfg, dev),
        "cross": A.init_attention(gen, cfg, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, dev),
    }


def whisper_specs(cfg: ModelConfig):
    attn = A.attention_specs(cfg)
    enc = {"ln1": L.layernorm_specs(), "ln2": L.layernorm_specs(),
           "attn": attn, "mlp": L.mlp_specs()}
    dec = {"ln1": L.layernorm_specs(), "ln_c": L.layernorm_specs(),
           "ln2": L.layernorm_specs(), "attn": attn, "cross": attn,
           "mlp": L.mlp_specs()}
    return {
        "frontend_proj": L.dense_specs(None, "embed", bias=True),
        "enc_layers": L.stack_specs(enc, "layers"),
        "enc_ln": L.layernorm_specs(),
        "embed": L.embedding_specs(),
        "dec_layers": L.stack_specs(dec, "layers"),
        "dec_ln": L.layernorm_specs(),
    }


def cache_specs(cfg: ModelConfig):
    kv = (None, "batch", "kv_seq", "kv_heads", None)
    return {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv,
            "pos": ()}


def init_whisper(seed: int, cfg: ModelConfig, device="cuda"):
    """Random parameters in ``cfg.dtype`` from a ``torch.Generator`` seeded
    with ``seed``, on ``device``, with the reference's distributions and
    layout."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "frontend_proj": L.init_dense(gen, cfg.d_frontend, cfg.d_model,
                                      cfg.dtype, dev, bias=True),
        "enc_layers": T.stack_draws(lambda: _init_enc_layer(gen, cfg, dev),
                                    cfg.n_encoder_layers),
        "enc_ln": L.init_layernorm(cfg.d_model, cfg.dtype, dev),
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.dtype, dev),
        "dec_layers": T.stack_draws(lambda: _init_dec_layer(gen, cfg, dev),
                                    cfg.n_layers),
        "dec_ln": L.init_layernorm(cfg.d_model, cfg.dtype, dev),
    }


def _top(params, cdt):
    return T.cast_params({k: v for k, v in params.items()
                          if k not in ("enc_layers", "dec_layers")}, cdt)


def _layer(layers, i: int):
    return T._map(lambda a: a[i], layers)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(params, cfg: ModelConfig, frames, *, attn_impl: str = "auto"):
    """frames: (B, S_enc, d_frontend) stub embeddings -> (B, S_enc, D).
    Each layer's self-attention is non-causal, through the flash kernel on
    the card (``attn_impl`` as in ``transformer.forward``)."""
    cdt = L.dtype_of(cfg.dtype)
    pc = _top(params, cdt)
    x = L.dense(pc["frontend_proj"], frames.to(cdt))
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(cdt)
    layers = T.cast_params(params["enc_layers"], cdt)
    for lp in T.unbind_groups(layers, cfg.n_encoder_layers):
        out, _ = A.attend_full(lp["attn"], cfg, L.layernorm(lp["ln1"], x),
                               causal=False, attn_impl=attn_impl)
        x = x + out
        x = x + L.mlp(lp["mlp"], L.layernorm(lp["ln2"], x), cfg.act)
    return L.layernorm(pc["enc_ln"], x)


def _cross_kv(params, cfg: ModelConfig, enc_out):
    """Every decoder layer's cross-attention K and V of the encoder's
    output: two (L, B, S_enc, Kh, hd) tensors."""
    b, s, _ = enc_out.shape
    h, hd = cfg.n_kv_heads, cfg.head_dim
    cross = T.cast_params(params["dec_layers"]["cross"],
                          L.dtype_of(cfg.dtype))
    ks, vs = [], []
    for c in T.unbind_groups(cross, cfg.n_layers):
        ks.append(L.dense(c["wk"], enc_out).reshape(b, s, h, hd))
        vs.append(L.dense(c["wv"], enc_out).reshape(b, s, h, hd))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _dec_layer_full(lp, cfg: ModelConfig, x, ck, cv, *,
                    attn_impl: str = "auto"):
    attn, kv = A.attend_full(lp["attn"], cfg, L.layernorm(lp["ln1"], x),
                             attn_impl=attn_impl)
    x = x + attn
    x = x + A.attend_cross(lp["cross"], cfg, L.layernorm(lp["ln_c"], x),
                           ck, cv)
    x = x + L.mlp(lp["mlp"], L.layernorm(lp["ln2"], x), cfg.act)
    return x, kv


def forward(params, cfg: ModelConfig, tokens, frames, *,
            collect_cache: bool = False, remat: bool = True,
            last_only: bool = False, attn_impl: str = "auto"):
    """Teacher-forced forward (training and prefill): (logits, aux), and
    with ``collect_cache`` also ((self k, self v), (cross k, cross v)),
    each (L, B, S, Kh, hd).  ``remat`` runs each decoder layer under
    ``cfg.remat`` when grad is enabled, as the reference's does (its
    encoder layers run without)."""
    cdt = L.dtype_of(cfg.dtype)
    pc = _top(params, cdt)
    enc_out = encode(params, cfg, frames, attn_impl=attn_impl)
    cross_k, cross_v = _cross_kv(params, cfg, enc_out)
    x = L.embed_tokens(pc["embed"], tokens)
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(cdt)
    layers = T.cast_params(params["dec_layers"], cdt)

    def layer(x, lp, ck, cv):
        return _dec_layer_full(lp, cfg, x, ck, cv, attn_impl=attn_impl)

    body = T._remat(layer, cfg) if remat else layer
    ks, vs = [], []
    for i, lp in enumerate(T.unbind_groups(layers, cfg.n_layers)):
        x, (k, v) = body(x, lp, cross_k[i], cross_v[i])
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = L.layernorm(pc["dec_ln"], x[:, -1:] if last_only else x)
    logits = L.tied_lm_head(pc["embed"], x)
    aux = x.new_zeros((), dtype=torch.float32)
    if collect_cache:
        return logits, aux, ((torch.stack(ks), torch.stack(vs)),
                             (cross_k, cross_v))
    return logits, aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               dtype=None, device="cuda"):
    """Zero cache {"self_k", "self_v": (L, batch, max_len, Kh, hd),
    "cross_k", "cross_v": (L, batch, enc_len, Kh, hd), "pos": 0}; ``pos``
    is a host int."""
    dev = resolve_device(device)
    dt = L.dtype_of(dtype or cfg.dtype)
    n, h, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {
        "self_k": torch.zeros((n, batch, max_len, h, hd), dtype=dt,
                              device=dev),
        "self_v": torch.zeros((n, batch, max_len, h, hd), dtype=dt,
                              device=dev),
        "cross_k": torch.zeros((n, batch, enc_len, h, hd), dtype=dt,
                               device=dev),
        "cross_v": torch.zeros((n, batch, enc_len, h, hd), dtype=dt,
                               device=dev),
        "pos": 0,
    }


def decode_step(params, cfg: ModelConfig, tokens, cache):
    """One decode step.  tokens: (B,1) int; cache from :func:`make_cache`
    or assembled from :func:`forward`'s.  Returns (logits (B,1,V), cache
    advanced by one position); the self-attention cache is written in
    place.  The position's sinusoid is row ``pos`` of the cache length's
    table, clamped to its last row as the reference's
    ``dynamic_slice_in_dim`` clamps it."""
    cdt = L.dtype_of(cfg.dtype)
    pc = _top(params, cdt)
    pos = cache["pos"]
    max_len = cache["self_k"].shape[2]
    x = L.embed_tokens(pc["embed"], tokens)
    row = min(pos, max_len - 1)
    x = x + sinusoids(max_len, cfg.d_model,
                      x.device)[row:row + 1].to(cdt)[None]
    layers = T.cast_params(params["dec_layers"], cdt)
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        attn, _ = A.decode_step(lp["attn"], cfg, L.layernorm(lp["ln1"], x),
                                cache["self_k"][i], cache["self_v"][i], pos)
        x = x + attn
        x = x + A.attend_cross(lp["cross"], cfg, L.layernorm(lp["ln_c"], x),
                               cache["cross_k"][i], cache["cross_v"][i])
        x = x + L.mlp(lp["mlp"], L.layernorm(lp["ln2"], x), cfg.act)
    logits = L.tied_lm_head(pc["embed"], L.layernorm(pc["dec_ln"], x))
    return logits, dict(cache, pos=pos + 1)
