"""Grouped-query self-attention (the port of ``repro/models/attention.py``
without the encoder-decoder cross attention).

Supports GQA/MQA, RoPE (neox and the chatglm "2d" interleaved partial
form), qk-norm (qwen3), QKV bias, the attention-logit softcap (gemma2) and
sliding-window masking (gemma2 local layers).  Prefill runs
:func:`attend_full` through ``kernels/ops.flash_attention_op``: the CUDA
kernel for tensors on the card at every sequence length, its plain version
on the CPU (the reference computes the same function with ``_sdpa`` up to
``FLASH_THRESHOLD`` and with its scan flash above).  One-token decode
(:func:`decode_step`) stays plain PyTorch, as the reference computes it
outside any kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -2.3819763e38  # most-negative bf16-representable


def init_attention(gen: torch.Generator, cfg: ModelConfig, device):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": L.init_dense(gen, d, h * hd, cfg.dtype, device,
                           bias=cfg.qkv_bias),
        "wk": L.init_dense(gen, d, kh * hd, cfg.dtype, device,
                           bias=cfg.qkv_bias),
        "wv": L.init_dense(gen, d, kh * hd, cfg.dtype, device,
                           bias=cfg.qkv_bias),
        "wo": L.init_dense(gen, h * hd, d, cfg.dtype, device,
                           scale=(h * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, cfg.dtype, device)
        p["k_norm"] = L.init_rmsnorm(hd, cfg.dtype, device)
    return p


def _project_qkv(params, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(params["wq"], x).reshape(b, s, h, hd)
    k = L.dense(params["wk"], x).reshape(b, s, kh, hd)
    v = L.dense(params["wv"], x).reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.rope_style != "none":
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction,
                         cfg.rope_style)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction,
                         cfg.rope_style)
    return q, k, v


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """q:(B,S,H,D) k,v:(B,T,Kh,D) mask broadcastable to (B,Kh,G,S,T) ->
    (B,S,H*D).  Scores in f32 (the reference's preferred_element_type),
    probabilities cast to v's type before the second product."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) \
        * hd ** -0.5
    scores = L.softcap(scores, cfg.attn_logit_softcap)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h * hd)


def attend_full(params, cfg: ModelConfig, x, *, window: int = 0,
                attn_impl: str = "auto"):
    """Causal prefill self-attention over the whole sequence -> (out
    (B,S,D), (k, v)).  The reference's ``positions`` and ``causal``
    arguments serve its VLM and encoder paths, which the port does not
    run."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = ops.flash_attention_op(q, k, v, window=window,
                                 softcap=cfg.attn_logit_softcap,
                                 impl=attn_impl)
    out = L.dense(params["wo"], out.reshape(b, s, -1))
    return out, (k, v)


def decode_step(params, cfg: ModelConfig, x, cache_k, cache_v, pos: int, *,
                window: int = 0):
    """One-token decode.  x:(B,1,D); cache:(B,Smax,Kh,D); pos: the slot the
    new token occupies (all sequences aligned).  Writes the new k, v into
    the cache in place (the reference returns updated copies; in place
    spares copying the whole cache every step) and returns (out,
    (cache_k, cache_v)).  Past the cache's end the write lands in the last
    slot, as the reference's ``dynamic_update_slice`` clamps it, while the
    rope position and the mask keep the true ``pos``."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    slot = min(pos, cache_k.shape[1] - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    kj = torch.arange(cache_k.shape[1], device=x.device)
    m = kj <= pos
    if window:
        m &= (pos - kj) < window
    out = _sdpa(cfg, q, cache_k, cache_v, m)
    return L.dense(params["wo"], out), (cache_k, cache_v)
