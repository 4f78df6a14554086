"""Grouped-query attention (the port of ``repro/models/attention.py``).

Supports GQA/MQA, RoPE (neox and the chatglm "2d" interleaved partial
form), qk-norm (qwen3), QKV bias, the attention-logit softcap (gemma2),
sliding-window masking (gemma2 local layers), non-causal self-attention
(whisper's encoder) and encoder-decoder cross attention (whisper's
decoder).  Prefill runs :func:`attend_full` through
``kernels/ops.flash_attention_op``, causal or not: the CUDA kernel for
tensors on the card at every sequence length, its plain version on the CPU
(the reference computes the same function with ``_sdpa`` up to
``FLASH_THRESHOLD`` and with its scan flash above).  Under autograd the op
goes through ``ops.FlashAttentionFn``, the port of the reference's flash
custom VJP: the kernel's forward saves each row's log-sum-exp, and the
backward (``kernels/flash_attention_bwd.py``) recomputes the
probabilities chunk by chunk in plain PyTorch.  One-token decode
(:func:`decode_step`) and the cross attention (:func:`attend_cross`) stay
plain PyTorch, as the reference computes both with ``_sdpa`` outside any
kernel.

Over a model axis (``tp``, a ``sharding/tp.py::Plan`` with ``heads``) each
member projects its H / n query heads and their KV heads (Kh / n of them,
or, where Kh does not divide, the one KV head its query heads share,
projected from the whole ``wk``/``wv``), attends at those local head counts
(the flash kernel runs at the member's shapes), keeps a cache of its local
KV heads, and one ``all_reduce`` sums the row-parallel ``wo`` products.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import tp as TP

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


def attention_specs(cfg: ModelConfig):
    p = {
        "wq": L.dense_specs("embed", "heads", bias=cfg.qkv_bias),
        "wk": L.dense_specs("embed", "heads", bias=cfg.qkv_bias),
        "wv": L.dense_specs("embed", "heads", bias=cfg.qkv_bias),
        "wo": L.dense_specs("heads", "embed"),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": ("head_dim",)}
        p["k_norm"] = {"scale": ("head_dim",)}
    return p


def head_group(tp):
    """The model group when the heads are cut over it, else None."""
    return tp.group if tp is not None and tp.heads else None


def _shared(p: dict, group) -> dict:
    """A replicated leaf dict used inside the head-parallel region: its
    gradient is summed over the members."""
    return {k: TP.copy_to(v, group) for k, v in p.items()}


def _kv_heads(p: dict, tp, hd: int, group) -> dict:
    """The columns of a whole ``wk``/``wv`` that project the KV heads this
    member's query heads use ("select")."""
    if tp is None or tp.kv != "select":
        return p
    sl = slice(tp.kv_lo * hd, (tp.kv_lo + tp.kv_n) * hd)
    p = _shared(p, group)
    return {k: v[..., sl] for k, v in p.items()}


def _project_qkv(params, cfg: ModelConfig, x, positions, tp=None):
    b, s, _ = x.shape
    hd = cfg.head_dim
    group = head_group(tp)
    x = TP.copy_to(x, group)
    q = L.dense(params["wq"], x).reshape(b, s, -1, hd)
    k = L.dense(_kv_heads(params["wk"], tp, hd, group), x).reshape(b, s, -1,
                                                                   hd)
    v = L.dense(_kv_heads(params["wv"], tp, hd, group), x).reshape(b, s, -1,
                                                                   hd)
    if cfg.qk_norm:
        q = L.rmsnorm(_shared(params["q_norm"], group), q, cfg.norm_eps)
        k = L.rmsnorm(_shared(params["k_norm"], group), k, cfg.norm_eps)
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


def causal_mask(s: int, t: int, window: int = 0, offset: int = 0,
                device=None):
    """(1,1,1,s,t) boolean mask; query i attends key j iff j <= i + offset
    and, with ``window`` > 0, i + offset - j < window."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= (qi - kj) < window
    return m[None, None, None]


def attend_full(params, cfg: ModelConfig, x, *, window: int = 0,
                positions=None, causal: bool = True,
                attn_impl: str = "auto", tp=None):
    """Self-attention over the whole sequence (prefill, and whisper's
    encoder with ``causal=False``) -> (out (B,S,D), (k, v)).
    ``positions`` (broadcastable to (B, S)) default to 0..S-1: a VLM's
    patch prefix takes the first positions of the joint sequence."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, cfg, x, positions, tp)
    out = ops.flash_attention_op(q, k, v, causal=causal, window=window,
                                 softcap=cfg.attn_logit_softcap,
                                 impl=attn_impl)
    out = L.dense(params["wo"], out.reshape(b, s, -1))
    return TP.reduce_from(out, head_group(tp)), (k, v)


def attend_cross(params, cfg: ModelConfig, x, enc_k, enc_v):
    """Encoder-decoder cross attention (whisper): queries from ``x``
    (B,S,D), keys and values the encoder's (B,T,Kh,hd), no mask -> (B,S,D).
    Plain ``_sdpa``, as in the reference."""
    b, s, _ = x.shape
    q = L.dense(params["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    mask = torch.ones((1, 1, 1, s, enc_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    return L.dense(params["wo"], _sdpa(cfg, q, enc_k, enc_v, mask))


def decode_step(params, cfg: ModelConfig, x, cache_k, cache_v, pos: int, *,
                window: int = 0, tp=None):
    """One-token decode.  x:(B,1,D); cache:(B,Smax,Kh,D); pos: the slot the
    new token occupies (all sequences aligned).  Writes the new k, v into
    the cache in place (the reference returns updated copies; in place
    spares copying the whole cache every step) and returns (out,
    (cache_k, cache_v)).  Past the cache's end the write lands in the last
    slot, as the reference's ``dynamic_update_slice`` clamps it, while the
    rope position and the mask keep the true ``pos``."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, tp)
    slot = min(pos, cache_k.shape[1] - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    m = causal_mask(1, cache_k.shape[1], window, offset=pos, device=x.device)
    out = _sdpa(cfg, q, cache_k, cache_v, m)
    return TP.reduce_from(L.dense(params["wo"], out), head_group(tp)), \
        (cache_k, cache_v)
