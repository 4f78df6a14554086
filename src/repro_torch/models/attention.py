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

Under ``res_seq`` (``tp.res_seq``) :func:`attend_full` takes this member's
block of the sequence: it enters through ``tp.gather_seq``, runs the flash
kernel at the member's heads over the whole sequence (the rope positions
are the gathered sequence's) and leaves through ``tp.scatter_seq``; where
attention runs replicated it keeps its block of the output, and its
leaves, which then see only this member's positions, are summed over the
members in the backward (``tp.copy_to``).

Under ``kv_seq`` (a ``tp.SeqCut``) a cache holds a block of positions for
every KV head.  :func:`decode_step` gathers the new token's q, k and v over
the heads, the member whose block owns the slot writes k and v, and every
member attends every query head over its block: per row an f32 max, sum
and unnormalised output, joined across the members (:func:`_sdpa_cut`: one
``all_gather`` of the three, combined on each member).  The masks use
global positions; a block with no live position adds zero weight.
:func:`cache_block` moves a prefill's k, v (this member's heads, every
position) into that layout.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import partition
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


def _project_qkv(params, cfg: ModelConfig, x, positions, tp=None,
                 entered: bool = False):
    """q, k, v of this member's heads; ``entered``: ``x`` came through
    ``tp.gather_seq``, whose backward already sums its gradient."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    group = head_group(tp)
    if not entered:
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
    seq = TP.seq_group(tp)
    if seq is not None:
        if not tp.heads:
            # replicated attention: its leaves see this member's positions
            params = {k: _shared(v, seq) for k, v in params.items()}
        x = TP.gather_seq(x, seq)
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(params, cfg, x, positions, tp,
                           entered=seq is not None)
    out = ops.flash_attention_op(q, k, v, causal=causal, window=window,
                                 softcap=cfg.attn_logit_softcap,
                                 impl=attn_impl)
    out = L.dense(params["wo"], out.reshape(b, s, -1))
    if seq is None:
        return TP.reduce_from(out, head_group(tp)), (k, v)
    if tp.heads:
        return TP.scatter_seq(out, seq), (k, v)
    size = s // tp.n
    return out.narrow(1, tp.m * size, size), (k, v)


def attend_cross(params, cfg: ModelConfig, x, enc_k, enc_v, cut=None):
    """Encoder-decoder cross attention (whisper): queries from ``x``
    (B,S,D), keys and values the encoder's (B,T,Kh,hd), no mask -> (B,S,D).
    Plain ``_sdpa``, as in the reference; with ``cut`` (a ``tp.SeqCut``)
    ``enc_k``, ``enc_v`` are this member's block of the encoder's
    positions and the members' parts are joined (:func:`_sdpa_cut`)."""
    b, s, _ = x.shape
    q = L.dense(params["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    mask = torch.ones((1, 1, 1, s, enc_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    if cut is None:
        return L.dense(params["wo"], _sdpa(cfg, q, enc_k, enc_v, mask))
    return L.dense(params["wo"], _sdpa_cut(cfg, q, enc_k, enc_v, mask, mask,
                                           cut.group))


def _sdpa_cut(cfg: ModelConfig, q, k, v, live, valid, group):
    """:func:`_sdpa` with k, v this member's block of the key positions:
    ``live`` masks as the reference's mask does (a masked key scores
    ``NEG_INF``), ``valid`` drops the padding past the axis' end (it
    scores -inf, weight 0).  Each member keeps per row its f32 max, its
    sum of exp(score - max) and its output unnormalised; one
    ``all_gather`` brings every member's three, and each member joins
    them: member i weighs exp(max_i - max), the sums and outputs add up.
    A block with no live key adds zero weight wherever another block has
    one (exp(NEG_INF - max) is 0), a block of padding alone adds nothing;
    where no block has a live key, every valid key weighs the same, as
    the reference's softmax over an all-``NEG_INF`` row gives."""
    b, s, h, hd = q.shape
    kh, g = k.shape[2], h // k.shape[2]
    qg = q.reshape(b, s, kh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) \
        * hd ** -0.5
    scores = L.softcap(scores, cfg.attn_logit_softcap)
    scores = torch.where(live, scores, NEG_INF)
    scores = torch.where(valid, scores, float("-inf"))
    mx = scores.amax(dim=-1)                              # (b, kh, g, s)
    p = torch.exp(scores - torch.where(torch.isinf(mx), 0.0, mx)[..., None])
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.float())
    mine = torch.cat([mx[..., None], p.sum(-1)[..., None], o], dim=-1)
    parts = torch.stack(partition._gather_blocks(mine, group))
    top = parts[..., 0].amax(dim=0)
    w = torch.exp(parts[..., 0] - top)[..., None]
    joined = (w * parts[..., 1:]).sum(dim=0)              # (b, kh, g, s, 1+d)
    out = joined[..., 1:] / joined[..., :1]
    return out.permute(0, 3, 1, 2, 4).to(v.dtype).reshape(b, s, h * hd)


def _select_first(cfg: ModelConfig, tp) -> list:
    """Under the plan's "select", each KV head's first member that
    projects it (the one its first query head sits on)."""
    per = cfg.n_heads // tp.n
    return [(j * (cfg.n_heads // cfg.n_kv_heads)) // per
            for j in range(cfg.n_kv_heads)]


def _all_heads(cfg: ModelConfig, q, k, v, tp):
    """q, k, v (B, 1, local heads, hd) of this member -> every head's, on
    every member: one ``all_gather`` over the model group where the heads
    are cut ("cut": the members' blocks in order; "select": each KV head
    from the first member that projected it)."""
    if tp is None or not tp.heads:
        return q, k, v
    hq, hk = q.shape[2], k.shape[2]
    parts = partition._gather_blocks(torch.cat([q, k, v], dim=2), tp.group)
    q = torch.cat([p[:, :, :hq] for p in parts], dim=2)
    owners = range(tp.n) if tp.kv == "cut" else _select_first(cfg, tp)
    k = torch.cat([parts[i][:, :, hq:hq + hk] for i in owners], dim=2)
    v = torch.cat([parts[i][:, :, hq + hk:] for i in owners], dim=2)
    return q, k, v


def cache_block(cfg: ModelConfig, k, v, tp, cut, size: int):
    """A prefill's k and v: (B, S, this member's KV heads, hd) over the
    whole sequence -> this member's blocks of a cache cut by ``cut``:
    (B, ``size``, every KV head, hd), positions ``cut.m * size`` onward,
    zero past S.  Where the heads are cut ("cut" or "select") one
    ``all_to_all_single`` over the model group sends each member of the
    row its positions of both; "select" keeps each KV head from the first
    member that projected it."""
    hk = k.shape[2]
    kv = torch.cat([k, v], dim=2)
    b, s = kv.shape[:2]

    def positions(blk):
        lo = blk * size
        out = kv.new_zeros((b, size) + tuple(kv.shape[2:]))
        n = max(0, min(s, lo + size) - lo)
        if n:
            out[:, :n] = kv[:, lo:lo + n]
        return out

    if tp is None or not tp.heads:
        mine = positions(cut.m)
        return mine[:, :, :hk], mine[:, :, hk:]
    if "model" not in cut.axes:
        raise ValueError(f"heads cut over 'model' and a cache cut over "
                         f"{cut.axes}: every member of a row would need "
                         "every KV head of the same positions")
    # the row's blocks: this member's block less its model index
    base = cut.m - tp.m
    send = torch.stack([positions(base + j) for j in range(tp.n)])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=tp.group)
    owners = range(tp.n) if tp.kv == "cut" else _select_first(cfg, tp)
    return (torch.cat([recv[i][:, :, :hk] for i in owners], dim=2),
            torch.cat([recv[i][:, :, hk:] for i in owners], dim=2))


def decode_step(params, cfg: ModelConfig, x, cache_k, cache_v, pos: int, *,
                window: int = 0, tp=None, cut=None, length=None):
    """One-token decode.  x:(B,1,D); cache:(B,Smax,Kh,D); pos: the slot the
    new token occupies (all sequences aligned).  Writes the new k, v into
    the cache in place (the reference returns updated copies; in place
    spares copying the whole cache every step) and returns (out,
    (cache_k, cache_v)).  Past the cache's end the write lands in the last
    slot, as the reference's ``dynamic_update_slice`` clamps it, while the
    rope position and the mask keep the true ``pos``.

    With ``cut`` (a ``tp.SeqCut``) the cache is this member's block of
    the ``length`` positions (every KV head): the slot and the masks are
    global positions, only the slot's owner writes, and the members'
    parts are joined (:func:`_sdpa_cut`)."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, tp)
    if cut is None:
        slot = min(pos, cache_k.shape[1] - 1)
        cache_k[:, slot] = k[:, 0]
        cache_v[:, slot] = v[:, 0]
        m = causal_mask(1, cache_k.shape[1], window, offset=pos,
                        device=x.device)
        out = _sdpa(cfg, q, cache_k, cache_v, m)
        return TP.reduce_from(L.dense(params["wo"], out), head_group(tp)), \
            (cache_k, cache_v)
    q, k, v = _all_heads(cfg, q, k, v, tp)
    size = cache_k.shape[1]
    lo = cut.m * size
    slot = min(pos, length - 1) - lo
    if 0 <= slot < size:
        cache_k[:, slot] = k[:, 0]
        cache_v[:, slot] = v[:, 0]
    kj = torch.arange(lo, lo + size, device=x.device)
    live = kj <= pos
    if window:
        live &= (pos - kj) < window
    out = _sdpa_cut(cfg, q, cache_k, cache_v, live, kj < length, cut.group)
    if tp is not None and tp.heads:
        w = out.shape[-1] // tp.n
        out = out[..., tp.m * w:(tp.m + 1) * w]
    return TP.reduce_from(L.dense(params["wo"], out), head_group(tp)), \
        (cache_k, cache_v)
