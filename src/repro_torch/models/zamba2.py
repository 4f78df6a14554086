"""Zamba2 hybrid (arXiv:2411.15242), the port of ``repro/models/zamba2.py``:
a stack of Mamba2 blocks with a single SHARED attention+MLP transformer
block invoked every ``shared_attn_every`` mamba layers (parameters reused;
each invocation keeps its own KV cache).

As in the reference, the per-invocation LoRA adapters on the shared block
and the concat-with-embedding input of the released checkpoints are left
out; the shared block consumes the running hidden state.

Parameters keep the reference's layout: every mamba leaf is stacked
``(n_groups, shared_attn_every, ...)``, as its double ``vmap`` init lays
them out, so ``transformer.params_from_jax`` converts them with a plain
copy.  :func:`init_zamba2` draws each leaf in f32 and casts it to
``cfg.dtype``; the apply-time ``cast_params`` (the shared block once a
call, the mamba leaves a group at a time, as the reference casts them) is
then a no-op.  The shared block's prefill attention goes through
``ops.flash_attention_op`` (the CUDA kernel on the card, at head dim 80 for
zamba2-2.7b); its decode attention and every SSD evaluator are plain
PyTorch, as in the reference.

Over a model axis (``sharding/tp.py::plan``) the mamba layers run their
members' heads (``mamba2.block``), the shared block the transformer's
tensor-parallel attention and GLU MLP under the same plan (zamba2-2.7b's
32 query heads over 32 KV heads: the flash kernel runs at the member's
heads), and the embedding and LM head are the transformer's
vocab-parallel ones; the cache holds this member's heads.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.sharding import fsdp
from repro_torch.sharding import tp as TP


def n_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.n_layers} layers do not group by "
                         f"{cfg.shared_attn_every}")
    return cfg.n_layers // cfg.shared_attn_every


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_shared(gen, cfg: ModelConfig, dev):
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.dtype, dev),
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.dtype, dev),
        "attn": A.init_attention(gen, cfg, dev),
        "ffn": L.init_glu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype, dev),
    }


def zamba2_specs(cfg: ModelConfig):
    return {
        "embed": L.embedding_specs(),
        "mamba": L.stack_specs(M2.mamba2_specs(cfg), "layers", None),
        "shared": {
            "ln1": L.rmsnorm_specs(), "ln2": L.rmsnorm_specs(),
            "attn": A.attention_specs(cfg),
            "ffn": L.glu_mlp_specs(),
        },
        "final_norm": L.rmsnorm_specs(),
        "head": L.lm_head_specs(),
    }


def cache_specs(cfg: ModelConfig):
    return {"attn_k": (None, "batch", "kv_seq", "kv_heads", None),
            "attn_v": (None, "batch", "kv_seq", "kv_heads", None),
            "conv": (None, None, "batch", None, "heads"),
            "ssd": (None, None, "batch", "heads", None, None),
            "pos": ()}


def init_zamba2(seed: int, cfg: ModelConfig, device="cuda"):
    """Random parameters in ``cfg.dtype`` from a ``torch.Generator`` seeded
    with ``seed``, on ``device``, with the reference's distributions and
    layout; the mamba layers are drawn one after another into
    ``(n_groups, shared_attn_every, ...)`` leaves."""
    dev = resolve_device(device)
    gen = L.generator(seed, dev)
    g, e = n_groups(cfg), cfg.shared_attn_every
    p = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                   cfg.dtype, dev)}
    mamba = T.stack_draws(lambda: M2.init_mamba2(gen, cfg, dev),
                          cfg.n_layers)
    p["mamba"] = T._map(lambda a: a.view(g, e, *a.shape[1:]), mamba)
    p["shared"] = _init_shared(gen, cfg, dev)
    p["final_norm"] = L.init_rmsnorm(cfg.d_model, cfg.dtype, dev)
    p["head"] = L.init_lm_head(gen, cfg.d_model, cfg.vocab_size, cfg.dtype,
                               dev)
    return p


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------


def _cast(params, cfg: ModelConfig):
    """Everything but the mamba stack, in the compute type."""
    return T.cast_params({k: v for k, v in params.items() if k != "mamba"},
                         L.dtype_of(cfg.dtype))


def _group(params, cfg: ModelConfig, g: int):
    """Group ``g``'s mamba leaves, (shared_attn_every, ...), cast."""
    return T.cast_params(T._map(lambda a: a[g], params["mamba"]),
                         L.dtype_of(cfg.dtype))


def _mlp_group(tp):
    return tp.group if tp is not None and tp.mlp else None


def _shared_full(p, cfg: ModelConfig, x, attn_impl: str, tp=None):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn, kv = A.attend_full(p["attn"], cfg, h, attn_impl=attn_impl, tp=tp)
    x = x + attn
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.glu_mlp(p["ffn"], h, cfg.act, _mlp_group(tp)), kv



def forward(params, cfg: ModelConfig, tokens, *, collect_cache: bool = False,
            remat: bool = True, last_only: bool = False,
            attn_impl: str = "auto"):
    """Returns (logits, aux_loss), and with ``collect_cache`` also
    ``((k, v), {"ssd": ...})``: each shared invocation's k and v stacked on
    a leading group axis, (n_groups, B, S, Kh, hd), and every mamba layer's
    final SSD state, (n_groups, shared_attn_every, B, H, P, N), as the
    reference returns them.  ``last_only`` slices the stream before the LM
    head.  ``attn_impl`` picks the shared block's attention of
    ``kernels/ops.py`` ("auto": the CUDA kernel on the card; "ref": the
    plain version).  ``remat`` runs each group (the shared block and its
    mamba layers, each group's leaves cast inside it) under ``cfg.remat``
    when grad is enabled, as the reference's does."""
    if attn_impl not in ops.IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; have {ops.IMPLS}")
    tp = TP.plan(cfg)
    specs = zamba2_specs(cfg)
    # FSDP: the non-layer leaves (the shared block's too, which every group
    # calls) gathered over data here, each group's mamba leaves at the top
    # of its (remat) body
    pc = fsdp.gathered(_cast(params, cfg), specs)
    x = T.embed_inputs(pc, cfg, tokens, tp=tp)
    shared = pc["shared"]
    cdt = L.dtype_of(cfg.dtype)

    gather = fsdp.gatherer(specs["mamba"], skip=1)

    def group_fn(x, gp):
        gp = gather(T.cast_params(gp, cdt))
        x, kv = _shared_full(shared, cfg, x, attn_impl, tp)
        sts = []
        for lp in T.unbind_groups(gp, cfg.shared_attn_every):
            x, st = M2.block(lp, cfg, x, tp=tp)
            sts.append(st["ssd"])
        return x, kv, sts

    body = T._remat(group_fn, cfg) if remat else group_fn
    ks, vs, ssds = [], [], []
    for gp in T.unbind_groups(params["mamba"], n_groups(cfg)):
        x, (k, v), sts = body(x, gp)
        if collect_cache:
            ssds.extend(sts)
            ks.append(k)
            vs.append(v)
        del k, v, sts
    logits = T.logits_out(pc, cfg, x[:, -1:] if last_only else x, tp)
    aux = logits.new_zeros((), dtype=torch.float32)
    if collect_cache:
        ssd = torch.stack(ssds).view(n_groups(cfg), cfg.shared_attn_every,
                                     *ssds[0].shape)
        return logits, aux, ((torch.stack(ks), torch.stack(vs)),
                             {"ssd": ssd})
    return logits, aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Zero cache {"attn_k", "attn_v": (n_groups, B, max_len, Kh, hd),
    "conv": (n_groups, shared_attn_every, B, k-1, conv_ch) in ``dtype``
    (the config's by default), "ssd": (n_groups, shared_attn_every, B, H,
    P, N) in f32, "pos": 0}; ``pos`` is a host int.  Under the ambient
    mesh Kh, conv_ch and H are this member's."""
    dev = resolve_device(device)
    dt = L.dtype_of(dtype or cfg.dtype)
    g, e = n_groups(cfg), cfg.shared_attn_every
    tp = TP.plan(cfg)
    _, nh, conv_ch, _ = M2.member_dims(cfg, tp)
    kh = tp.kv_n if tp is not None and tp.heads else cfg.n_kv_heads
    kv = (g, batch, max_len, kh, cfg.head_dim)
    return {
        "attn_k": torch.zeros(kv, dtype=dt, device=dev),
        "attn_v": torch.zeros(kv, dtype=dt, device=dev),
        "conv": torch.zeros((g, e, batch, cfg.ssm.d_conv - 1, conv_ch),
                            dtype=dt, device=dev),
        "ssd": torch.zeros((g, e, batch, nh, cfg.ssm.head_dim,
                            cfg.ssm.d_state), dtype=torch.float32,
                           device=dev),
        "pos": 0,
    }


def decode_step(params, cfg: ModelConfig, tokens, cache):
    """One decode step.  tokens: (B,1) int; cache from :func:`make_cache`.
    Returns (logits (B,1,V), cache advanced by one position); the cache's
    tensors are updated in place (each shared invocation's K/V through
    ``attention.decode_step`` on its group's views, each mamba layer's conv
    and SSD state after the layer has read them)."""
    tp = TP.plan(cfg)
    pc = _cast(params, cfg)
    x = T.embed_inputs(pc, cfg, tokens, tp=tp)
    shared = pc["shared"]
    pos = cache["pos"]
    for g in range(n_groups(cfg)):
        gp = _group(params, cfg, g)
        h = L.rmsnorm(shared["ln1"], x, cfg.norm_eps)
        attn, _ = A.decode_step(shared["attn"], cfg, h, cache["attn_k"][g],
                                cache["attn_v"][g], pos, tp=tp)
        x = x + attn
        h = L.rmsnorm(shared["ln2"], x, cfg.norm_eps)
        x = x + L.glu_mlp(shared["ffn"], h, cfg.act, _mlp_group(tp))
        for i in range(cfg.shared_attn_every):
            x, st = M2.block(T._map(lambda a: a[i], gp), cfg, x,
                             state={"conv": cache["conv"][g, i],
                                    "ssd": cache["ssd"][g, i]},
                             chunked=False, tp=tp)
            cache["conv"][g, i] = st["conv"]
            cache["ssd"][g, i] = st["ssd"]
    logits = T.logits_out(pc, cfg, x, tp)
    return logits, dict(cache, pos=pos + 1)
