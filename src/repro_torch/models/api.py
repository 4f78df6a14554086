"""Uniform model facade (the port of ``repro/models/api.py``): one entry
point per family for init / forward / cache / decode.  The port runs every
family of the reference: the dense, ``moe`` and ``vlm`` ones (through the
transformer), the ``audio`` one (whisper, encoder-decoder), the ``ssm`` one
(rwkv6) and the ``hybrid`` one (zamba2: Mamba-2 layers and a shared
attention block).

Batch dict convention:
  tokens  (B, S) int            — always present
  labels  (B, S) int            — training (-1 = masked position)
  frames  (B, S, d_frontend)    — audio stub (whisper)
  patches (B, n_front, d_front) — vision stub (llava), optional

Over a mesh (``sharding/partition.py::axis_rules``) the transformer
families (dense, moe, vlm) run tensor- and expert-parallel, rwkv6 (ssm)
and zamba2 (hybrid) tensor-parallel, with no new argument: each member
holds the blocks :func:`param_layout` gives it, from :func:`init` with a
``layout`` or from :func:`shard_params` of a whole tree, and a cache of
its own heads (:func:`make_cache`).  whisper (audio) keeps every leaf
whole: ``launch/specs.py::arch_rules`` sets all its rules to None, so it
runs data-parallel (on a model axis, replicated).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as M
from repro_torch.models import rwkv6, transformer, whisper, zamba2
from repro_torch.sharding import partition
from repro_torch.sharding import tp as TP

# families the port does not run yet, each with its ROADMAP item: none
UNPORTED: dict[str, str] = {}
# the encoder length of an audio decode cache: a small fixed acoustic
# context, as in the reference (whisper caps sources at ~1500 frames)
AUDIO_ENC_LEN = 1536


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg``."""
    if cfg.family in UNPORTED:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family is "
                                  f"not ported yet ({UNPORTED[cfg.family]})")


def init(seed: int, cfg: ModelConfig, device="cuda", n_shards: int = 16,
         dtype=None, layout: Optional[partition.Layout] = None):
    """``n_shards`` pads the MoE family's routed experts, as the
    reference's ``init`` does (over a mesh: the model axis or a multiple
    of it).  Leaves are drawn in f32 and kept in ``cfg.dtype``, or in
    ``dtype`` ("float32": the training masters, the reference's ``init``
    leaves).  With ``layout`` (:func:`param_layout`) each member keeps its
    block of the same draws."""
    check_ported(cfg)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if layout is not None and cfg.moe is not None:
        e_pad = M.padded_experts(cfg.moe, n_shards)
        if e_pad % layout.mesh.shape["model"]:
            raise ValueError(f"{e_pad} padded experts (n_shards {n_shards}) "
                             f"do not split over {layout.mesh.shape['model']}"
                             " members")
    if cfg.family == "ssm":
        p = rwkv6.init_rwkv6(seed, cfg, device)
    elif cfg.family == "hybrid":
        p = zamba2.init_zamba2(seed, cfg, device)
    elif cfg.family == "audio":
        p = whisper.init_whisper(seed, cfg, device)
    else:
        return transformer.init_lm(seed, cfg, device, n_shards,
                                   layout=layout)
    return p if layout is None else partition.shard_tree(p, layout)


def specs(cfg: ModelConfig):
    """The reference's tree of logical axes for :func:`init`'s tree."""
    if cfg.family == "ssm":
        return rwkv6.rwkv6_specs(cfg)
    if cfg.family == "hybrid":
        return zamba2.zamba2_specs(cfg)
    if cfg.family == "audio":
        return whisper.whisper_specs(cfg)
    return transformer.lm_specs(cfg)


def cache_specs(cfg: ModelConfig):
    if cfg.family == "ssm":
        return rwkv6.state_specs(cfg)
    if cfg.family == "hybrid":
        return zamba2.cache_specs(cfg)
    if cfg.family == "audio":
        return whisper.cache_specs(cfg)
    return transformer.cache_specs(cfg)


def batch_spec_axes(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes for each batch entry (see sharding/partition.py)."""
    out = {"tokens": ("batch", "seq")}
    if kind == "train":
        out["labels"] = ("batch", "seq")
    if cfg.family == "audio":
        out["frames"] = ("batch", "seq", None)
    if cfg.frontend == "vision_patches" and kind != "decode":
        out["patches"] = ("batch", None, None)
    return out


# rwkv6's per-layer leaves that the port cuts, and the plan field that
# says whether: the time mix's projections by heads, the channel mix's by
# its hidden width.  ``cm_r`` (("embed", "heads") in the reference) stays
# whole: its output gates the channel mix's reduced output, so a cut one
# would need an all_gather a layer; ``time_decay``, ``decay_B`` and
# ``ln_x`` are "embed" leaves, whole, each member taking its heads'
# columns.
RWKV6_CUT = {"wr": "heads", "wk": "heads", "wv": "heads", "wg": "heads",
             "wo": "heads", "time_faaaa": "heads", "cm_k": "mlp",
             "cm_v": "mlp"}


def _cut(cfg: ModelConfig, tp, path: tuple) -> bool:
    """Whether the port cuts the leaf at ``path`` over the model axis (the
    rules' choice, narrowed by ``tp``: whole heads, even blocks)."""
    if tp is None or cfg.family == "audio":
        return False
    if cfg.family == "ssm" and path[0] == "layers":
        field = RWKV6_CUT.get(path[1])
        return field is not None and getattr(tp, field)
    if path[0] == "mamba":
        return tp.ssm_heads
    if "attn" in path:
        leaf = path[path.index("attn") + 1]
        return {"wq": tp.heads, "wo": tp.heads,
                "wk": tp.kv == "cut", "wv": tp.kv == "cut"}.get(leaf, False)
    if "ffn" in path:
        if cfg.moe is None:
            return tp.mlp
        if "shared" in path:
            return tp.shared_mlp
        return path[-1] in ("gate", "up", "down") and tp.experts
    return {"embed": tp.emb_vocab, "head": tp.vocab}.get(path[0], False)


def _segments(cfg: ModelConfig, path: tuple):
    """The :class:`partition.Segments` entry of a fused Mamba-2 leaf cut by
    heads (``in_proj`` columns z | x | B | C | dt, the conv's channels
    x | B | C: z, x and dt by heads, B and C whole, since every head reads
    them), else None."""
    if path[0] != "mamba" or path[1] not in ("in_proj", "conv_w", "conv_b"):
        return None
    d_inner, nh, _ = M2.dims(cfg)
    n = cfg.ssm.d_state
    if path[1] == "in_proj":
        return partition.Segments("model", (d_inner, d_inner, n, n, nh),
                                  (True, True, False, False, True))
    return partition.Segments("model", (d_inner, n, n), (True, False, False))


def param_layout(cfg: ModelConfig, mesh=None,
                 rules: Optional[dict] = None) -> partition.Layout:
    """Where each parameter lives over ``mesh`` under ``rules`` (default:
    the ambient ones).  The rules resolve every leaf as the reference's
    ``tree_shardings`` does (``partition.tree_layout``); the port keeps
    only the ``model`` axis (parameters are whole on every data member:
    no FSDP) and cuts a leaf only where :func:`sharding.tp.plan` runs it
    cut: whole query heads, KV heads whole or replicated, rwkv6's and
    Mamba-2's heads, even blocks; a part whose heads do not divide keeps
    its leaves whole.  Mamba-2's fused leaves are cut segment by segment
    (:func:`_segments`).  whisper keeps every leaf whole."""
    mesh = mesh if mesh is not None else partition.current_mesh()
    base = partition.tree_layout(specs(cfg), mesh, rules)
    tp = TP.plan(cfg, mesh, rules)

    def narrow(path, spec):
        cut = "model" if _cut(cfg, tp, path) else None
        if cut:
            cut = _segments(cfg, path) or cut
        return tuple(cut if cut and "model" in partition._axes(e) else None
                     for e in spec)

    return partition.Layout(mesh, partition.map_specs(narrow, base.specs))


def shard_params(params, cfg: ModelConfig, mesh=None,
                 rules: Optional[dict] = None):
    """This member's blocks of a whole parameter tree (``init``'s, or the
    reference's through ``params_from_jax``)."""
    return partition.shard_tree(params, param_layout(cfg, mesh, rules))


def forward(params, cfg: ModelConfig, batch: dict, *, remat: bool = True,
            last_only: bool = False, attn_impl: str = "auto",
            wkv_impl: str = "auto"):
    """-> (logits, aux).  ``remat`` applies ``cfg.remat`` to each layer
    (group) when grad is enabled, as the reference's default does.
    ``attn_impl`` reaches the attention of every family but rwkv6,
    ``wkv_impl`` rwkv6's WKV."""
    check_ported(cfg)
    kw = {"remat": remat, "last_only": last_only}
    if cfg.family == "audio":
        return whisper.forward(params, cfg, batch["tokens"], batch["frames"],
                               attn_impl=attn_impl, **kw)
    if cfg.family == "ssm":
        return rwkv6.forward(params, cfg, batch["tokens"], wkv_impl=wkv_impl,
                             **kw)
    if cfg.family == "hybrid":
        return zamba2.forward(params, cfg, batch["tokens"],
                              attn_impl=attn_impl, **kw)
    return transformer.forward(params, cfg, batch["tokens"],
                               batch.get("patches"), attn_impl=attn_impl,
                               **kw)


def loss(cfg: ModelConfig, logits, labels, aux):
    """The training loss of every family: ``transformer.lm_loss``."""
    return transformer.lm_loss(logits, labels, aux)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """The transformer's KV cache, whisper's self- and cross-attention
    caches (zero cross K/V over ``AUDIO_ENC_LEN`` frames), rwkv6's
    recurrent state (constant in ``max_len``), or zamba2's shared-block K/V
    beside its mamba layers' conv and SSD states.  Under the ambient mesh
    the heads are this member's (:func:`sharding.tp.plan`)."""
    check_ported(cfg)
    if cfg.family == "ssm":
        return rwkv6.make_state(cfg, batch, dtype, device)
    if cfg.family == "hybrid":
        return zamba2.make_cache(cfg, batch, max_len, dtype, device)
    if cfg.family == "audio":
        return whisper.make_cache(cfg, batch, max_len, AUDIO_ENC_LEN, dtype,
                                  device)
    return transformer.make_cache(cfg, batch, max_len, dtype, device)


def decode_step(params, cfg: ModelConfig, tokens, cache, *,
                attn_impl: str = "auto"):
    """-> (logits, cache).  ``attn_impl`` changes nothing: decode attention
    is plain for every value (see ``transformer.decode_step``), and rwkv6
    and zamba2's mamba layers decode with their plain recurrences."""
    check_ported(cfg)
    if cfg.family == "ssm":
        return rwkv6.decode_step(params, cfg, tokens, cache)
    if cfg.family == "hybrid":
        return zamba2.decode_step(params, cfg, tokens, cache)
    if cfg.family == "audio":
        return whisper.decode_step(params, cfg, tokens, cache)
    return transformer.decode_step(params, cfg, tokens, cache,
                                   attn_impl=attn_impl)
