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
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6, transformer, whisper, zamba2

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
         dtype=None):
    """``n_shards`` pads the MoE family's routed experts, as the
    reference's ``init`` does.  Leaves are drawn in f32 and kept in
    ``cfg.dtype``, or in ``dtype`` ("float32": the training masters, the
    reference's ``init`` leaves)."""
    check_ported(cfg)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if cfg.family == "ssm":
        return rwkv6.init_rwkv6(seed, cfg, device)
    if cfg.family == "hybrid":
        return zamba2.init_zamba2(seed, cfg, device)
    if cfg.family == "audio":
        return whisper.init_whisper(seed, cfg, device)
    return transformer.init_lm(seed, cfg, device, n_shards)


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
    beside its mamba layers' conv and SSD states."""
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
