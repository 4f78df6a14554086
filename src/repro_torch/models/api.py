"""Uniform model facade (the port of ``repro/models/api.py``): one entry
point per family for init / forward / cache / decode.  The port runs the
dense and ``moe`` families (through the transformer) and the ``ssm`` one
(rwkv6); the others raise ``NotImplementedError`` naming their ROADMAP
item.

Batch dict convention: ``tokens`` (B, S) int, always present.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6, transformer

UNPORTED = {"hybrid": "ROADMAP A14, models/zamba2.py",
            "audio": "ROADMAP A14, models/whisper.py"}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg``."""
    if cfg.family in UNPORTED:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family is "
                                  f"not ported yet ({UNPORTED[cfg.family]})")
    if cfg.family != "ssm":
        transformer.check_ported(cfg)


def init(seed: int, cfg: ModelConfig, device="cuda", n_shards: int = 16):
    """``n_shards`` pads the MoE family's routed experts, as the
    reference's ``init`` does."""
    check_ported(cfg)
    if cfg.family == "ssm":
        return rwkv6.init_rwkv6(seed, cfg, device)
    return transformer.init_lm(seed, cfg, device, n_shards)


def forward(params, cfg: ModelConfig, batch: dict, *,
            last_only: bool = False, attn_impl: str = "auto",
            wkv_impl: str = "auto"):
    """-> (logits, aux).  ``attn_impl`` reaches the dense and MoE
    families' attention, ``wkv_impl`` rwkv6's WKV."""
    check_ported(cfg)
    if cfg.family == "ssm":
        return rwkv6.forward(params, cfg, batch["tokens"],
                             last_only=last_only, wkv_impl=wkv_impl)
    return transformer.forward(params, cfg, batch["tokens"],
                               last_only=last_only, attn_impl=attn_impl)


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """The dense family's KV cache, or rwkv6's recurrent state (constant in
    ``max_len``)."""
    check_ported(cfg)
    if cfg.family == "ssm":
        return rwkv6.make_state(cfg, batch, dtype, device)
    return transformer.make_cache(cfg, batch, max_len, dtype, device)


def decode_step(params, cfg: ModelConfig, tokens, cache, *,
                attn_impl: str = "auto"):
    """-> (logits, cache).  ``attn_impl`` changes nothing: decode attention
    is plain for every value (see ``transformer.decode_step``), and rwkv6
    decodes with the plain recurrence."""
    check_ported(cfg)
    if cfg.family == "ssm":
        return rwkv6.decode_step(params, cfg, tokens, cache)
    return transformer.decode_step(params, cfg, tokens, cache,
                                   attn_impl=attn_impl)
