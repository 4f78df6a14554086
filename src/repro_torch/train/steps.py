"""The prefill and serve steps (the inference half of
``repro/train/steps.py``; the port does not train)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = api.forward(params, cfg, batch, last_only=True)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, tokens (B,1), cache) -> (next tokens (B,1) int32, cache):
    greedy, the first index of the largest logit, as ``jnp.argmax``."""
    def serve_step(params, tokens, cache):
        with torch.no_grad():
            logits, cache = api.decode_step(params, cfg, tokens, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    return serve_step
