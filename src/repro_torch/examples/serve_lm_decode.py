"""Batched LM decoding through the serving engine, across model families
(dense / MoE / RWKV6 / the zamba2 hybrid): prefill + greedy decode with KV
caches or recurrent state, plus per-token latency stats (the port of
``examples/serve_lm_decode.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm_decode \\
          --arch rwkv6-1.6b [--device cpu]
      (uses the reduced smoke config of the chosen arch)

The arch choices are the reference's: every registered arch but the DLRM,
whisper and llava ones.  ``--device`` defaults to the card; ``--device
cpu`` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import base as cb
from repro_torch.models import api
from repro_torch.serving.engine import LMEngine


def arch_choices() -> list[str]:
    return [a for a in cb.list_archs()
            if not a.startswith(("dlrm", "whisper", "llava"))]


def main(argv=None, params=None):
    """``params`` replaces the random parameters (a test hands in the
    reference's); returns the generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=arch_choices())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cb.get_arch(args.arch).smoke()
    if params is None:
        params = api.init(0, cfg, device=args.device, n_shards=1)
    engine = LMEngine(params, cfg, max_len=args.prompt_len + args.tokens,
                      device=args.device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    out = engine.generate(prompts, args.tokens)
    print(f"{args.arch} ({cfg.name}): generated {out.shape} tokens")
    print(out)
    p50 = engine.monitor.percentile(0.5) * 1e3
    p99 = engine.monitor.percentile(0.99) * 1e3
    print(f"per-token latency p50={p50:.1f} ms p99={p99:.1f} ms")
    return out


if __name__ == "__main__":
    main()
