"""Serving CLI (the port of ``repro/launch/serve.py``): DLRM CTR serving
with the BLS pipeline, or batched greedy LM decoding (dense, MoE or
rwkv6), on one device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-kaggle \
      --smoke --batches 10 --bound 4 --microbatches 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke

``--device`` defaults to the card; ``--device cpu`` runs the plain PyTorch
versions of the kernels.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import base as cb
from repro_torch.data import synthetic as S
from repro_torch.models import api, dlrm as D
from repro_torch.serving.engine import DLRMEngine, LMEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--bound", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = cb.get_arch(args.arch)
    cfg = spec.smoke() if args.smoke else spec.config

    if args.arch.startswith("dlrm"):
        params = D.init_dlrm(0, cfg, n_shards=1, device=args.device)
        eng = DLRMEngine(params, cfg, batch_size=args.batch_size,
                         bound=args.bound, microbatches=args.microbatches,
                         device=args.device)
        for i in range(args.batches):
            b = S.make_batch(cfg, args.batch_size, mode="hetero", seed=3,
                             step=i)
            for j in range(args.batch_size):
                eng.submit(b.dense[j], b.idx[j], b.mask[j])
        eng.flush()
        print(f"served {eng.stats.requests} requests @ "
              f"{eng.stats.throughput_rps:,.0f} req/s "
              f"(bound={args.bound}, mb={args.microbatches})")
        print("monitor:", eng.recommend_bound().reason)
    else:
        params = api.init(0, cfg, device=args.device)
        eng = LMEngine(params, cfg, max_len=64, device=args.device)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 8)).astype(np.int32)
        out = eng.generate(prompts, args.tokens)
        print(f"generated {out.shape}; p50 "
              f"{eng.monitor.percentile(0.5)*1e3:.1f} ms/token")


if __name__ == "__main__":
    main()
