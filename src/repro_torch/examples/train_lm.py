"""Train a ~100M-parameter LM for a few hundred steps with the full stack
(the port of ``examples/train_lm.py``): AdamW, async checkpointing,
prefetched synthetic data, resume.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
      (defaults are sized for a CPU: --d-model 256 --layers 4; pass
       --d-model 768 --layers 12 for the full ~100M config on the card)
``--device`` defaults to the card.  The reference's int8 error-feedback
gradient compression needs members (ROADMAP A14d).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.runtime import checkpoint as C
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod


def synthetic_lm_batches(vocab, batch, seq, n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
        yield {"tokens": torch.from_numpy(toks[:, :-1].copy()),
               "labels": torch.from_numpy(toks[:, 1:].copy())}


def lm_config(d_model: int, layers: int) -> ModelConfig:
    return ModelConfig(
        name="lm100m", family="dense", n_layers=layers, d_model=d_model,
        n_heads=max(4, d_model // 64), n_kv_heads=max(2, d_model // 128),
        d_ff=4 * d_model, vocab_size=32_000, dtype="float32", remat="none")


def main(argv=None, params=None):
    """``params`` (f32) replace the seeded draws, e.g. the reference's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/repro_lm_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = lm_config(args.d_model, args.layers)
    if params is None:
        params = api.init(0, cfg, dev, n_shards=1, dtype="float32")
    n_params = sum(x.numel() for x in opt_mod.leaves(params))
    print(f"model: {n_params/1e6:.1f}M params")
    opt_state = opt_mod.adamw_init(params)
    start = 0
    if args.resume and C.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start = C.restore(args.ckpt_dir,
                                               (params, opt_state),
                                               device=dev)
        print(f"resumed from step {start}")

    step_fn = steps_mod.make_train_step(cfg, peak_lr=3e-4,
                                        total_steps=args.steps)
    ckpt = C.AsyncCheckpointer(args.ckpt_dir)
    data = Prefetcher(synthetic_lm_batches(cfg.vocab_size, args.batch,
                                           args.seq, args.steps - start),
                      depth=2)
    t0 = time.perf_counter()
    for i, batch in enumerate(data, start=start):
        batch = {k: v.to(dev) for k, v in batch.items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            el = time.perf_counter() - t0
            print(f"step {i:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e} ({el:.1f}s)")
        if i and i % 50 == 0:
            ckpt.save(i, (params, opt_state))
    ckpt.wait()
    print("done; checkpoint in", args.ckpt_dir)


if __name__ == "__main__":
    main()
