"""Quickstart: the BLS pipeline in 60 seconds (the port of
``examples/quickstart.py``).

1. Build a bounded-lag pipeline over a stream of micro-batches and verify the
   bound never changes values (paper §III-C).
2. Reproduce the paper's headline experiment in the schedule simulator.
3. Run a smoke-scale DLRM CTR inference through the forward the BLS step
   wraps.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``--device`` defaults to the card; ``--device cpu`` runs the plain PyTorch
versions of the kernels.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.core.bls import Issued, bls_pipeline, reference_loop
from repro_torch.core.schedule_sim import make_workload, simulate
from repro_torch.data import synthetic as S
from repro_torch.device import resolve_device
from repro_torch.models import dlrm as D


def main(argv=None, params=None):
    """``params`` replaces the DLRM's random parameters (a test hands in
    the reference's, converted by ``dlrm.params_from_jax``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1 ── the transform ────────────────────────────────────────────────────
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = list(torch.randn((8, 16, 32), generator=gen, device=dev))
    # paper: apply_emb (+ bottom), the BLS alltoallv, interaction + top
    stage_a = lambda x: (x * 2.0, x.sum(-1))
    collective = lambda p: Issued(torch.roll(p, 1, dims=0))
    stage_b = lambda recv, side: recv.sum(-1) + side

    ref = torch.stack(reference_loop(stage_a, collective, stage_b, xs))
    for bound in (0, 1, 4):
        out, stats = bls_pipeline(stage_a, collective, stage_b, xs, bound)
        assert torch.allclose(torch.stack(out), ref, atol=1e-6)
        print(f"bound={bound}: identical outputs, ring={stats.ring_bytes}B "
              f"({stats.bound} slots)")

    # 2 ── the paper's claim ────────────────────────────────────────────────
    w = make_workload(8, 300, delay_max=0.01, seed=0)  # U[0,10ms] delays
    for k in (0, 4):
        r = simulate(w, k)
        print(f"random delays, bound={k}: latency {r.mean_latency*1e3:.2f} "
              f"ms, throughput {r.throughput:.0f} batches/s, max lag "
              f"{r.max_lag}")

    # 3 ── DLRM through the forward the BLS step wraps ──────────────────────
    cfg = cb.get_arch("dlrm-kaggle").smoke()
    if params is None:
        params = D.init_dlrm(1, cfg, n_shards=1, device=dev)
    batch = S.make_batch(cfg, 64, mode="hetero", seed=2)
    with torch.no_grad():
        ctr = torch.sigmoid(D.forward_local(
            params, cfg, *(torch.from_numpy(a).to(dev)
                           for a in (batch.dense, batch.idx, batch.mask))))
    print(f"DLRM CTR head: {np.asarray(ctr[:4].cpu())}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
