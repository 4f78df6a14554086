"""One member of the port's multi-member MoE runs (gloo).

    python tests/_torch_moe_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (the reference's ``init_moe`` parameters for
the ``ffn`` and ``bls`` configs below, their inputs ``x`` (B, S, D) and
``xs`` (N, T, D)), joins a gloo group through ``file://<dir>/store`` and
writes ``<dir>/out_<rank>.npz``:

- ``gather/cf<f>``: ``moe_gather(group)`` over the whole ``x`` (every
  member holds it), and its aux loss;
- ``a2a/cf<f>``: ``moe_a2a(group)`` over this member's sequence shard
  ``x[:, m·S/P:(m+1)·S/P]``;
- ``loop`` and ``bls/b<k>``: this member's token shard of every microbatch
  of ``xs`` through the a2a stages, unpipelined (``reference_loop``) and
  under ``bls_pipeline`` at bound k;
- ``calls``: the collective calls of one ``moe_gather`` and one
  ``moe_a2a`` forward, counted by wrapping ``torch.distributed``.

Imports only the port (``src`` on PYTHONPATH).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import bls
from repro_torch.launch import mesh
from repro_torch.models import moe as M

# 6 routed experts (padded to 8 at P = 4: two phantoms) and 2 shared ones
FFN_CFG = ModelConfig(name="t", family="moe", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=64,
                      moe=MoEConfig(n_experts=6, experts_per_token=2,
                                    d_expert=16, n_shared_experts=2,
                                    d_shared_expert=8),
                      dtype="float32")
# tests/test_alltoallv_and_moe_bls.py's config
BLS_CFG = ModelConfig(name="t", family="moe", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=64,
                      moe=MoEConfig(n_experts=8, experts_per_token=2,
                                    d_expert=16, capacity_factor=8.0),
                      dtype="float32")
# capacity factors: 1.0 drops slots, 8.0 none
FACTORS = (1.0, 8.0)
BOUNDS = (0, 1, 2)
COUNTED = ("all_to_all_single", "all_reduce")


def params(data, prefix):
    return {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in data.items()
            if k.startswith(prefix + "/")}


def nested(p):
    out = {k: v for k, v in p.items() if "/" not in k}
    for k, v in p.items():
        if "/" in k:
            a, b = k.split("/")
            out.setdefault(a, {})[b] = v
    return out


def count_calls(fn):
    counts = dict.fromkeys(COUNTED, 0)
    orig = {k: getattr(dist, k) for k in COUNTED}

    def counted(name):
        def call(*a, **kw):
            counts[name] += 1
            return orig[name](*a, **kw)
        return call

    for k in COUNTED:
        setattr(dist, k, counted(k))
    try:
        fn()
    finally:
        for k, f in orig.items():
            setattr(dist, k, f)
    return [counts[k] for k in COUNTED]


def bls_runs(p, xs, group, world, rank, out):
    moe = BLS_CFG.moe
    e_pad = p["gate"].shape[0]
    t_loc = xs.shape[1] // world
    c_send, c_exp = M.a2a_capacities(t_loc, moe, world, e_pad)
    experts = M._local_experts(p, rank, e_pad // world)
    mbs = list(xs[:, rank * t_loc:(rank + 1) * t_loc])

    def stage_a(xl):
        return M.a2a_stage_a(p["router"], xl, moe, e_pad, world, c_send)

    def collective(payload):
        return M.a2a_dispatch(payload, group)

    def stage_b(recv, side):
        return M.a2a_stage_b(experts, BLS_CFG.act, recv, side, group, c_exp)

    out["loop"] = torch.stack(
        bls.reference_loop(stage_a, collective, stage_b, mbs)).numpy()
    for k in BOUNDS:
        got, stats = bls.bls_pipeline(stage_a, collective, stage_b, mbs, k)
        assert stats.n_iterations == len(mbs)
        out[f"bls/b{k}"] = torch.stack(got).numpy()


def main(rank, world, d):
    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    group = mesh.init_model_group("gloo", world, rank,
                                  f"file://{d / 'store'}")
    out = {}
    try:
        with torch.no_grad():
            p = nested(params(data, "ffn"))
            x = torch.from_numpy(data["x"])
            s_loc = x.shape[1] // world
            shard = x[:, rank * s_loc:(rank + 1) * s_loc].contiguous()
            for f in FACTORS:
                cfg = FFN_CFG.replace(moe=dataclasses.replace(
                    FFN_CFG.moe, capacity_factor=f))
                y, aux = M.moe_gather(p, cfg, x, group)
                out[f"gather/cf{f}"], out[f"gather_aux/cf{f}"] = \
                    y.numpy(), aux.numpy()
                out[f"a2a/cf{f}"] = M.moe_a2a(p, cfg, shard, group)[0].numpy()
            out["calls"] = np.array(
                [count_calls(lambda: M.moe_gather(p, FFN_CFG, x, group)),
                 count_calls(lambda: M.moe_a2a(p, FFN_CFG, shard, group))])
            bls_runs(params(data, "bls"), torch.from_numpy(data["xs"]),
                     group, world, rank, out)
        np.savez(d / f"out_{rank}.npz", **out)
    finally:
        mesh.destroy_model_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
