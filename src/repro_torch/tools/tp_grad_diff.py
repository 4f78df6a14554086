#!/usr/bin/env python3
"""Per-leaf gradient distances of a tensor-parallel mesh from one device,
beside one device's own distance when only the kernel changes.

Run from the repository root:

    python3 src/repro_torch/tools/tp_grad_diff.py --arch rwkv6-1.6b \\
        [--layers 8] [--dtype bfloat16] [--members 2] [--device cpu --smoke]

It starts ``--members`` processes on one card (or the CPU) over gloo.  Each
draws ``--arch`` at full width (``--smoke``: the arch's smoke config) and
``--layers`` layers, f32 masters computing in ``--dtype``, and takes the
gradient of ``api.loss`` over the first of ``launch/train.py``'s seeded
batches (2 x 4096 tokens, 2 microbatches, as ``chip_smoke.py``'s
``[members-train]``):

- on a (1, members) mesh under ``launch/specs.py::arch_rules``, each leaf
  gathered back to its full shape (``partition.gather_tree``);
- on one device (member 0 alone).

Each is taken twice: with the kernels (``impl`` "auto") and with their
plain versions (``impl`` "interpret": rwkv6's chunked WKV, the plain
attention).  Member 0 prints one ``[tp-grad]`` line a leaf: the relative
Frobenius distance of the tensor-parallel gradient from one device's with
the kernels (``tp``), of one device's plain gradient from its kernel one
(``plain``), and of the tensor-parallel plain gradient from one device's
plain one (``tp_plain``); then the global norms.  A leaf whose ``tp``
distance is far above its ``plain`` one takes a gradient the members do
not share out right; one whose distances are alike moves as far under a
rounding change on one device.  Exits non-zero if a member fails.
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
SEQ, BATCH, ACCUM, SEED = 4096, 2, 2, 0
IMPLS = ("auto", "interpret")


def grads(params, cfg, batch, impl):
    """The mean loss's gradient over ACCUM microbatches, a list of leaves
    in ``optimizer.leaves`` order, and the loss."""
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt

    flat = opt.leaves(params)
    for p in flat:
        p.grad = None
        p.requires_grad_(True)
    mb = batch["tokens"].shape[0] // ACCUM
    loss = 0.0
    kw = {"attn_impl": impl} if cfg.family != "ssm" else {"wkv_impl": impl}
    for i in range(ACCUM):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        logits, aux = api.forward(params, cfg, part, remat=True, **kw)
        micro = api.loss(cfg, logits, part["labels"], aux) / ACCUM
        micro.backward()
        loss += float(micro.detach())
    out = [p.grad for p in flat]
    for p in flat:
        p.requires_grad_(False)
        p.grad = None
    return out, loss


def member(rank, world, port, args) -> int:
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs
    from repro_torch.launch import train as train_mod
    from repro_torch.models import api
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer as opt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        not args.full_precision_reduction
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    arch = get_arch(args.arch)
    cfg = arch.smoke() if args.smoke else arch.config
    cfg = cfg.replace(n_layers=args.layers or cfg.n_layers,
                      dtype=args.dtype or cfg.dtype)
    seq = args.seq or SEQ
    batch = {k: v.to(dev) for k, v in next(train_mod.synthetic_batches(
        cfg, BATCH, seq, 1, SEED)).items()}
    mesh = mesh_mod.make_host_mesh(model=world)
    rules = specs.arch_rules(cfg, mesh, ShapeConfig("train", "train", seq,
                                                    BATCH))
    res, loss = {}, {}
    try:
        for impl in IMPLS:
            with partition.axis_rules(mesh, rules):
                layout = api.param_layout(cfg)
                params = api.init(SEED, cfg, dev, dtype="float32",
                                  layout=layout)
                names = _paths(params)
                t0 = time.perf_counter()
                g, loss[("tp", impl)] = grads(params, cfg, batch, impl)
                tree = partition.gather_tree(
                    _unflatten(params, g), layout)
                res[("tp", impl)] = opt.leaves(tree)
                print(f"[tp-grad] rank {rank} tp {impl} "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
            del params, g, tree
        if rank == 0:
            runs = [("one", impl, cfg) for impl in IMPLS]
            if cfg.dtype != "float32":
                runs.append(("f32", "auto", cfg.replace(dtype="float32")))
            for where, impl, c in runs:
                params = api.init(SEED, c, dev, dtype="float32")
                res[(where, impl)], loss[(where, impl)] = grads(
                    params, c, batch, impl)
                del params
            report(cfg, names, res, loss)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _paths(tree, pre=""):
    """Each leaf's path, in ``optimizer.leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                         f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _paths(t,
                                                              f"{pre}/{i}")]
    return [pre[1:]]


def _unflatten(params, flat):
    """``flat`` (leaves in ``optimizer.leaves`` order) in ``params``'
    tree."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        return next(it)

    return walk(params)


def _dist(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) /
                 max(float(torch.linalg.vector_norm(b)), 1e-30))


def report(cfg, names, res, loss):
    def gnorm(gs):
        return float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in gs)))

    rows = []
    f32 = res.get(("f32", "auto"))
    for i, name in enumerate(names):
        one = res[("one", "auto")][i]
        rows.append({
            "f32": "" if f32 is None else
            f" one_f32 {_dist(one, f32[i]):.3e} tp_f32 "
            f"{_dist(res[('tp', 'auto')][i], f32[i]):.3e}",
            "leaf": name, "shape": list(one.shape),
            "norm": float(torch.linalg.vector_norm(one.double())),
            "tp": _dist(res[("tp", "auto")][i], one),
            "plain": _dist(res[("one", "interpret")][i], one),
            "tp_plain": _dist(res[("tp", "interpret")][i],
                              res[("one", "interpret")][i])})
    for r in sorted(rows, key=lambda r: -r["norm"]):
        print(f"[tp-grad] {cfg.name} {cfg.dtype} {r['leaf']} "
              f"{tuple(r['shape'])}: norm {r['norm']:.6e} tp {r['tp']:.3e} "
              f"plain {r['plain']:.3e} tp_plain {r['tp_plain']:.3e}"
              f"{r['f32']}",
              flush=True)
    summary = {f"{w}/{i}": {"grad_norm": gnorm(g), "loss": loss[(w, i)]}
               for (w, i), g in res.items()}
    print(f"[tp-grad] {cfg.name} {cfg.dtype} {cfg.n_layers} layers: "
          f"{json.dumps(summary)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--members", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--full-precision-reduction", action="store_true",
                    help="forbid cuBLAS's reduced-precision (bf16) split-K "
                    "reductions in bf16 GEMMs")
    ap.add_argument("--member", nargs=2, type=int, metavar=("RANK", "PORT"))
    args = ap.parse_args()
    if args.member:
        return member(args.member[0], args.members, args.member[1], args)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, *sys.argv[1:],
                               "--member", str(r), str(port)])
             for r in range(args.members)]
    rcs = [p.wait() for p in procs]
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
