"""Training driver (the port of ``repro/launch/train.py``).

Runs the reference's fault-tolerant loop: prefetched synthetic data,
async checkpointing, straggler monitoring, resume from ``--ckpt-dir``.
Parameters are f32 masters from ``api.init`` (the reference's leaves), one
expert shard, and every step accumulates gradients over the config's
``train_accum`` microbatches, as the reference's train cell does
(``launch/specs.py:233``; its driver leaves it at 1, which every smoke
config has).  ``--device`` defaults to the card; ``--device cpu`` runs the
plain PyTorch versions of the kernels.  Under torchrun (a process group
over ``env://``: NCCL on the card, gloo on the CPU) it runs over
``make_host_mesh(model=1)``, pure data parallelism over every rank as the
reference's driver runs over every device: each rank takes its slice of
every batch, gradients are averaged over the data axis, the first rank
logs and writes checkpoints.  The production mesh (``--production-mesh``)
waits for the launch tooling (ROADMAP A14f).

Resuming differs from the reference on purpose.  A checkpoint saved after
step i holds the state after that step's update; the port resumes at step
i + 1 on batch i + 1 of the same seeded stream, so an interrupted run
continues the uninterrupted one.  The reference resumes at step i on the
stream's first batch.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
      --smoke --steps 20 --ckpt-dir build/ckpt --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch qwen3-14b --smoke --steps 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --steps 3 --batch 2 --seq 4096
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import os
import time

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import Prefetcher
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.models import api
from repro_torch.runtime import checkpoint as C
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.sharding import partition
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import steps as steps_mod


def synthetic_batches(cfg: ModelConfig, batch: int, seq: int, n: int,
                      seed: int = 0):
    """``n`` batches of CPU tensors drawn from numpy's ``default_rng(seed)``
    exactly as the reference's ``synthetic_batches``: tokens and next-token
    labels (int32); whisper's frames (f32) with a quarter of the tokens;
    llava's patches ahead of the text, with labels over both."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1),
                            dtype=np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "audio":
            b["frames"] = rng.standard_normal(
                (batch, seq, cfg.d_frontend)).astype(np.float32)
            b["tokens"] = b["tokens"][:, :seq // 4]
            b["labels"] = b["labels"][:, :seq // 4]
        if cfg.frontend == "vision_patches":
            nf = cfg.n_frontend_tokens
            b["patches"] = rng.standard_normal(
                (batch, nf, cfg.d_frontend)).astype(np.float32)
            b["tokens"] = b["tokens"][:, :max(seq - nf, 4)]
            b["labels"] = rng.integers(
                0, cfg.vocab_size, (batch, b["tokens"].shape[1] + nf),
                dtype=np.int32)
        yield {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in b.items()}


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` leaves: the final state, the step it resumed at,
    and each step's (step, loss, grad_norm, lr, seconds)."""
    params: dict
    opt_state: dict
    start: int
    history: list
    monitor: StragglerMonitor


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir=None, ckpt_every: int = 50, device="cuda", seed: int = 0,
          params=None, log=print, mesh=None) -> TrainRun:
    """The reference's training loop for ``steps`` steps (counting the
    ones a checkpoint in ``ckpt_dir`` already holds), ``batch`` sequences
    of ``seq`` tokens a step.  ``params`` (f32 masters) replace
    ``api.init``'s draws, e.g. the reference's parameters converted.
    Saves every ``ckpt_every`` steps and after the last.  With ``mesh``
    (a ``launch/mesh.py::Mesh``) every step runs under its ``arch_rules``
    and checkpoints hold the state's full leaves."""
    dev = resolve_device(device)
    rules = (specs_mod.arch_rules(cfg, mesh, ShapeConfig("train", "train",
                                                         seq, batch))
             if mesh is not None else None)
    with (partition.axis_rules(mesh, rules) if mesh is not None
          else contextlib.nullcontext()):
        layout = None
        if mesh is not None:
            lay = api.param_layout(cfg)
            layout = partition.Layout(mesh, (lay.specs,
                                             opt_mod.adamw_layout(lay).specs))
        if params is None:
            params = api.init(0, cfg, dev, n_shards=1, dtype="float32",
                              layout=None if layout is None else
                              partition.Layout(layout.mesh, layout.specs[0]))
        opt_state = opt_mod.adamw_init(params)
        start = 0
        if ckpt_dir and C.latest_step(ckpt_dir) is not None:
            (params, opt_state), last = C.restore(
                ckpt_dir, (params, opt_state), device=dev, layout=layout)
            start = last + 1
            log(f"resumed from step {last}")
        step_fn = steps_mod.make_train_step(cfg,
                                            accum_steps=cfg.train_accum)
        saver = C.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        monitor = StragglerMonitor()
        stream = synthetic_batches(cfg, batch, seq, steps, seed)
        data = Prefetcher(itertools.islice(stream, start, None), depth=2)
        history = []
        for i, b in enumerate(data, start=start):
            b = {k: v.to(dev) for k, v in b.items()}
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, b)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            monitor.observe(dt)
            loss, gnorm, lr = (float(m[k])
                               for k in ("loss", "grad_norm", "lr"))
            history.append((i, loss, gnorm, lr, dt))
            if i % 5 == 0 or i == steps - 1:
                log(f"step {i:4d} loss {loss:.4f} gnorm {gnorm:.3f} "
                    f"p50 {monitor.percentile(0.5)*1e3:.0f} ms")
            if saver and i and i % ckpt_every == 0:
                saver.save(i, (params, opt_state), layout=layout)
        if saver:
            saver.save(steps - 1, (params, opt_state), layout=layout)
            saver.wait()
        return TrainRun(params, opt_state, start, history, monitor)


def main(argv=None, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires 256 devices)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError("--production-mesh: the (16, 16) "
                                  "production mesh waits for the launch "
                                  "tooling (ROADMAP A14f)")
    spec = cb.get_arch(args.arch)
    cfg = spec.smoke() if args.smoke else spec.config
    mesh, log = None, print
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:   # under torchrun
        rank = int(os.environ["RANK"])
        backend = "nccl" if args.device.startswith("cuda") else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        torch.distributed.init_process_group(backend, init_method="env://")
        mesh = mesh_mod.make_host_mesh(model=1)
        if rank:
            log = lambda *a, **k: None  # noqa: E731
    try:
        train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              device=args.device, params=params, mesh=mesh, log=log)
    finally:
        if mesh is not None:
            mesh_mod.destroy_model_group()
    log("training done")


if __name__ == "__main__":
    main()
