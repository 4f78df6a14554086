"""Fault-tolerance demos (the port of ``examples/failure_recovery.py``).

Part 1 — training: async checkpoints, a node failure mid-run, recovery
onto a shrunk mesh from the last checkpoint — state intact, failed step
retried.  One process.

Part 2 — serving (the paper's scenario): a DLRMEngine on 4 members (4
processes over gloo) under a deterministic ``FaultPlan``.  A transient
delay within bound k's slack leaves the served CTRs BIT-identical (and
``predict_absorption`` says so in advance); a planned crash of member 1
drives the full evict -> regroup -> repartition -> replay loop with zero
requests lost.  Member 0 prints.

Run:  PYTHONPATH=src python -m repro_torch.examples.failure_recovery
      [--members 4] [--device cuda|cpu]
``--device`` defaults to the card (Part 2's members then share it over
gloo with CUDA tensors); ``--device cpu`` runs everything on the CPU.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime import checkpoint as C
from repro_torch.runtime.elastic import ElasticRunner, NodeFailure

# toy "model": quadratic bowl; state = (params, step_count)
TARGET = (3.0, -2.0, 0.5, 1.0)


def train_demo(dev):
    target = torch.tensor(TARGET, device=dev)

    def step_fn(state, batch, mesh):
        params, n = state
        grad = 2 * (params - target) + 0.01 * batch
        return (params - 0.1 * grad, n + 1)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        state = (torch.zeros(4, device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev))
        batches = [torch.tensor(float(i % 3 - 1), device=dev)
                   for i in range(40)]
        killed = {"done": False}

        def fault(step):
            if step == 25 and not killed["done"]:
                killed["done"] = True
                survivors = [0]
                print(f"!! injecting node failure at step {step}: "
                      f"{len(survivors)} devices survive")
                raise NodeFailure(survivors)

        runner = ElasticRunner(make_shardings=lambda mesh: None,
                               ckpt_dir=ckpt_dir)
        state, mesh, recoveries = runner.run(
            state, lambda s: iter(batches[s:]), step_fn, None, fault=fault,
            ckpt_every=10)
        params, n = state
        print(f"finished: {int(n)} steps applied, {recoveries} recovery, "
              f"params={params.cpu().numpy()}")
        assert int(n) == 40, "every step must be (re)applied, none skipped"
        assert torch.allclose(params, target, atol=0.1)
        print(f"last committed checkpoint: step {C.latest_step(ckpt_dir)}")
        print("recovery OK — no step lost, state restored from checkpoint")


def serving_member(rank: int, world: int, store: str, device: str):
    """One member of the serving demo (gloo over ``file://<store>``)."""
    from repro_torch.configs.base import DLRMConfig
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.runtime.elastic import Evicted
    from repro_torch.runtime.faults import (FaultInjector, FaultPlan,
                                            predict_absorption)
    from repro_torch.serving.engine import DLRMEngine

    torch.set_num_threads(1)
    dev = resolve_device(device)
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh_mod.init_model_group("gloo", world, rank, f"file://{store}")
    cfg = DLRMConfig("demo", table_sizes=(40, 60, 30, 50, 20, 70),
                     embed_dim=8, n_dense_features=4, bottom_mlp=(16, 8),
                     top_mlp=(16, 1), sparse_backend="ref")
    P = world
    params = dlrm_mod.init_dlrm(0, cfg, n_shards=P, device=dev)
    B = 48
    t_pad = dlrm_mod.padded_tables(cfg, P)
    batches = [make_batch(cfg, B, t_pad=t_pad, seed=7, step=s)
               for s in range(4)]

    def serve(faults=None, **kw):
        eng = DLRMEngine(params, cfg, batch_size=B, bound=2,
                         microbatches=4, exchange="dense", faults=faults,
                         device=dev, **kw)
        outs = []
        for b in batches:
            for r in range(B):
                o = eng.submit(b.dense[r], b.idx[r], b.mask[r])
                if o is not None:
                    outs.append(o)
        return np.concatenate(outs), eng

    try:
        clean, _ = serve()

        # -- transient: a delay spike within bound k's slack --------------
        plan = FaultPlan.none(P, 8).with_spike(2, 1, 0.002)
        pred = predict_absorption(plan, 2)
        say(f"transient 2ms spike: simulator says bound 2 "
            f"{'absorbs' if pred.absorbed else 'does NOT absorb'} it "
            f"(blocked {pred.blocked_s * 1e3:.1f} ms)")
        faulted, eng = serve(faults=FaultInjector(plan), deadline_s=30.0)
        assert (faulted == clean).all(), "transient within k must be bit-exact"
        say(f"transient under bound 2: {len(faulted)} CTRs BIT-identical "
            f"({eng.faults.injected_delay_s * 1e3:.0f} ms injected)")

        # -- crash: evict -> regroup -> repartition -> replay -------------
        if P < 2:
            say("(single device: skipping the crash demo)")
            return
        plan = FaultPlan.none(P, 8).with_crash(1, at_step=2)
        try:
            out, eng = serve(faults=FaultInjector(plan), deadline_s=30.0,
                             on_deadline="evict", retry_backoff_s=0.001)
        except Evicted:
            return                      # the crashed member serves no more
        st = eng.stats
        assert out.shape[0] == 4 * B, "zero lost requests"
        assert st.evictions == 1 and st.replays == 1
        with torch.no_grad():
            ref = np.concatenate([
                torch.sigmoid(dlrm_mod.forward_local(
                    params, cfg, *(torch.from_numpy(np.asarray(a)).to(dev)
                                   for a in (b.dense, b.idx, b.mask))))
                .cpu().numpy() for b in batches])
        err = float(np.abs(out - ref).max())
        say(f"crash at flush 2: served {out.shape[0]}/{4 * B} requests, "
            f"{st.evictions} eviction, {st.replays} replay, recovery "
            f"{st.recovery_s * 1e3:.0f} ms, max |err| vs local oracle "
            f"{err:.2e}")
        assert err < 2e-5
        say("serving recovery OK — crashed member evicted, batch replayed, "
            "nothing lost")
    finally:
        mesh_mod.destroy_model_group()


def serving_demo(members: int, device: str):
    """Start ``members`` processes of :func:`serving_member` and print
    member 0's lines; a member that fails fails the demo."""
    with tempfile.TemporaryDirectory() as d:
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.examples.failure_recovery",
             "--member", str(r), "--members", str(members), "--store",
             os.path.join(d, "store"), "--device", device], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(members)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode:
                raise RuntimeError(f"member {r} failed:\n{log}")
        print(logs[0], end="")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--member", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.member is not None:
        serving_member(args.member, args.members, args.store, args.device)
        return
    train_demo(resolve_device(args.device))
    print()
    serving_demo(args.members, args.device)


if __name__ == "__main__":
    main()
