"""Multi-pod dry run (the port of ``repro/launch/dryrun.py``): prove the
distribution config is coherent without hardware.  For every (architecture
× input shape) cell this builds the step and traces it as rank 0 of the
production meshes:

    single pod : (data=16, model=16)          = 256 members
    multi pod  : (pod=2, data=16, model=16)   = 512 members

and records each cell's memory, flops and collectives into
``build/dryrun/dryrun_<mesh>.json``.

How it runs without hardware.  The reference compiles against 512
placeholder XLA devices; the port has one process a member, so it joins a
fake process group of 256 or 512 ranks as rank 0 (``torch``'s ``fake``
backend: every collective returns at once), builds the mesh over it, and
traces the cell with ``Cell.trace`` on fake tensors (``FakeTensorMode``):
shapes and types, no storage.  Nothing is allocated anywhere, and no card
is needed or used.  The fake tensors live on the CPU, so every op takes
its plain PyTorch version: the CUDA kernels are ``ctypes`` calls on device
pointers and cannot take a fake tensor.  Flops and temporaries are
therefore the plain path's (the plain attention materialises its scores).

A record keeps the reference's keys where they mean the same thing:
``memory.argument_size_in_bytes`` (this member's arguments, exact, from
the layouts), ``output_size_in_bytes`` (the outputs') and
``alias_size_in_bytes`` (outputs that are arguments updated in place),
``cache_size_in_bytes`` (of the arguments, the cache or recurrent state a
decode cell's member holds: its block under ``api.cache_layout``; 0
elsewhere),
``temp_size_in_bytes`` (``MemTracker``'s peak less the arguments, on
the plain path: ``temp_basis`` says so), ``flops``
(``FlopCounterMode``'s count for this member), ``collective_bytes`` and
``per_collective`` (the bytes each member puts into the ``c10d``
collectives, counted by a dispatch mode), and ``trace_s`` in place of
``lower_s`` and ``compile_s``.  ``replicated_param_bytes`` counts the bytes
of the parameter leaves the port holds whole, or less cut, where the
reference's rules would cut them (``replicated_leaves`` names them).  The
reference's ``hlo_*``, ``xla_cost_analysis`` and ``roofline`` come from
``benchmarks/hlo_analysis.py``, which is not ported.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod | --both] [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import base as cb
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell, cells_for, nbytes

# the arguments of a c10d op that carry what a member sends
_SENT = ("tensors", "input_tensors", "input_tensor", "input")
_RECEIVE_ONLY = ("recv_", "recv_any_source_")


def fake_world(world_size: int):
    """Join a fake process group of ``world_size`` ranks as rank 0.  The
    backend comes from ``torch.testing``, an internal module: on a torch
    that lacks it or names it otherwise, this raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


@contextlib.contextmanager
def production_mesh(multi_pod: bool):
    """The production mesh over a fake group of 256 or 512 ranks, as rank
    0; the group is destroyed on exit."""
    fake_world(512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod)
    finally:
        dist.destroy_process_group()


class CollectiveCounter(TorchDispatchMode):
    """Counts the ``c10d`` collectives a step issues: calls and the bytes
    this member sends into each (the tensors it contributes; a receive
    counts nothing, its send counts)."""

    def __init__(self):
        super().__init__()
        self.calls = defaultdict(int)
        self.bytes = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d" and name not in _RECEIVE_ONLY:
            self.calls[name] += 1
            values = dict(zip((a.name for a in func._schema.arguments),
                              args), **kwargs)
            self.bytes[name] += sum(nbytes(values[k]) for k in _SENT
                                    if k in values)
        return func(*args, **kwargs)


def replicated_leaves(cell) -> dict:
    """path -> the bytes by which this member's block of each parameter
    leaf exceeds its block under the reference's rules (leaves the port
    holds whole, or less cut, where the reference cuts them)."""
    out = {}

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (str(i),))
        else:
            extra = nbytes(a) - nbytes(b)
            if extra > 0:
                out["/".join(path)] = extra

    walk(cell.args[0], cell.ref_params, ())
    return out


def run_cell(arch: str, shape_name, mesh, multi_pod: bool,
             rules_overrides=None) -> dict:
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, overrides=rules_overrides)
    flops = FlopCounterMode(display=False)
    coll = CollectiveCounter()
    mem = MemTracker()
    out = cell.trace(mesh, flops, coll, mem)
    t_trace = time.time() - t0
    # the step returns the arguments it updates in place
    aliased = [cell.args[i] for i in cell.in_place]
    n_args = nbytes(cell.args)
    peak = sum(s.get("Total", 0)
               for s in mem.get_tracker_snapshot("peak").values())
    rep = replicated_leaves(cell)
    shape = cell.shape
    return {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
        "status": "ok",
        "trace_s": round(t_trace, 2),
        "memory": {
            "argument_size_in_bytes": n_args,
            "output_size_in_bytes": nbytes(out),
            "alias_size_in_bytes": nbytes(aliased),
            "cache_size_in_bytes": nbytes(cell.args[2])
            if shape.kind == "decode" and len(cell.args) == 3 else 0,
            "temp_size_in_bytes": peak - n_args,
            "temp_basis": "MemTracker peak less the arguments, plain "
                          "PyTorch path",
        },
        "flops": int(flops.get_total_flops()),
        "collective_bytes": int(sum(coll.bytes.values())),
        "per_collective": {k: {"calls": coll.calls[k],
                               "bytes": coll.bytes[k]} for k in coll.calls},
        "replicated_param_bytes": int(sum(rep.values())),
        "replicated_leaves": rep,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    args = ap.parse_args()

    meshes = []
    if args.both or not args.multi_pod:
        meshes.append(False)
    if args.both or args.multi_pod:
        meshes.append(True)

    archs = [args.arch] if args.arch else cb.list_archs()
    os.makedirs(args.out, exist_ok=True)

    for multi_pod in meshes:
        tag = "2x16x16" if multi_pod else "16x16"
        path = os.path.join(args.out, f"dryrun_{tag}.json")
        results = []
        if os.path.exists(path):
            with open(path) as f:
                results = json.load(f)
        done = {(r["arch"], r["shape"]) for r in results
                if r.get("status") == "ok"}
        with production_mesh(multi_pod) as mesh:
            for arch in archs:
                for shape, skip in cells_for(arch):
                    if args.shape and shape.name != args.shape:
                        continue
                    if (arch, shape.name) in done:
                        print(f"[skip-done] {arch}/{shape.name} @ {tag}")
                        continue
                    if skip:
                        rec = {"arch": arch, "shape": shape.name,
                               "mesh": tag, "status": "skipped",
                               "reason": skip}
                        print(f"[skipped]  {arch}/{shape.name} @ {tag}: "
                              f"{skip}")
                    else:
                        print(f"[tracing]  {arch}/{shape.name} @ {tag} ...",
                              flush=True)
                        try:
                            rec = run_cell(arch, shape.name, mesh, multi_pod)
                            m = rec["memory"]
                            print(f"  ok: trace={rec['trace_s']}s "
                                  f"args={m['argument_size_in_bytes']} "
                                  f"temp={m['temp_size_in_bytes']} "
                                  f"flops={rec['flops']:.4g} "
                                  f"collective={rec['collective_bytes']} "
                                  f"replicated="
                                  f"{rec['replicated_param_bytes']}",
                                  flush=True)
                        except Exception as e:  # record and continue
                            rec = {"arch": arch, "shape": shape.name,
                                   "mesh": tag, "status": "error",
                                   "error": f"{type(e).__name__}: {e}",
                                   "trace": traceback.format_exc()[-2000:]}
                            print(f"  ERROR {type(e).__name__}: {e}",
                                  flush=True)
                    results = [r for r in results
                               if not (r["arch"] == arch
                                       and r["shape"] == shape.name)]
                    results.append(rec)
                    with open(path, "w") as f:
                        json.dump(results, f, indent=1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
