#!/usr/bin/env python3
"""A/B of the served dense DLRM flush between this checkout and another,
on one GPU.

Run from the repository root:

    python3 src/repro_torch/tools/ab_serve.py --parent DIR [--batches 16]
        [--rounds 1]

``DIR`` holds another checkout's ``chip_smoke.py`` and ``src/`` (for
instance the parent commit, unpacked with ``git archive``).  The two trees
run in turns, each in a process of its own: parent, this one, this one,
parent, repeated ``--rounds`` times.  Each process builds its tree's
kernels, makes full-width ``dlrm-kaggle`` (seed 0, one member), joins a
one-rank NCCL group on a free localhost port, serves one warm-up batch
and then, twice, ``--batches`` batches of 512 hetero requests (seed 0)
through ``DLRMEngine(bound=2, microbatches=4)`` and the same at
``bound=0``, with its own tree's ``chip_smoke.serve``: the traffic and the
path of ``chip_smoke.py``'s phase 5.  One ``[ab-serve]`` line per process gives,
per (repetition, bound), the flush latency p50, p99 and mean in ms (the
engine's monitor: submit of a batch's last request to its CTRs on the
host).  Needs a CUDA device; without one it exits 2.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

CHILD = r'''
import json, socket, sys
root, tag, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path[:0] = [root, root + "/src"]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.configs.dlrm_kaggle import CONFIG
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import _build
from repro_torch.launch import mesh
from repro_torch.models.dlrm import init_dlrm

torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
dev = torch.device("cuda")
params = init_dlrm(0, CONFIG, n_shards=1, device=dev)
with socket.socket() as sock:
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
mesh.init_model_group("nccl", 1, 0, f"tcp://localhost:{port}")
out = {"tree": tag}
try:
    with torch.no_grad():
        cs.serve(params, CONFIG, make_batch(CONFIG, 512, mode="hetero",
                                            seed=1), 2, dev)
        batch = make_batch(CONFIG, n * 512, mode="hetero", seed=0)
        for rep in range(2):
            for bound in (2, 0):
                _, eng = cs.serve(params, CONFIG, batch, bound, dev)
                out[f"rep{rep}_bound{bound}"] = [
                    eng.monitor.percentile(0.5) * 1e3,
                    eng.monitor.percentile(0.99) * 1e3,
                    float(np.mean(eng.monitor.lat)) * 1e3]
finally:
    mesh.destroy_model_group()
print("[ab-serve] " + json.dumps(out), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="another checkout (chip_smoke.py and src/)")
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_serve: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[ab-serve] card {card}", flush=True)
    failed = 0
    turns = (("parent", args.parent.resolve()), ("this", ROOT),
             ("this", ROOT), ("parent", args.parent.resolve()))
    for tag, tree in turns * args.rounds:
        r = subprocess.run([sys.executable, "-c", CHILD, str(tree), tag,
                            str(args.batches)], capture_output=True,
                           text=True)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("[ab-serve] ")]
        if r.returncode or not lines:
            failed += 1
            print(f"[ab-serve] {tag} failed (rc {r.returncode}):\n"
                  f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}", flush=True)
        else:
            print(lines[-1], flush=True)
    print(f"[ab-serve] done, card {json.dumps(card)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
