#!/usr/bin/env python3
"""A member's dry-run record of ``train_4k`` cells with the train rules'
``res_seq`` and with it overridden to None, side by side: what cutting
the residual stream by sequence does to a member's temporaries and
collective bytes on the (16, 16) production mesh.

Run from the repository root (this sandbox's CPU; fake tensors over a
fake group of 256, as ``launch/dryrun.py``):

    PYTHONPATH=src python3 src/repro_torch/tools/seq_dryrun.py \\
        chatglm3-6b qwen2-moe-a2.7b [--out build/dryrun/seq.json]

One ``[seq-dry]`` line a cell and rule: argument, temporary and
collective bytes and flops.  The fake backend counts a reduce-scatter
that the port issues as an all-reduce and a narrow (``fsdp.
_reduce_scatter`` off NCCL) at the whole tensor's bytes, so collective
bytes read high.
"""
import argparse
import json
import os

from repro_torch.launch import dryrun


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="+")
    ap.add_argument("--out", default=os.path.join("build", "dryrun",
                                                  "seq.json"))
    args = ap.parse_args()
    out = {}
    with dryrun.production_mesh(False) as mesh:
        for arch in args.archs:
            for tag, over in (("res_seq", None), ("whole",
                                                  {"res_seq": None})):
                r = dryrun.run_cell(arch, "train_4k", mesh, False,
                                    rules_overrides=over)
                m = r["memory"]
                out[f"{arch}/{tag}"] = r
                print(f"[seq-dry] {arch} train_4k {tag}: args "
                      f"{m['argument_size_in_bytes']} temp "
                      f"{m['temp_size_in_bytes']} collective "
                      f"{r['collective_bytes']} flops {r['flops']}",
                      flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
