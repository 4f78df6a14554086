"""One member of the permuted-mesh checks (gloo).

    python tests/_torch_mesh_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (``leaf``, ``table``, ``tokens`` and the
reshard tree's ``tree/<name>`` leaves), joins a gloo group through
``file://<dir>/store``, builds the sorted mesh ``make_mesh([0, 1], 1, 2)``
and the permuted one ``make_mesh([1, 0], 1, 2)`` (2 members), and writes
``<dir>/out_<rank>.npz``: for each mesh the member's coordinate and group
ranks, whether its whole-grid group is ``WORLD``, the ``shard_leaf`` ->
``gather_leaf`` round trip of ``leaf`` cut on ``model``, and a
vocab-parallel ``layers.embed_tokens`` forward; then the tree moved by
``elastic.reshard`` from the sorted mesh onto the permuted survivors
(``elastic.make_mesh_from``), the member's blocks and the gathered leaves.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

MESHES = {"sorted": [0, 1], "permuted": [1, 0]}
# the reshard tree's specs: a leaf cut on its columns, one on its rows,
# one whole
TREE_SPECS = {"cols": (None, "model"), "rows": ("model", None),
              "whole": (None, None)}


def main(rank, world, d):
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import layers
    from repro_torch.runtime import elastic
    from repro_torch.sharding import partition

    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    mesh_mod.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    out = {}
    try:
        leaf = torch.from_numpy(data["leaf"])
        table = torch.from_numpy(data["table"])
        tokens = torch.from_numpy(data["tokens"])
        meshes = {}
        for name, ranks in MESHES.items():
            m = mesh_mod.make_mesh(ranks, 1, world)
            meshes[name] = m
            out[f"{name}/coord"] = np.array(m.index("model"))
            out[f"{name}/group_rank"] = np.array(
                [dist.get_rank(m.group("model")),
                 dist.get_rank(m.group("all"))])
            out[f"{name}/is_world"] = np.array(
                m.group("all") is dist.group.WORLD)
            spec = (None, "model")
            out[f"{name}/roundtrip"] = partition.gather_leaf(
                partition.shard_leaf(leaf, spec, m), spec, m).numpy()
            rows = partition.shard_leaf(table, ("model", None), m)
            out[f"{name}/embed"] = layers.embed_tokens(
                {"table": rows}, tokens, group=m.group("model")).numpy()

        tree = {k: torch.from_numpy(data[f"tree/{k}"]) for k in TREE_SPECS}
        old = partition.Layout(meshes["sorted"], dict(TREE_SPECS))
        survivors = elastic.make_mesh_from(MESHES["permuted"], world)
        new = partition.Layout(survivors, dict(TREE_SPECS))
        moved = elastic.reshard(partition.shard_tree(tree, old), old, new)
        for k, x in moved.items():
            out[f"reshard/block/{k}"] = x.numpy()
            out[f"reshard/want/{k}"] = partition.shard_leaf(
                tree[k], TREE_SPECS[k], survivors).numpy()
        for k, x in partition.gather_tree(moved, new).items():
            out[f"reshard/gathered/{k}"] = x.numpy()
    finally:
        mesh_mod.destroy_model_group()
    np.savez(d / f"out_{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
