"""The port's (data, model) mesh over ranks given out of order, on 2 gloo
members (``tests/_torch_mesh_worker.py``, one run for the module).

``make_mesh([1, 0], 1, 2)`` puts rank 1 at model 0 and rank 0 at model 1,
as the reference's ``make_mesh_from`` lays its devices out as given.  Every
group the mesh builds must keep that order (a member's group rank is its
coordinate), or the gathers join the blocks that ``shard_leaf`` cut in the
wrong order.  Each check is held on the permuted mesh against the sorted
one and against the whole leaves, exactly.
"""
from pathlib import Path

import numpy as np
import pytest

import _torch_mesh_worker as W
from _torch_dist_worker import run_members

WORLD = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {
        "leaf": np.arange(8, dtype=np.float32).reshape(2, 4),
        "table": rng.standard_normal((8, 4)).astype(np.float32),
        "tokens": np.array([[0, 3, 4, 7], [5, 1, 6, 2]], dtype=np.int64),
        "tree/cols": rng.standard_normal((3, 4)).astype(np.float32),
        "tree/rows": rng.standard_normal((4, 3)).astype(np.float32),
        "tree/whole": rng.standard_normal((2, 3)).astype(np.float32),
    }
    d = tmp_path_factory.mktemp("mesh")
    return inputs, run_members(Path(W.__file__), WORLD, inputs, d,
                               timeout=120.0)


@pytest.mark.parametrize("mesh", list(W.MESHES))
def test_group_rank_is_the_coordinate(runs, mesh):
    _, outs = runs
    for rank, out in enumerate(outs):
        coord = W.MESHES[mesh].index(rank)
        assert int(out[f"{mesh}/coord"]) == coord
        assert out[f"{mesh}/group_rank"].tolist() == [coord, coord]
        # WORLD serves the identity order only
        assert bool(out[f"{mesh}/is_world"]) == (mesh == "sorted")


def test_round_trip_on_the_permuted_mesh(runs):
    inputs, outs = runs
    for out in outs:
        np.testing.assert_array_equal(out["permuted/roundtrip"],
                                      inputs["leaf"])
        np.testing.assert_array_equal(out["permuted/roundtrip"],
                                      out["sorted/roundtrip"])


def test_vocab_parallel_embed_on_the_permuted_mesh(runs):
    inputs, outs = runs
    want = inputs["table"][inputs["tokens"]]
    for out in outs:
        np.testing.assert_array_equal(out["sorted/embed"], want)
        np.testing.assert_array_equal(out["permuted/embed"],
                                      out["sorted/embed"])


@pytest.mark.parametrize("leaf", list(W.TREE_SPECS))
def test_reshard_onto_permuted_survivors(runs, leaf):
    inputs, outs = runs
    for out in outs:
        np.testing.assert_array_equal(out[f"reshard/block/{leaf}"],
                                      out[f"reshard/want/{leaf}"])
        np.testing.assert_array_equal(out[f"reshard/gathered/{leaf}"],
                                      inputs[f"tree/{leaf}"])


@pytest.mark.parametrize("keeps_order", [True, False])
def test_new_group_asks_for_order_only_out_of_order(monkeypatch, keeps_order):
    # an ascending line is new_group's own (every torch); a permuted one
    # needs sort_ranks=False, and a torch without it refuses the mesh
    # rather than sort its ranks
    from repro_torch.launch import mesh

    calls = []
    monkeypatch.setattr(mesh, "_KEEPS_ORDER", keeps_order)
    monkeypatch.setattr(mesh.dist, "new_group",
                        lambda **kw: calls.append(kw) or object())
    mesh._new_group((0, 2, 3))
    assert calls == [{"ranks": [0, 2, 3]}]
    if keeps_order:
        mesh._new_group((3, 0, 2))
        assert calls[1] == {"ranks": [3, 0, 2], "sort_ranks": False}
    else:
        with pytest.raises(NotImplementedError, match="sort_ranks"):
            mesh._new_group((3, 0, 2))
        assert len(calls) == 1
