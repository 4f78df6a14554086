"""The port's multihost utilities (``repro_torch/launch/multihost.py``):
twins of ``tests/test_multihost.py``'s three one-process tests, and 4
processes on gloo (``tests/_torch_multihost_worker.py``, one run for the
module) for ``bringup``, ``host_batch_slice``, ``form_global_array`` and
``RestartBarrier.agree_on_step``."""
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_multihost_worker as W
from _torch_dist_worker import run_members
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.multihost import (RestartBarrier, bringup,
                                          form_global_array,
                                          host_batch_slice)

WORLD = 4
LATEST = np.array([5, 7, 3, 9])
ROWS = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)


def test_bringup_single_host():
    info = bringup(device="cpu")
    assert info["process_index"] == 0
    assert info["process_count"] == 1
    assert info["local_devices"] == 1


def test_host_batch_slice():
    assert host_batch_slice(64) == (0, 64)
    # logic check for the multi-host formula (pure arithmetic)
    per = 256 // 8
    assert [(i * per, (i + 1) * per) for i in range(8)][3] == (96, 128)


def test_form_global_array_roundtrip():
    mesh = make_host_mesh()
    local = np.arange(16.0).reshape(8, 2)
    arr = form_global_array(local, mesh, ("data", None), device="cpu")
    assert arr.shape == (8, 2)
    assert arr.device.type == "cpu"
    assert np.allclose(arr.numpy(), local)
    assert host_batch_slice(8, mesh) == (0, 8)
    checked = form_global_array(local, mesh, ("data", None), global_batch=8,
                                device="cpu")
    assert torch.equal(checked, arr)
    with pytest.raises(ValueError):
        form_global_array(local, mesh, ("data", None), global_batch=16,
                          device="cpu")


def test_agree_on_step_single_process():
    mesh = make_host_mesh()
    assert RestartBarrier().agree_on_step(7, mesh) == 7
    with pytest.raises(FileNotFoundError):
        RestartBarrier().agree_on_step(None, mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    d = tmp_path_factory.mktemp("multihost")
    return run_members(Path(W.__file__), WORLD,
                       {"port": np.asarray(port), "latest": LATEST,
                        "rows": ROWS}, d, timeout=120.0)


@pytest.mark.parametrize("rank", range(WORLD))
def test_bringup_joins_gloo(runs, rank):
    out = runs[rank]
    assert int(out["process_index"]) == rank
    assert int(out["process_count"]) == WORLD
    assert int(out["global_devices"]) == WORLD
    assert int(out["local_devices"]) == 1


@pytest.mark.parametrize("rank", range(WORLD))
def test_host_batch_slice_at_each_rank(runs, rank):
    per = ROWS.shape[0] // WORLD
    assert runs[rank]["slice"].tolist() == [rank * per, (rank + 1) * per]
    np.testing.assert_array_equal(runs[rank]["block"],
                                  ROWS[rank * per:(rank + 1) * per])
    # on the (2, 2) mesh the members of a data row (row-major: ranks 2d
    # and 2d + 1) load that row's half of the batch
    d, half = rank // 2, ROWS.shape[0] // 2
    assert int(runs[rank]["data_index"]) == d
    assert runs[rank]["slice22"].tolist() == [d * half, (d + 1) * half]
    np.testing.assert_array_equal(runs[rank]["block22"],
                                  ROWS[d * half:(d + 1) * half])
    # rows by process index there are not the member's block
    assert bool(runs[rank]["mismatch_raised"])


@pytest.mark.parametrize("rank", range(WORLD))
def test_agree_on_step_is_the_minimum(runs, rank):
    assert int(runs[rank]["agreed"]) == LATEST.min()
    # one process without a committed step: every process raises
    assert bool(runs[rank]["raised"])
