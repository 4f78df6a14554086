"""FSDP over the ``data`` axis (``sharding/fsdp.py``, ``api.param_layout``
under the train rules, ``train/steps.py``) on the CPU.

On a (2, 1) and a (2, 2) mesh of gloo members (``_torch_fsdp_worker.py``,
both runs started together beside the in-process tests) the dense, MoE
and audio smoke configs take one train step on their rows of a seeded
batch: the loss and grad_norm equal the port's one-device step on the
whole batch, accumulated over the data members' rows, within STEP_TOL
(the members tests' tolerance); every
member's blocks of the parameters and of AdamW's first moment (the
clipped gradient times 1 - b1) equal ``shard_leaf`` of the one device's
full leaves (the moment within MOMENT_TOL; a parameter moves by at most
lr = 3e-6 in the first step, so within 1e-5); the leaves cut over
``data`` are exactly those whose reference axes name "embed"; and the
state saved as full leaves restores onto the mesh as the same blocks and
reads back, full, as the one device's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_fsdp_worker as W
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs as tspecs
from repro_torch.models import api as tapi
from repro_torch.runtime import checkpoint as tC
from repro_torch.sharding import partition as tpart
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps

WORKER = Path(__file__).with_name("_torch_fsdp_worker.py")
WORLDS = {"2x1": 2, "2x2": 4}
STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}
MOMENT_TOL = {"rtol": 1e-4, "atol": 1e-8}
PARAM_TOL = {"rtol": 0.0, "atol": 1e-5}


def _batch(case, rng):
    cfg = W.config(case)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (W.BATCH, W.SEQ),
                                dtype=np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (W.BATCH, W.SEQ),
                                dtype=np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (W.BATCH, 4 * W.SEQ, cfg.d_frontend)).astype(np.float32)
    return b


def _inputs():
    rng = np.random.default_rng(0)
    return {f"{case}/{k}": v for case in W.CASES
            for k, v in _batch(case, rng).items()}


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(src), str(WORKER.parent)]), OMP_NUM_THREADS="1")
    runs = {}
    for name, world in WORLDS.items():
        d = tmp_path_factory.mktemp(f"fsdp{name}")
        np.savez(d / "inputs.npz", **_inputs())
        runs[name] = (d, [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(d)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)])
    try:
        yield runs
    finally:
        for _, procs in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def runs(started):
    out = {}
    for name, (d, procs) in started.items():
        for p in procs:
            log = p.communicate(timeout=300)[0]
            assert p.returncode == 0, log
        out[name] = (d, [dict(np.load(d / f"out_{r}.npz"))
                         for r in range(len(procs))])
    return out


_ONE: dict = {}


def _one_device(case):
    """The port's one-device step on the whole batch, accumulated over the
    two data members' rows as two microbatches (the MoE balance loss and
    capacity are each member's own, as in the members tests) -> (metrics,
    params, AdamW's m), each leaf by its checkpoint key."""
    if case not in _ONE:
        cfg = W.config(case)
        inputs = _inputs()
        batch = {k[len(case) + 1:]: torch.from_numpy(v)
                 for k, v in inputs.items() if k.startswith(case + "/")}
        params = tapi.init(0, cfg, "cpu", dtype="float32")
        state = topt.adamw_init(params)
        params, state, m = tsteps.make_train_step(cfg, accum_steps=2)(
            params, state, batch)
        _ONE[case] = (m, tC._flatten(params), tC._flatten(state["m"]))
    return _ONE[case]


class _Member:
    """What ``shard_leaf`` reads of a mesh: shape and a member's index."""

    def __init__(self, world, rank):
        self.shape = {"data": 2, "model": world // 2}
        self.axis_names = ("data", "model")
        self._at = {"data": rank // (world // 2),
                    "model": rank % (world // 2)}

    def index(self, axis):
        return self._at[axis]

    def group(self, axis):
        return None


def _layout(case, mesh):
    cfg = W.config(case)
    rules = tspecs.arch_rules(cfg, mesh, ShapeConfig("t", "train", W.SEQ,
                                                     W.BATCH))
    return tC._flatten_specs(tapi.param_layout(cfg, mesh, rules).specs)


@pytest.mark.parametrize("case", list(W.CASES))
@pytest.mark.parametrize("mesh", list(WORLDS))
def test_fsdp_step_matches_one_device(runs, mesh, case):
    _, outs = runs[mesh]
    m, params, moment = _one_device(case)
    world = WORLDS[mesh]
    for rank, o in enumerate(outs):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(o[f"{case}/{k}"], m[k].numpy(),
                                       err_msg=k, **STEP_TOL)
        specs = _layout(case, _Member(world, rank))
        for key, spec in specs.items():
            member = _Member(world, rank)
            np.testing.assert_allclose(
                o[f"{case}/params/{key}"],
                tpart.shard_leaf(params[key], spec, member).numpy(),
                err_msg=key, **PARAM_TOL)
            np.testing.assert_allclose(
                o[f"{case}/m/{key}"],
                tpart.shard_leaf(moment[key], spec, member).numpy(),
                err_msg=key, **MOMENT_TOL)


@pytest.mark.parametrize("case", list(W.CASES))
def test_data_cut_leaves_are_the_embed_ones(runs, case):
    """Every leaf whose reference axes name "embed" is cut over data (the
    smoke widths divide 2), and no other."""
    _, outs = runs["2x1"]
    want = []
    tpart.map_specs(lambda path, s: want.append("/".join(path))
                    if "embed" in s else None, tapi.specs(W.config(case)))
    assert want
    for o in outs:
        assert sorted(o[f"{case}/data_cut"]) == sorted(want)


@pytest.mark.parametrize("case", list(W.CASES))
@pytest.mark.parametrize("mesh", list(WORLDS))
def test_checkpoint_round_trips_to_full_leaves(runs, mesh, case):
    d, outs = runs[mesh]
    assert all(bool(o[f"{case}/ckpt_roundtrip"]) for o in outs)
    _, params, moment = _one_device(case)
    with np.load(d / f"ckpt_{case}" / "step_00000000" / "arrays.npz") as z:
        for key, want in params.items():
            np.testing.assert_allclose(z[f"0/{key}"], want.numpy(),
                                       err_msg=key, **PARAM_TOL)
            np.testing.assert_allclose(z[f"1/m/{key}"],
                                       moment[key].numpy(), err_msg=key,
                                       **MOMENT_TOL)
