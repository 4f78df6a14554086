"""The port's distributed forward and serving engine against the JAX
reference's single-device forward, on the CPU.

Two gloo members run in subprocesses (``_torch_dist_worker.py``) that meet
through a ``file://`` store under ``tmp_path`` — no TCP port, so the file
runs safely beside others.  Logits are held at f32 rtol=1e-5, atol=1e-5
against JAX ``forward_local`` on the same parameters; bounds are held
bit-identical to each other.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import flatten, run_members
from repro.configs import dlrm_kaggle as jkaggle
from repro.data import synthetic as jsyn
from repro.models import dlrm as jdlrm
from repro_torch.configs import dlrm_kaggle as tkaggle
from repro_torch.models import dlrm as tdlrm
from repro_torch.serving.engine import DLRMEngine

TOL = {"rtol": 1e-5, "atol": 1e-5}
CFGS = ("smoke", "smoke_alicpp")
WORLD = 2
BATCH = 16


def _jax_logits(name, n_shards, mode, seed, batch=BATCH):
    cfg = getattr(jkaggle, name)()
    params = jdlrm.init_dlrm(jax.random.PRNGKey(seed), cfg,
                             n_shards=n_shards)
    b = jsyn.make_batch(cfg, batch, mode=mode, seed=seed,
                        t_pad=jdlrm.padded_tables(cfg, n_shards))
    logits = np.asarray(jdlrm.forward_local(params, cfg, b.dense, b.idx,
                                            b.mask))
    return params, b, logits


@pytest.fixture(scope="module")
def two_members(tmp_path_factory):
    """Run both members once for every config; returns (reference logits
    per config, each member's outputs)."""
    d = tmp_path_factory.mktemp("gloo2")
    inputs, want = {"configs": np.array(CFGS)}, {}
    for name in CFGS:
        params, b, want[name] = _jax_logits(name, WORLD, "hetero", 11)
        flatten(name, params, inputs)
        inputs.update({f"{name}/dense": b.dense, f"{name}/idx": b.idx,
                       f"{name}/mask": b.mask})
    outs = run_members(Path(__file__).with_name("_torch_dist_worker.py"),
                       WORLD, inputs, d, timeout=120)
    return want, outs


@pytest.mark.parametrize("name", CFGS)
@pytest.mark.parametrize("bound", [0, 2])
def test_forward_distributed_matches_jax_forward_local(two_members, name,
                                                       bound):
    want, outs = two_members
    for out in outs:
        got = out[f"{name}/logits_b{bound}"]
        assert got.shape == (BATCH,)
        np.testing.assert_allclose(got, want[name], **TOL)


@pytest.mark.parametrize("name", CFGS)
def test_bound_changes_the_schedule_never_the_values(two_members, name):
    _, outs = two_members
    for out in outs:
        np.testing.assert_array_equal(out[f"{name}/logits_b2"],
                                      out[f"{name}/logits_b0"])
    np.testing.assert_array_equal(outs[0][f"{name}/logits_b2"],
                                  outs[1][f"{name}/logits_b2"])


@pytest.mark.parametrize("name", CFGS)
def test_engine_on_two_members_matches_sigmoid_of_jax(two_members, name):
    want, outs = two_members
    for out in outs:
        np.testing.assert_allclose(out[f"{name}/engine_ctr"],
                                   1.0 / (1.0 + np.exp(-want[name])), **TOL)


@pytest.mark.parametrize("name", CFGS)
def test_engine_single_member_matches_sigmoid_of_jax(name):
    params, b, logits = _jax_logits(name, 1, "hetero", 5, batch=40)
    tp = tdlrm.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    cfg = getattr(tkaggle, name)()
    eng = DLRMEngine(tp, cfg, batch_size=16, bound=2, microbatches=4,
                     device="cpu")
    outs = [o for i in range(40)
            if (o := eng.submit(b.dense[i], b.idx[i], b.mask[i])) is not None]
    assert len(outs) == 2
    outs.append(eng.drain())            # a padded partial batch of 8
    assert eng.drain() is None
    ctr = np.concatenate(outs)
    assert ctr.shape == (40,)
    np.testing.assert_allclose(ctr, 1.0 / (1.0 + np.exp(-logits)), **TOL)
    st = eng.stats.to_dict()
    assert (st["batches"], st["requests"]) == (3, 40)
    assert st["throughput_rps"] > 0
    rec = eng.recommend_bound()
    assert 0 <= rec.bound <= 16
    eng.set_bound(0)
    assert eng.bound == 0


def test_engine_refuses_params_on_another_device():
    cfg = tkaggle.smoke()
    params = tdlrm.init_dlrm(0, cfg, n_shards=1, device="cpu")
    params["tables"] = params["tables"].to("meta")
    with pytest.raises(ValueError, match="serves on"):
        DLRMEngine(params, cfg, device="cpu")


def test_one_member_group_in_process(tmp_path):
    """A one-member gloo group runs the whole distributed path (fuse,
    all_to_all, BLS, all_gather): exactly forward_local at one
    microbatch, within f32 tolerance of it over three (the MLPs run at
    another batch size), and bit-identical across bounds."""
    from repro_torch.launch import mesh

    cfg = tkaggle.smoke()
    params = tdlrm.init_dlrm(0, cfg, n_shards=1, device="cpu")
    b = jsyn.make_batch(jkaggle.smoke(), 12, mode="hetero", seed=4)
    args = tuple(map(torch.from_numpy, (b.dense, b.idx, b.mask)))
    group = mesh.init_model_group("gloo", 1, 0,
                                  f"file://{tmp_path / 'store'}")
    try:
        assert mesh.current_group() is group
        want = tdlrm.forward_local(params, cfg, *args)
        assert torch.equal(tdlrm.forward_distributed(params, cfg, *args),
                           want)
        b0, b2 = (tdlrm.forward_distributed(params, cfg, *args, bound=k,
                                            microbatches=3) for k in (0, 2))
        assert torch.equal(b0, b2)
        torch.testing.assert_close(b2, want, **TOL)
        with pytest.raises(ValueError, match="microbatches"):
            tdlrm.forward_distributed(params, cfg, *args, microbatches=5)
        shard = dict(params, tables=params["tables"][:3])
        with pytest.raises(ValueError, match="shard"):
            tdlrm.forward_distributed(shard, cfg, *args)
    finally:
        mesh.destroy_model_group()
    assert mesh.current_group() is None
