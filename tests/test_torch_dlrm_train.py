"""The port's DLRM training against the JAX reference, on the CPU.

The bag and interaction ops' autograd Functions (plain forwards here, the
hand-written backwards of ``kernels/ref.py``) against ``jax.grad`` of the
reference's jnp ops; ``forward_local``'s gradient of every leaf against
``jax.grad`` of the reference's ``forward_local`` BCE loss; the port's
``forward_distributed`` over 1, 2 and 4 gloo members (``_torch_dlrm_train_
worker.py``, started together beside the in-process tests) against the
same gradient, at bound 0 with one microbatch and at bound 2 with four;
one step of the ``dlrm_train`` cell against the reference's cell and
AdamW; and the reference's own distributed table gradient, which is zero:
its uint8 wire bitcasts the pooled rows, and JAX gives a bitcast no
derivative (ROADMAP C2).  Tolerances: 1e-5 relative and absolute.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import flatten
from repro.configs import base as jcb
from repro.configs import dlrm_kaggle as jkaggle
from repro.data import synthetic as jsyn
from repro.kernels import ref as jref
from repro.launch import specs as jspecs
from repro.launch.mesh import make_host_mesh as jhost_mesh
from repro.models import dlrm as jdlrm
from repro.sharding import partition as jpart
from repro.train import optimizer as jopt
from repro_torch.configs import base as tcb
from repro_torch.configs import dlrm_kaggle as tkaggle
from repro_torch.kernels import ops
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_host_mesh as thost_mesh
from repro_torch.models import dlrm as tdlrm
from repro_torch.sharding import partition as tpart
from repro_torch.train import optimizer as topt

TOL = {"rtol": 1e-5, "atol": 1e-5}
WORLDS = (1, 2, 4)
SCHEDULES = ("b0_mb1", "b2_mb4")
BATCH = 16
N_SHARDS = 4
WORKER = Path(__file__).with_name("_torch_dlrm_train_worker.py")


def _reference():
    """The smoke config's parameters (padded for 4 members), a seeded
    hetero batch with labels, and ``jax.value_and_grad`` of the
    reference's ``forward_local`` BCE loss."""
    cfg = jkaggle.smoke()
    params = jdlrm.init_dlrm(jax.random.PRNGKey(3), cfg, n_shards=N_SHARDS)
    b = jsyn.make_batch(cfg, BATCH, mode="hetero", seed=5,
                        t_pad=jdlrm.padded_tables(cfg, N_SHARDS))
    labels = np.random.default_rng(7).integers(0, 2, BATCH) \
        .astype(np.float32)
    batch = {"dense": b.dense, "idx": b.idx, "mask": b.mask,
             "labels": labels}

    def loss(p):
        return jdlrm.bce_loss(jdlrm.forward_local(p, cfg, b.dense, b.idx,
                                                  b.mask), labels)

    value, grads = jax.value_and_grad(loss)(params)
    return params, batch, float(value), grads


@pytest.fixture(scope="module")
def reference():
    return _reference()


@pytest.fixture(scope="module", autouse=True)
def members_started(tmp_path_factory):
    """Every member of the 1-, 2- and 4-member groups, started together
    with the module's first test."""
    params, batch, _, _ = _reference()
    inputs = dict(batch)
    flatten("p", params, inputs)
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(src), str(WORKER.parent)]), OMP_NUM_THREADS="1")
    runs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"dlrm_train{world}")
        np.savez(d / "inputs.npz", **inputs)
        runs[world] = (d, [subprocess.Popen(
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
def members(members_started):
    out = {}
    for world, (d, procs) in members_started.items():
        for p in procs:
            log = p.communicate(timeout=240)[0]
            assert p.returncode == 0, log
        out[world] = [dict(np.load(d / f"out_{r}.npz"))
                      for r in range(world)]
    return out


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# the ops' backwards
# ---------------------------------------------------------------------------

def _bag_case(form, rng):
    t, r, s, b, hot = 5, 11, 8, 7, 3
    tables = rng.standard_normal((t, r, s)).astype(np.float32)
    # ids past the table clamp, in both frameworks
    idx = rng.integers(0, r + 2, (b, t, hot)).astype(np.int32)
    mask = (rng.random((b, t, hot)) < 0.7).astype(np.float32) \
        * rng.random((b, t, hot)).astype(np.float32)
    dout_shape = {"stacked": (b, t, s), "rows": (b, s), "single": (b, s)}
    dout = rng.standard_normal(dout_shape[form]).astype(np.float32)
    tid = rng.integers(0, t + 1, (b,)).astype(np.int32)
    return tables, idx, mask, tid, dout


@pytest.mark.parametrize("form", ["stacked", "rows", "single"])
@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_bag_backward_matches_jax_grad(form, impl):
    tables, idx, mask, tid, dout = _bag_case(
        form, np.random.default_rng(len(form)))
    if form == "stacked":
        jfn = lambda tb: jdlrm.apply_emb(tb, idx, mask, backend="ref")  # noqa
        tfn = lambda tb: ops.embedding_bag_stacked_op(  # noqa: E731
            tb, _t(idx), _t(mask), impl=impl)
    elif form == "rows":
        jfn = lambda tb: jref.embedding_bag_rows_ref(  # noqa: E731
            tb, tid, idx[:, 0], mask[:, 0])
        tfn = lambda tb: ops.embedding_bag_rows_op(  # noqa: E731
            tb, _t(tid), _t(idx[:, 0]), _t(mask[:, 0]), impl=impl)
    else:
        tables = tables[0]
        jfn = lambda tb: jref.embedding_bag_ref(  # noqa: E731
            tb, idx[:, 0], mask[:, 0])
        tfn = lambda tb: ops.embedding_bag_op(  # noqa: E731
            tb, _t(idx[:, 0]), _t(mask[:, 0]), impl=impl)
    _, vjp = jax.vjp(jfn, jnp.asarray(tables))
    want, = vjp(jnp.asarray(dout))
    tt = _t(tables, grad=True)
    out = tfn(tt)
    assert type(out.grad_fn).__name__ == "EmbeddingBagFnBackward"
    got, = torch.autograd.grad(out, tt, _t(dout))
    assert got.dtype == tt.dtype and got.shape == tt.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("f,s", [(2, 4), (9, 16), (27, 64)])
def test_interaction_backward_matches_jax_grad(f, s):
    rng = np.random.default_rng(f)
    z = rng.standard_normal((6, f, s)).astype(np.float32)
    dout = rng.standard_normal((6, f * (f - 1) // 2)).astype(np.float32)
    _, vjp = jax.vjp(jdlrm.dot_interaction, jnp.asarray(z))
    want, = vjp(jnp.asarray(dout))
    tz = _t(z, grad=True)
    got, = torch.autograd.grad(ops.dot_interaction_op(tz), tz, _t(dout))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_a_tracked_mask_is_refused():
    tables, idx, mask, _, _ = _bag_case("stacked", np.random.default_rng(1))
    with pytest.raises(RuntimeError, match="no backward for its mask"):
        ops.embedding_bag_stacked_op(_t(tables, grad=True), _t(idx),
                                     _t(mask, grad=True), impl="ref")


# ---------------------------------------------------------------------------
# the model's gradient
# ---------------------------------------------------------------------------

def _leaves(tree):
    """(path, leaf) pairs of a DLRM parameter tree."""
    yield "tables", tree["tables"]
    for part in ("bot", "top"):
        for i, lp in enumerate(tree[part]):
            for k in ("kernel", "bias"):
                yield f"{part}/{i}/{k}", lp[k]


def test_forward_local_grads_match_jax(reference):
    params, batch, value, grads = reference
    cfg = tkaggle.smoke()
    tp = tdlrm.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    leaves = [x.requires_grad_() for _, x in _leaves(tp)]
    loss = tdlrm.bce_loss(tdlrm.forward_local(
        tp, cfg, _t(batch["dense"]), _t(batch["idx"]), _t(batch["mask"])),
        _t(batch["labels"]))
    got = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), value, **TOL)
    for (path, want), g in zip(_leaves(grads), got, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL,
                                   err_msg=path)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("world", WORLDS)
def test_distributed_grads_match_jax_forward_local(reference, members,
                                                   world, schedule):
    """Each member's gradient of its own tables, concatenated, is the
    whole stack's; every member's MLP gradients are the whole batch's
    (summed over the members once, not P times)."""
    _, _, value, grads = reference
    outs = members[world]
    tables = np.concatenate([o[f"{schedule}/tables"] for o in outs])
    np.testing.assert_allclose(tables, np.asarray(grads["tables"]), **TOL)
    assert np.abs(tables).max() > 0
    for o in outs:
        np.testing.assert_allclose(float(o[f"{schedule}/loss"]), value,
                                   **TOL)
        for path, want in _leaves(grads):
            if path != "tables":
                np.testing.assert_allclose(o[f"{schedule}/{path}"],
                                           np.asarray(want), **TOL,
                                           err_msg=path)


@pytest.mark.parametrize("option", ["wire_dtype", "exchange",
                                    "exchange_pipeline"])
def test_exchange_options_without_a_gradient_raise(members, option):
    for o in members[2]:
        assert bool(o[f"refused/{option}"])


# ---------------------------------------------------------------------------
# the train cell, and the reference's zero table gradient
# ---------------------------------------------------------------------------

TRAIN_SHAPE = "t_dlrm_train"


def _registered_cells():
    """The smoke config registered in both registries with a 16-row train
    shape; -> (reference cell, port cell), the registrations popped."""
    jcfg, tcfg = jkaggle.smoke(), tkaggle.smoke()
    jcb.register(jcb.ArchSpec(config=jcfg, smoke=lambda: jcfg, shapes=(
        jcb.ShapeConfig(TRAIN_SHAPE, "train", 1, BATCH),)))
    tcb.register(tcb.ArchSpec(config=tcfg, smoke=lambda: tcfg, shapes=(
        tcb.ShapeConfig(TRAIN_SHAPE, "train", 1, BATCH),)))
    try:
        return (jspecs.build_cell(jcfg.name, TRAIN_SHAPE, jhost_mesh()),
                tspecs.build_cell(tcfg.name, TRAIN_SHAPE, thost_mesh()))
    finally:
        jcb._REGISTRY.pop(jcfg.name)
        tcb._REGISTRY.pop(tcfg.name)


def test_train_cell_step_matches_the_reference():
    """One step of the port's cell from the same parameters and batch:
    the MLP leaves equal the reference cell's, the tables equal AdamW
    applied to the reference's ``forward_local`` gradient (the reference
    cell's own tables move by weight decay alone)."""
    jcell, tcell = _registered_cells()
    cfg = tkaggle.smoke()
    p0 = jax.tree.map(lambda t: t.numpy(), tdlrm.init_dlrm(
        0, cfg, n_shards=16, device="cpu"))
    rng = np.random.default_rng(9)
    b = jsyn.make_batch(cfg, BATCH, mode="uniform", seed=9,
                        t_pad=jdlrm.padded_tables(cfg, 16))
    batch = {"dense": b.dense, "idx": b.idx, "mask": b.mask,
             "labels": rng.integers(0, 2, BATCH).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p0)
    with jpart.axis_rules(jhost_mesh(), jcell.rules):
        jnew, _, jm = jax.jit(jcell.fn)(jp, jopt.adamw_init(jp), batch)

    def loss(p):
        return jdlrm.bce_loss(jdlrm.forward_local(
            p, jkaggle.smoke(), b.dense, b.idx, b.mask), batch["labels"])

    grads = jax.grad(loss)(jp)
    st = jopt.adamw_init(jp)
    want, _ = jopt.adamw_update(grads, st, jp,
                                jopt.cosine_schedule(st["count"]))
    tp = tdlrm.params_from_jax(p0, "cpu")
    with tpart.axis_rules(thost_mesh(), tcell.rules):
        tnew, tstate, tm = tcell.fn(tp, topt.adamw_init(tp),
                                    {k: _t(v) for k, v in batch.items()})
    assert int(tstate["count"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    for path, x in _leaves(tnew):
        if path == "tables":
            np.testing.assert_allclose(x.numpy(), np.asarray(want["tables"]),
                                       **TOL)
            assert not np.allclose(np.asarray(want["tables"]),
                                   np.asarray(jnew["tables"]))
        else:
            part, i, k = path.split("/")
            np.testing.assert_allclose(
                x.numpy(), np.asarray(jnew[part][int(i)][k]), **TOL,
                err_msg=path)


def test_reference_distributed_table_gradient_is_zero(reference):
    """The caveat the port routes around (ROADMAP C2): through the
    reference's ``forward_distributed`` the MLPs get ``forward_local``'s
    gradient, the tables exactly zero."""
    params, batch, _, grads = reference
    cfg = jkaggle.smoke()

    def loss(p):
        return jdlrm.bce_loss(jdlrm.forward_distributed(
            p, cfg, batch["dense"], batch["idx"], batch["mask"], bound=0,
            microbatches=1, restore_order=False), batch["labels"])

    with jpart.axis_rules(jhost_mesh(), {}):
        dist = jax.jit(jax.grad(loss))(params)
    assert np.abs(np.asarray(grads["tables"])).max() > 1e-4
    assert not np.asarray(dist["tables"]).any()
    for part in ("bot", "top"):
        for lp, want in zip(dist[part], grads[part]):
            for k in ("kernel", "bias"):
                np.testing.assert_allclose(np.asarray(lp[k]),
                                           np.asarray(want[k]), rtol=1e-4,
                                           atol=1e-6)
