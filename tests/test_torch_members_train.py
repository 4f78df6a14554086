"""The port's gradient codecs, ``ElasticRunner`` and the failure-recovery
example against the JAX reference, in one process on the CPU (the gloo
runs of the LM over members are in ``tests/test_torch_members.py``).

The codecs are held bit for bit (``topk`` on inputs without ties:
``torch.topk`` need not order ties as ``jax.lax.top_k``); the example's
printed lines equal the reference's but for wall times and the survivor
count of Part 1 (the reference's 8 host devices halve to 4; the port's
one process is its one survivor).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import elastic as jelastic
from repro.train import grad_compression as jGC
from repro_torch.runtime import elastic as telastic
from repro_torch.train import grad_compression as tGC

ROOT = Path(__file__).resolve().parents[1]


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((7, 33), 1e-3),
                                         ((4, 8, 16), 50.0)])
def test_int8_codec_matches_the_reference(shape, scale):
    x = _x(0, shape, scale)
    q, s = tGC.int8_encode(torch.from_numpy(x))
    jq, js = jGC.int8_encode(jnp.asarray(x))
    _eq(q, jq)
    _eq(s, js)
    _eq(tGC.int8_decode(q, s), jGC.int8_decode(jq, js))
    # a given scale, and an all-zero tensor (the 1e-12 floor)
    q2, _ = tGC.int8_encode(torch.from_numpy(x), torch.tensor(0.01))
    _eq(q2, jGC.int8_encode(jnp.asarray(x), jnp.float32(0.01))[0])
    z = np.zeros(shape, np.float32)
    _eq(tGC.int8_encode(torch.from_numpy(z))[1],
        jGC.int8_encode(jnp.asarray(z))[1])


@pytest.mark.parametrize("k_frac", [0.01, 0.1, 0.5])
def test_topk_codec_matches_the_reference(k_frac):
    x = _x(1, (40, 25))
    assert len(np.unique(np.abs(x))) == x.size      # no ties
    v, i = tGC.topk_encode(torch.from_numpy(x), k_frac)
    jv, ji = jGC.topk_encode(jnp.asarray(x), k_frac)
    _eq(v, jv)
    _eq(i, ji)
    _eq(tGC.topk_decode(v, i, x.size), jGC.topk_decode(jv, ji, x.size))


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_error_feedback_matches_the_reference(codec):
    grads = {"a": _x(2, (16, 8)), "b": [_x(3, (5,)), _x(4, (3, 3), 1e-2)]}
    tg = jax.tree.map(torch.from_numpy, grads)
    jg = jax.tree.map(jnp.asarray, grads)
    te, je = tGC.ef_init(tg), jGC.ef_init(jg)
    for step in range(4):
        tg2, te = tGC.compress_grads(tg, te, codec=codec, k_frac=0.25)
        jg2, je = jGC.compress_grads(jg, je, codec=codec, k_frac=0.25)
        for t, j in zip(jax.tree.leaves(tg2), jax.tree.leaves(jg2)):
            _eq(t, j)
        for t, j in zip(jax.tree.leaves(te), jax.tree.leaves(je)):
            _eq(t, j)
    g, e = tGC.ef_compress_leaf(torch.from_numpy(grads["a"]),
                                torch.zeros(16, 8), codec, 0.25)
    jg_, je_ = jGC.ef_compress_leaf(jnp.asarray(grads["a"]),
                                    jnp.zeros((16, 8)), codec, 0.25)
    _eq(g, jg_)
    _eq(e, je_)
    with pytest.raises(ValueError):
        tGC.ef_compress_leaf(torch.zeros(2), torch.zeros(2), "fp4")
    assert tGC.wire_bytes_saved(4096) == jGC.wire_bytes_saved(4096) == 3072


def test_training_converges_with_compression():
    """The twin of ``test_runtime_extras.py::
    test_training_converges_with_compression``: int8-EF gradients still
    reach a low loss on a small regression."""
    gen = torch.Generator().manual_seed(2)
    w_true = torch.randn(8, generator=gen)
    xs = torch.randn(128, 8, generator=gen)
    ys = xs @ w_true

    def loss(w):
        return torch.mean((xs @ w - ys) ** 2)

    for codec in (None, "int8"):
        w = torch.zeros(8)
        err = {"w": torch.zeros(8)}
        for _ in range(200):
            w.requires_grad_(True)
            (g,) = torch.autograd.grad(loss(w), w)
            w = w.detach()
            if codec:
                (g,), err_tree = tGC.compress_grads((g,), (err["w"],),
                                                    codec=codec)
                err["w"] = err_tree[0]
            w = w - 0.1 * g
        assert float(loss(w)) < 1e-3, codec


def test_compressed_psum_on_one_member_is_the_int8_round_trip():
    """Without a process group it is the codec's own round trip (a group
    of one sums one payload)."""
    import torch.distributed as dist
    x = _x(5, (300,))
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        got = tGC.compressed_psum(torch.from_numpy(x))
    finally:
        dist.destroy_process_group()
    q, s = jGC.int8_encode(jnp.asarray(x))
    _eq(got, jGC.int8_decode(q, s))


# ---------------------------------------------------------------------------
# elastic, one device
# ---------------------------------------------------------------------------


def test_pick_mesh_shape_matches_the_reference():
    for n in range(1, 33):
        for model in (0, 1, 2, 4, 16):
            assert telastic.pick_mesh_shape(n, model) == \
                jelastic.pick_mesh_shape(n, model)


def test_elastic_runner_recovers():
    """The twin of ``test_runtime_extras.py::test_elastic_runner_recovers``:
    mesh None, no layout; the failed step is retried."""
    calls = {"n": 0}

    def fault(step):
        if step == 2 and calls["n"] == 0:
            calls["n"] += 1
            raise telastic.NodeFailure([0])

    runner = telastic.ElasticRunner(make_shardings=lambda mesh: None)
    state, mesh, recoveries = runner.run(
        torch.tensor(0.0), [torch.tensor(float(i)) for i in (1, 2, 3, 4)],
        lambda state, batch, mesh: state + batch, None, fault=fault)
    assert recoveries == 1
    assert float(state) == 10.0  # failed step retried, nothing lost
    assert mesh.shape == {"data": 1, "model": 1}


def test_elastic_runner_restores_the_last_checkpoint(tmp_path):
    """With a checkpoint directory the runner restores the last save and
    replays every step after it; too many failures re-raise."""
    seen = []

    def fault(step):
        if step == 5 and seen.count(5) < 1:
            seen.append(5)
            raise telastic.NodeFailure([0])

    def step_fn(state, batch, mesh):
        seen.append(("step", int(batch)))
        return state + batch

    runner = telastic.ElasticRunner(make_shardings=lambda mesh: None,
                                    ckpt_dir=str(tmp_path / "ck"))
    batches = [torch.tensor(float(i)) for i in range(8)]
    state, _, rec = runner.run(torch.tensor(0.0),
                               lambda s: iter(batches[s:]), step_fn, None,
                               fault=fault, ckpt_every=2)
    assert rec == 1 and float(state) == sum(range(8))
    assert [s for s in seen if s != 5] == \
        [("step", i) for i in range(5)] + [("step", i) for i in range(5, 8)]

    def always(step):
        raise telastic.NodeFailure([0])

    with pytest.raises(telastic.NodeFailure):
        telastic.ElasticRunner(make_shardings=lambda mesh: None,
                               max_recoveries=2).run(
            torch.tensor(0.0), batches, lambda s, b, m: s + b, None,
            fault=always)


def test_reshard_moves_whole_tree():
    """The twin of ``test_runtime_extras.py::test_reshard_moves_whole_tree``:
    without layouts the tree comes back as it is; onto a one-member layout
    every leaf is kept whole."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.sharding import partition as tpart

    tree = {"a": torch.arange(4.0), "b": [torch.ones(2, 2), torch.zeros(3)]}
    assert telastic.reshard(tree, None, None) is tree
    mesh = tmesh.make_host_mesh()
    lay = tpart.Layout(mesh, {"a": ("model",), "b": [(None, "model"),
                                                     (None,)]})
    out = telastic.reshard(tree, lay, lay)
    assert set(out) == {"a", "b"} and len(out["b"]) == 2
    assert torch.equal(out["a"], torch.arange(4.0))
    assert torch.equal(out["b"][0], torch.ones(2, 2))


# ---------------------------------------------------------------------------
# the failure-recovery example
# ---------------------------------------------------------------------------


MASK = [(re.compile(r"recovery \d+ ms"), "recovery <t> ms"),
        (re.compile(r"^!! injecting node failure at step 25: \d+ devices"),
         "!! injecting node failure at step 25: <n> devices")]


def _lines(text):
    out = []
    for line in text.strip().splitlines():
        for pat, sub in MASK:
            line = pat.sub(sub, line)
        out.append(line)
    return out


def test_failure_recovery_example_prints_the_reference_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, str(ROOT / "examples" /
                                              "failure_recovery.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    port = subprocess.run([sys.executable, "-m",
                           "repro_torch.examples.failure_recovery",
                           "--device", "cpu"], env=env, capture_output=True,
                          text=True, timeout=300)
    assert port.returncode == 0, port.stdout + port.stderr
    assert _lines(port.stdout) == _lines(ref.stdout)
    assert "1 devices survive" in port.stdout


def test_train_driver_runs_data_parallel_under_torchrun(tmp_path):
    """``launch/train.py`` under torchrun (2 gloo ranks, ``env://``) runs
    over ``make_host_mesh(model=1)``: each rank a row of every batch, the
    first rank writing the checkpoint; its parameters after 3 steps as one
    process's on the whole batches (AdamW moves a leaf by up to lr = 3e-6
    a step where rounding flips a near-zero gradient: atol 1e-5)."""
    import numpy as np
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--arch", "qwen3-14b",
            "--smoke", "--steps", "3", "--batch", "4", "--seq", "16",
            "--device", "cpu"]
    for name, pre in (("dp", [sys.executable, "-m",
                              "torch.distributed.run", "--standalone",
                              "--nproc-per-node", "2"]),
                      ("one", [sys.executable])):
        r = subprocess.run(pre + args + ["--ckpt-dir", str(tmp_path / name)],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert r.stdout.count("training done") == 1, r.stdout
    dp = np.load(tmp_path / "dp" / "step_00000002" / "arrays.npz")
    one = np.load(tmp_path / "one" / "step_00000002" / "arrays.npz")
    assert sorted(dp.files) == sorted(one.files)
    for k in one.files:
        np.testing.assert_allclose(dp[k], one[k], rtol=0, atol=1e-5,
                                   err_msg=k)
