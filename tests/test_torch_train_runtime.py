"""The port's training at the model level and its runtime against the JAX
reference on the CPU: every LM arch's loss and gradients at smoke size and
three train steps, the checkpoint format both ways, the data pipeline, and
the entry points (``launch/train.py``, the ``train_lm`` example).

The arch cases run ``_torch_train_helpers.check_train_step`` (the rest of
the archs run in ``tests/test_torch_train.py``): losses and each gradient
leaf at a relative (Frobenius) 1e-4, sums in other orders through two or
four layers.  Checkpoints are held bit for bit.
"""
import json
import os
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import api as japi
from repro.runtime import checkpoint as jC
from repro_torch.configs import base as tcb
from repro_torch.data.pipeline import Prefetcher, Preloader
from repro_torch.examples import train_lm as ttrain_lm
from repro_torch.launch import train as ttrain
from repro_torch.runtime import checkpoint as tC
from repro_torch.train import optimizer as topt

from _torch_train_helpers import (LM_ARCHS, TRAIN_FILE_ARCHS,
                                  check_train_step, converted)

ROOT = Path(__file__).resolve().parents[1]


def test_every_reference_lm_arch_is_covered():
    assert LM_ARCHS == [a for a in tcb.list_archs()
                        if not a.startswith("dlrm")]
    assert len(LM_ARCHS) == 10
    assert set(TRAIN_FILE_ARCHS) < set(LM_ARCHS)


@pytest.mark.parametrize("arch", [a for a in LM_ARCHS
                                  if a not in TRAIN_FILE_ARCHS])
def test_train_step_matches_the_reference(arch):
    check_train_step(arch)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _state(seed):
    rng = np.random.default_rng(seed)
    params = {"embed": {"table": rng.standard_normal((5, 3),
                                                     dtype=np.float32)},
              "layers": {"sub0": {"w": rng.standard_normal(
                  (2, 3, 4), dtype=np.float32)}}}
    opt = {"m": jax.tree.map(lambda a: 0.5 * a, params),
           "v": jax.tree.map(np.square, params),
           "count": np.int32(7)}
    return params, opt


def _as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    params, opt = _state(0)
    jC.save(str(tmp_path), 5, (jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, opt)))
    zeros = jax.tree.map(lambda a: torch.zeros(np.shape(a),
                                               dtype=torch.from_numpy(
                                                   np.asarray(a)).dtype),
                         (params, opt))
    assert tC.latest_step(str(tmp_path)) == 5
    (tp, topt_), step = tC.restore(str(tmp_path), zeros)
    assert step == 5 and topt_["count"].dtype == torch.int32
    for a, b in zip(jax.tree.leaves((params, opt)),
                    jax.tree.leaves(jax.tree.map(
                        lambda t: t.numpy(), (tp, topt_)))):
        _bits_equal(b, a)


def test_a_port_checkpoint_restores_in_jax(tmp_path):
    params, opt = _state(1)
    tC.save(str(tmp_path), 3, (_as_torch(params), _as_torch(opt)))
    d = tmp_path / "step_00000003"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 3
    assert manifest["leaves"]["1/count"] == {"shape": [], "dtype": "int32"}
    assert "0/layers/sub0/w" in manifest["leaves"]
    like = jax.tree.map(jnp.zeros_like, (params, opt))
    (jp, jo), step = jC.restore(str(tmp_path), like)
    assert step == 3 == jC.latest_step(str(tmp_path))
    for a, b in zip(jax.tree.leaves((params, opt)),
                    jax.tree.leaves((jp, jo))):
        _bits_equal(b, a)
    # the same manifest the reference writes for the same tree
    jC.save(str(tmp_path / "j"), 3, jax.tree.map(jnp.asarray,
                                                  (params, opt)))
    want = json.loads((tmp_path / "j" / "step_00000003" /
                       "manifest.json").read_text())
    assert manifest == want


def test_restore_places_leaves_on_the_device_given(tmp_path):
    params, opt = _state(2)
    tree = (_as_torch(params), _as_torch(opt))
    tC.save(str(tmp_path), 1, tree)
    out, _ = tC.restore(str(tmp_path), tree, device="meta")
    assert all(t.device.type == "meta" for t in topt.leaves(out))


def test_latest_pointer_and_gc(tmp_path):
    tree = {"w": torch.ones(2)}
    for s in (1, 2, 3, 4, 5):
        tC.save(str(tmp_path), s, tree, keep=2)
    assert tC.latest_step(str(tmp_path)) == 5
    kept = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]
    assert not (tmp_path / ".LATEST.tmp").exists()


def test_atomicity_partial_write_ignored(tmp_path):
    tree = {"w": torch.ones(2)}
    tC.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "arrays.npz").write_bytes(b"torn")
    restored, step = tC.restore(str(tmp_path), tree)
    assert step == 1
    tC.save(str(tmp_path), 3, tree, keep=5)
    assert sorted(os.listdir(tmp_path)) == [
        "LATEST", "step_00000001", "step_00000002.tmp", "step_00000003"]


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    tree = {"w": torch.arange(8.0)}
    ck = tC.AsyncCheckpointer(str(tmp_path))
    ck.save(1, tree)
    tree["w"].mul_(2)            # training goes on in place
    ck.save(2, tree)
    tree["w"].add_(100)
    ck.wait()
    r1, _ = tC.restore(str(tmp_path), tree, step=1)
    r2, step = tC.restore(str(tmp_path), tree)
    assert step == 2
    assert torch.equal(r1["w"], torch.arange(8.0))
    assert torch.equal(r2["w"], torch.arange(8.0) * 2)


def test_async_checkpointer_surfaces_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = tC.AsyncCheckpointer(str(blocker))
    ck.save(1, {"w": torch.ones(1)})
    with pytest.raises(OSError):
        ck.wait()


def test_missing_leaf_raises(tmp_path):
    tC.save(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(KeyError):
        tC.restore(str(tmp_path), {"w": torch.ones(2),
                                   "extra": torch.ones(1)})
    with pytest.raises(FileNotFoundError):
        tC.restore(str(tmp_path / "none"), {"w": torch.ones(2)})


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_prefetcher_order_and_exhaustion():
    assert list(Prefetcher(iter(range(10)), depth=3)) == list(range(10))


def test_prefetcher_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = Prefetcher(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        for _ in it:
            pass


def test_preloader_materialises_up_front():
    made = []
    pre = Preloader(lambda i: made.append(i) or i * i, 4)
    assert made == [0, 1, 2, 3] and len(pre) == 4
    assert list(pre) == [0, 1, 4, 9]


@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_synthetic_batches_match_the_reference(arch):
    from repro.launch import train as jtrain
    jcfg, tcfg = jcb.get_arch(arch).smoke(), tcb.get_arch(arch).smoke()
    want = list(jtrain.synthetic_batches(jcfg, 2, 24, 3, seed=4))
    got = list(ttrain.synthetic_batches(tcfg, 2, 24, 3, seed=4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    cfg = tcb.get_arch("qwen2-moe-a2.7b").smoke()
    whole = ttrain.train(cfg, steps=4, batch=2, seq=16, device="cpu",
                         log=lambda *a: None)
    ck = str(tmp_path / "ck")
    ttrain.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--ckpt-dir", ck,
                 "--device", "cpu"])
    assert tC.latest_step(ck) == 1
    again = ttrain.train(cfg, steps=4, batch=2, seq=16, ckpt_dir=ck,
                         device="cpu", log=print)
    out = capsys.readouterr().out
    assert "training done" in out and "resumed from step 1" in out
    assert again.start == 2 and [h[0] for h in again.history] == [2, 3]
    assert int(again.opt_state["count"]) == 4 == int(
        whole.opt_state["count"])
    for h, w in zip(again.history, whole.history[2:]):
        assert h[1] == pytest.approx(w[1], rel=1e-6)
    for a, b in zip(topt.leaves(again.params), topt.leaves(whole.params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert tC.latest_step(ck) == 3


def test_launch_train_production_mesh_needs_256_processes():
    """``--production-mesh`` trains on the (16, 16) mesh over the process
    group; with fewer processes it raises, as the reference does without
    256 devices."""
    with pytest.raises(ValueError, match="256"):
        ttrain.main(["--arch", "qwen3-14b", "--smoke", "--production-mesh",
                     "--device", "cpu"])


def _losses(out: str):
    return [(int(line.split()[1]), float(line.split()[3]),
             float(line.split()[5]), float(line.split()[7]))
            for line in out.splitlines() if line.startswith("step ")]


def test_train_lm_prints_the_references_losses(tmp_path, capsys,
                                               monkeypatch):
    args = ["--steps", "12", "--d-model", "64", "--layers", "2",
            "--batch", "2", "--seq", "16"]
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *args, "--ckpt-dir",
                                      str(tmp_path / "j")])
    runpy.run_path(str(ROOT / "examples" / "train_lm.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    cfg = ttrain_lm.lm_config(64, 2)
    from repro.configs.base import ModelConfig as JModelConfig
    jcfg = JModelConfig(**{f: getattr(cfg, f) for f in
                           ("name", "family", "n_layers", "d_model",
                            "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                            "dtype", "remat")})
    jp = japi.init(jax.random.PRNGKey(0), jcfg, n_shards=1)
    ttrain_lm.main([*args, "--ckpt-dir", str(tmp_path / "t"),
                    "--device", "cpu"], params=converted(jp))
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]   # the model size
    w, g = _losses(want), _losses(got)
    assert [x[0] for x in g] == [x[0] for x in w] == [0, 10, 11]
    for a, b in zip(g, w):
        assert a[1] == pytest.approx(b[1], rel=1e-4, abs=1e-4)
        assert a[2] == pytest.approx(b[2], rel=1e-3, abs=1e-3)
        assert a[3] == pytest.approx(b[3], rel=1e-2)
