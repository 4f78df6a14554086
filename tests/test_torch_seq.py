"""The production layout's sequence axis in the port (``sharding/tp.py``'s
sequence collectives, ``res_seq`` in training, the KV cache cut by
positions under ``kv_seq`` with the members' softmax parts joined in
decode) against the JAX reference, on the CPU.

One gloo run per P in {2, 4} (``tests/_torch_seq_worker.py``), started
beside the reference's own computations:

- the collectives forward and backward against their definitions
  (``gather_seq``: all-gather, reduce-scatter back; ``scatter_seq``:
  reduce-scatter, all-gather back; ``split_seq``: the block, all-gather
  back; ``own_seq``: the identity, the block of the gradient back),
  exactly;
- under the decode rules each member's cache holds every KV head of a
  block of positions, and the prefill plus decode steps match the
  reference's one-device ``prefill`` and ``decode_step`` within MODEL_TOL
  for gemma2 (window, softcaps), qwen3 and chatglm3 ("select" at P = 4),
  granite (attention replicated at P = 4), qwen2-moe (MoE) and whisper
  (from its cut of the reference's cache, cross K/V included): a prompt
  shorter than one block, members whose blocks hold no live position, 22
  positions that do not divide into 4 blocks, and two steps past the
  cache's end; at P = 4 zamba2 decodes a batch of 1 on a (2, 2) mesh
  under the batch-1 rule (positions over (data, model));
- under the train rules (``res_seq``) the loss and every leaf's gradient
  within GRAD_TOL of ``jax.grad`` of the reference's one-device loss for
  gemma2, qwen3, qwen3 with a whole MLP, embedding and head, qwen2-moe
  (gather dispatch), granite (replicated attention at P = 4) and llava
  (patches); gemma2's at P = 4 also against the reference's gradient on
  its own 4-device mesh under the same rules.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import transformer as jT
from repro.models import whisper as jW

import _torch_seq_worker as W

ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}
LOSS_TOL = {"rtol": 1e-5, "atol": 1e-6}
PS = (2, 4)
COLLECTIVES = ("gather", "scatter", "split", "own")


def _jcfg(case):
    arch = {**W.DECODE_CASES, **W.TRAIN_CASES, "zamba2": "zamba2-2.7b"}[case]
    cfg = jbase.get_arch(arch).smoke()
    return cfg.replace(**W.WHOLE) if case == "qwen3_whole" else cfg


def _flat(prefix, tree, out):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(v)


def _cases():
    return list(dict.fromkeys([*W.DECODE_CASES, *W.TRAIN_CASES, "zamba2"]))


# ---------------------------------------------------------------------------
# inputs, the workers, and the reference's values
# ---------------------------------------------------------------------------


def _coll_inputs(p):
    rng = np.random.default_rng(100 + p)
    inputs = {}
    sb = W.COLL_S // p
    shapes = {"gather": ((W.B, sb, W.COLL_D), (W.B, W.COLL_S, W.COLL_D)),
              "scatter": ((W.B, W.COLL_S, W.COLL_D), (W.B, sb, W.COLL_D)),
              "split": ((W.B, W.COLL_S, W.COLL_D), (W.B, sb, W.COLL_D)),
              "own": ((W.B, W.COLL_S, W.COLL_D), (W.B, W.COLL_S, W.COLL_D))}
    for name, (xs, gs) in shapes.items():
        x = rng.standard_normal((p,) + xs).astype(np.float32)
        if name == "split":      # the same tensor on every member
            x[:] = x[0]
        inputs[f"coll/{name}/x"] = x
        inputs[f"coll/{name}/g"] = rng.standard_normal(
            (p,) + gs).astype(np.float32)
    return inputs


def _inputs():
    """The models' inputs, the same at every P."""
    rng = np.random.default_rng(100)
    inputs, jparams = {}, {}
    inputs["prompts"] = rng.integers(0, 512, (W.B, W.PROMPT), dtype=np.int32)
    inputs["decode_toks"] = rng.integers(0, 512, (W.B, W.STEPS),
                                         dtype=np.int32)
    for i, case in enumerate(_cases()):
        jp = japi.init(jax.random.PRNGKey(i), _jcfg(case),
                       n_shards=W.N_SHARDS)
        jparams[case] = jp
        _flat(case, jp, inputs)
    for case in W.TRAIN_CASES:
        cfg = _jcfg(case)
        n_tok = W.S_TRAIN
        if cfg.frontend == "vision_patches":
            n_tok -= W.N_PATCH_TOKENS
            inputs[f"train/{case}/patches"] = rng.standard_normal(
                (W.TRAIN_B, W.N_PATCH_TOKENS, cfg.d_frontend)).astype(
                    np.float32)
        inputs[f"train/{case}/tokens"] = rng.integers(
            0, 512, (W.TRAIN_B, n_tok), dtype=np.int32)
        labels = rng.integers(0, 512, (W.TRAIN_B, W.S_TRAIN), dtype=np.int32)
        labels[:, :2] = -1
        inputs[f"train/{case}/labels"] = labels
    # whisper: the reference's cache after its decoder read the prompt
    cfg = _jcfg("whisper")
    frames = jnp.asarray(rng.standard_normal(
        (W.B, W.ENC, cfg.d_frontend)).astype(np.float32))
    _, _, ((k, v), (ck, cv)) = jW.forward(
        jparams["whisper"], cfg, jnp.asarray(inputs["prompts"]), frames,
        collect_cache=True, remat=False)
    pad = [(0, 0), (0, 0), (0, W.MAX_LEN - W.PROMPT), (0, 0), (0, 0)]
    for name, a in (("self_k", jnp.pad(k, pad)), ("self_v", jnp.pad(v, pad)),
                    ("cross_k", ck), ("cross_v", cv)):
        inputs[f"whisper_cache/{name}"] = np.asarray(a)
    inputs["whisper_cache/pos"] = np.array(W.PROMPT)
    return inputs, jparams


def _start(p, d, inputs):
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    worker = ROOT / "tests" / "_torch_seq_worker.py"
    return [subprocess.Popen([sys.executable, str(worker), str(r), str(p),
                              str(d)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(p)]


def _finish(procs, d, timeout=600):
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-6000:]
    return [dict(np.load(d / f"out_{r}.npz")) for r in range(len(procs))]


def _decode_want(case, jp, inputs):
    cfg = _jcfg(case)
    step = jax.jit(lambda c, t: japi.decode_step(jp, cfg, t, c))
    feed = inputs["decode_toks"]
    out = {}
    if case == "whisper":
        cache = {k: jnp.asarray(inputs[f"whisper_cache/{k}"])
                 for k in ("self_k", "self_v", "cross_k", "cross_v")}
        cache["pos"] = jnp.int32(W.PROMPT)
    elif case == "zamba2":
        cache = japi.make_cache(cfg, 1, W.MAX_LEN)
        feed = np.concatenate([inputs["prompts"][:1],
                               inputs["decode_toks"][:1]], axis=1)
    else:
        last, cache = jT.prefill(jp, cfg, jnp.asarray(inputs["prompts"]),
                                 pad_to=W.MAX_LEN)
        out["prefill"] = np.asarray(last)
    for i in range(feed.shape[1]):
        lg, cache = step(cache, jnp.asarray(feed[:, i:i + 1]))
        out[f"step{i}"] = np.asarray(lg)
    return out


def _train_want(case, jp, inputs):
    cfg = _jcfg(case)
    batch = {k: jnp.asarray(inputs[f"train/{case}/{k}"])
             for k in ("tokens", "labels", "patches")
             if f"train/{case}/{k}" in inputs}

    def loss_fn(q):
        logits, aux = japi.forward(q, cfg, batch, remat=True)
        return japi.loss(cfg, logits, batch["labels"], aux)

    loss, grad = jax.jit(jax.value_and_grad(loss_fn))(jp)
    grads = {}
    _flat("g", grad, grads)
    return {"loss": np.asarray(loss),
            "grad": {k[2:]: v for k, v in grads.items()}}


_RUNS: dict = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both P's workers, started before the reference computes its values
    beside them."""
    if not _RUNS:
        inputs, jparams = _inputs()
        started = {}
        for p in PS:
            d = tmp_path_factory.mktemp(f"seq{p}")
            mine = {**inputs, **_coll_inputs(p)}
            started[p] = (d, mine, _start(p, d, mine))
        want = {"dec": {c: _decode_want(c, jparams[c], inputs)
                        for c in [*W.DECODE_CASES, "zamba2"]},
                "train": {c: _train_want(c, jparams[c], inputs)
                          for c in W.TRAIN_CASES}}
        for p, (d, mine, procs) in started.items():
            _RUNS[p] = (d, mine, want, _finish(procs, d))
    return _RUNS


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def _coll_want(name, x, g, p):
    sb = x.shape[2] // p if name != "gather" else x.shape[2]
    if name == "gather":
        out = np.concatenate(list(x), axis=1)
        total = g.sum(0)
        return [(out, total[:, r * sb:(r + 1) * sb]) for r in range(p)]
    if name == "scatter":
        total = x.sum(0)
        back = np.concatenate(list(g), axis=1)
        return [(total[:, r * sb:(r + 1) * sb], back) for r in range(p)]
    if name == "split":
        back = np.concatenate(list(g), axis=1)
        return [(x[r][:, r * sb:(r + 1) * sb], back) for r in range(p)]
    out = []
    for r in range(p):
        kept = np.zeros_like(g[r])
        kept[:, r * sb:(r + 1) * sb] = g[r][:, r * sb:(r + 1) * sb]
        out.append((x[r], kept))
    return out


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("p", PS)
def test_sequence_collectives_match_their_definitions(runs, p, name):
    _, inputs, _, outs = runs[p]
    want = _coll_want(name, inputs[f"coll/{name}/x"],
                      inputs[f"coll/{name}/g"], p)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"coll/{name}/out"], want[r][0],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(o[f"coll/{name}/grad"], want[r][1],
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# decode over a cache cut by positions
# ---------------------------------------------------------------------------


# the plan's attention mode where it is not "cut": whisper's model rules
# are all None
PLANS = {("qwen3", 4): "select", ("chatglm3", 4): "select",
         ("gemma2", 4): "select", ("granite", 4): "full",
         ("whisper", 2): "full", ("whisper", 4): "full"}


@pytest.mark.parametrize("case", list(W.DECODE_CASES))
@pytest.mark.parametrize("p", PS)
def test_decode_over_a_cut_cache_matches_the_reference(runs, p, case):
    _, _, want, outs = runs[p]
    cfg = _jcfg(case)
    size = -(-W.MAX_LEN // p)
    for o in outs:
        assert str(o[f"plan/{case}"]) == PLANS.get((case, p), "cut")
        # every KV head, a block of positions
        shape = tuple(o[f"dec/{case}/cache_shape"])
        assert shape[-3:-1] == (size, cfg.n_kv_heads), shape
        if case != "whisper":
            np.testing.assert_allclose(o[f"dec/{case}/prefill"],
                                       want["dec"][case]["prefill"],
                                       **MODEL_TOL)
        for i in range(W.STEPS):
            np.testing.assert_allclose(o[f"dec/{case}/step{i}"],
                                       want["dec"][case][f"step{i}"],
                                       err_msg=f"step {i}", **MODEL_TOL)


def test_zamba2_batch_of_one_over_data_and_model(runs):
    _, _, want, outs = runs[4]
    cfg = _jcfg("zamba2")
    w = want["dec"]["zamba2"]
    for o in outs:
        assert [str(a) for a in o["dec/zamba2/cut"]] == ["data", "model"]
        shape = tuple(o["dec/zamba2/cache_shape"])
        assert shape[2:4] == (-(-W.MAX_LEN // 4), cfg.n_kv_heads), shape
        for i in range(len(w)):
            np.testing.assert_allclose(o[f"dec/zamba2/step{i}"],
                                       w[f"step{i}"], err_msg=f"step {i}",
                                       **MODEL_TOL)


# ---------------------------------------------------------------------------
# training under res_seq
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(W.TRAIN_CASES))
@pytest.mark.parametrize("p", PS)
def test_gradients_under_res_seq_match_jax_grad(runs, p, case):
    """Every leaf's gradient, gathered whole, within GRAD_TOL of
    ``jax.grad`` and non-zero (a norm scale left as one member's part, or
    a sum counted twice, is off by its own size)."""
    _, _, want, outs = runs[p]
    w = want["train"][case]
    for o in outs:
        np.testing.assert_allclose(o[f"train/{case}/loss"], w["loss"],
                                   **LOSS_TOL)
        for k, g in w["grad"].items():
            got = o[f"train/{case}/grad/{k}"]
            assert np.isfinite(got).all(), k
            np.testing.assert_allclose(got, g, err_msg=k, **GRAD_TOL)


MESH_RUN = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import base as cb
from repro.configs.base import ShapeConfig
from repro.launch import specs
from repro.launch.mesh import make_host_mesh
from repro.models import api
from repro.sharding import partition

d, case, seq, batch = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
data = dict(np.load(d + "/inputs.npz"))
cfg = cb.get_arch("gemma2-9b").smoke()
params = {}
for k, v in data.items():
    if k.startswith(case + "/"):
        node = params
        *head, last = k.split("/")[1:]
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
tb = {k: jnp.asarray(data[f"train/{case}/{k}"]) for k in ("tokens", "labels")}
mesh = make_host_mesh(model=4)
rules = specs.arch_rules(cfg, mesh, ShapeConfig("t", "train", seq, batch))
assert rules["res_seq"] == "model"

def loss_fn(q):
    logits, aux = api.forward(q, cfg, tb, remat=True)
    return api.loss(cfg, logits, tb["labels"], aux)

with partition.axis_rules(mesh, rules):
    params = jax.device_put(params, partition.tree_shardings(api.specs(cfg)))
    grad = jax.jit(jax.grad(loss_fn))(params)
out = {}
for path, v in jax.tree_util.tree_flatten_with_path(grad)[0]:
    out["/".join(str(getattr(p, "key", p)) for p in path)] = np.asarray(v)
np.savez(d + "/mesh_grad.npz", **out)
"""


def test_gradients_under_res_seq_match_the_reference_on_its_mesh(runs):
    """gemma2 at P = 4: the reference's gradient on its own 4-device mesh
    under the train rules (GSPMD's sequence parallelism) against the
    port's."""
    d, _, _, outs = runs[4]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", MESH_RUN, str(d), "gemma2",
                        str(W.S_TRAIN), str(W.TRAIN_B)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    want = dict(np.load(d / "mesh_grad.npz"))
    assert want
    for o in outs:
        for k, g in want.items():
            np.testing.assert_allclose(o[f"train/gemma2/grad/{k}"], g,
                                       err_msg=k, **GRAD_TOL)
