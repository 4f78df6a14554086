"""The port's LM over members (logical-axis rules on process groups,
tensor- and expert-parallel transformer, data-parallel training, the int8
gradient codec, checkpoints of a laid-out state, ``ElasticRunner``)
against the JAX reference, on the CPU.

Rules and spec trees are held exactly; ``shard_tree``/``gather_tree`` bit
for bit.  The model runs on 2 and 4 gloo members
(``tests/_torch_members_worker.py``, one run per P) on the reference's
parameters: f32 logits within FORWARD_TOL of the reference's one-device
``api.forward`` (the members' sums run in other orders), prefill and 8
decode steps within MODEL_TOL, ``LMEngine`` tokens equal, gradients of the
training loss within GRAD_TOL of ``jax.grad``; one config also against the
reference on its own P-device mesh.  Training steps over members agree with
the port's one-device step within STEP_TOL; the codecs and
``compressed_psum`` bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import specs as jspecs
from repro.models import api as japi
from repro.models import transformer as jT
from repro.runtime import checkpoint as jC
from repro.runtime import elastic as jelastic
from repro.serving import engine as jengine
from repro.sharding import partition as jpart
from repro.train import grad_compression as jGC
from repro.train import optimizer as jopt
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import api as tapi
from repro_torch.models import transformer as tT
from repro_torch.runtime import elastic as telastic
from repro_torch.sharding import partition as tpart
from repro_torch.train import grad_compression as tGC
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps

import _torch_members_worker as W
from _torch_dist_worker import run_members

ROOT = Path(__file__).resolve().parents[1]
FORWARD_TOL = {"rtol": 1e-5, "atol": 1e-5}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}
STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}
# AdamW moves a leaf by ~lr whatever its gradient's size, so rounding noise
# in a gradient near 0 moves a parameter by up to lr (3e-6 a step here)
ELASTIC_TOL = {"rtol": 0.0, "atol": 1e-5}
MESH_SIZES = (1, 2, 4, 16)
LM_ARCHS = [a for a in tbase.list_archs()
            if isinstance(tbase.get_arch(a).config, tbase.ModelConfig)]


def jconfig(case):
    arch, moe_kw = W.CASES[case]
    cfg = jbase.get_arch(arch).smoke()
    if moe_kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg


def _flat(prefix, tree, out):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(v)


def _mesh(data, model):
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 axis_names=("data", "model"))


# ---------------------------------------------------------------------------
# rules and spec trees, exactly
# ---------------------------------------------------------------------------


def test_default_rules_match_the_reference():
    assert tpart.DEFAULT_RULES == jpart.DEFAULT_RULES


def _shapes():
    return list(jbase.LM_SHAPES) + [jbase.DLRM_INFER, jbase.DLRM_TRAIN]


@pytest.mark.parametrize("p", MESH_SIZES)
def test_arch_rules_match_the_reference(p):
    for arch in tbase.list_archs():
        tcfg, jcfg = tbase.get_arch(arch).config, jbase.get_arch(arch).config
        for js, ts in zip(_shapes(), list(tbase.LM_SHAPES) +
                          [tbase.DLRM_INFER, tbase.DLRM_TRAIN]):
            for data in (1, 2):
                assert tspecs.arch_rules(tcfg, _mesh(data, p), ts) == \
                    jspecs.arch_rules(jcfg, _mesh(data, p), js), \
                    (arch, js.name, data, p)


def _is_spec(t):
    return isinstance(t, tuple) and all(a is None or isinstance(a, str)
                                        for a in t)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spec_trees_match_the_reference(arch):
    tcfg, jcfg = tbase.get_arch(arch).smoke(), jbase.get_arch(arch).smoke()
    assert tapi.specs(tcfg) == japi.specs(jcfg)
    assert tapi.cache_specs(tcfg) == japi.cache_specs(jcfg)
    for kind in ("train", "prefill", "decode"):
        assert tapi.batch_spec_axes(tcfg, kind) == \
            japi.batch_spec_axes(jcfg, kind)
    # the spec tree matches the parameter tree leaf for leaf
    params = tapi.init(0, tcfg, "cpu", n_shards=4)
    tpart.map_specs(lambda path, s, x: None if len(s) == x.dim() else
                    pytest.fail(f"{path}: {s} for {tuple(x.shape)}"),
                    tapi.specs(tcfg), params)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_physical_resolution_matches_the_reference(arch):
    """Every leaf of every spec tree resolves like the reference's
    ``_physical`` under ``arch_rules`` for every shape kind and P."""
    tcfg, jcfg = tbase.get_arch(arch).config, jbase.get_arch(arch).config
    trees = [japi.specs(jcfg), japi.cache_specs(jcfg)]
    leaves = [s for t in trees for s in jax.tree.leaves(t, is_leaf=_is_spec)]
    for js, ts in zip(jbase.LM_SHAPES, tbase.LM_SHAPES):
        for data, p in ((1, 1), (1, 4), (2, 4), (4, 16)):
            m = _mesh(data, p)
            jr = dict(jpart.DEFAULT_RULES, **jspecs.arch_rules(jcfg, m, js))
            tr = dict(tpart.DEFAULT_RULES, **tspecs.arch_rules(tcfg, m, ts))
            for axes in leaves:
                assert tpart._physical(axes, tr, m) == \
                    tuple(jpart._physical(axes, jr, m)), (arch, axes)
    # and a tree at once, as tree_shardings
    m = _mesh(2, 4)
    rules = tspecs.arch_rules(tcfg, m, tbase.TRAIN_4K)
    got = tpart.tree_layout(tapi.specs(tcfg), m, rules).specs
    want = jax.tree.map(
        lambda axes: tuple(jpart._physical(axes, dict(
            jpart.DEFAULT_RULES, **jspecs.arch_rules(jcfg, m, jbase.TRAIN_4K)),
            m)), japi.specs(jcfg), is_leaf=_is_spec)
    assert got == want


def test_constrain_checks_the_rank_under_a_mesh():
    x = torch.zeros(2, 3)
    assert tpart.constrain(x, "batch") is x        # no mesh: no check
    with tpart.axis_rules(tmesh.make_host_mesh()):
        assert tpart.constrain(x, "batch", "seq") is x
        with pytest.raises(ValueError, match="2 axes|1 axes"):
            tpart.constrain(x, "batch")


def test_one_member_mesh_runs_the_one_device_path():
    """make_host_mesh(model=1) without a process group: the plan is None and
    the forward gives exactly the one-device logits."""
    cfg = tbase.get_arch("qwen3-14b").smoke()
    params = tapi.init(0, cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8), dtype=np.int32))
    with torch.no_grad():
        want, _ = tapi.forward(params, cfg, {"tokens": toks})
        mesh = tmesh.make_host_mesh(model=1)
        assert mesh.shape == {"data": 1, "model": 1} and mesh.is_member
        with tpart.axis_rules(mesh):
            got, _ = tapi.forward(params, cfg, {"tokens": toks})
            specs = tapi.param_layout(cfg).specs
            tpart.map_specs(lambda path, spec: None if not any(spec) else
                            pytest.fail(f"{path} cut: {spec}"), specs)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the gloo runs
# ---------------------------------------------------------------------------


def _inputs(p, d):
    inputs, want = {}, {}
    rng = np.random.default_rng(p)
    prompts = rng.integers(0, 512, (W.B, W.S), dtype=np.int32)
    decode_toks = rng.integers(0, 512, (W.B, W.DECODE), dtype=np.int32)
    train = {"tokens": rng.integers(0, 512, (W.TRAIN_B, W.S),
                                    dtype=np.int32),
             "labels": rng.integers(0, 512, (W.TRAIN_B, W.S),
                                    dtype=np.int32)}
    inputs.update(prompts=prompts, decode_toks=decode_toks,
                  **{f"train/{k}": v for k, v in train.items()})
    patches = None
    for i, case in enumerate(W.CASES):
        jcfg = jconfig(case)
        jp = japi.init(jax.random.PRNGKey(i), jcfg, n_shards=W.N_SHARDS)
        _flat(case, jp, inputs)
        batch = {"tokens": jnp.asarray(prompts)}
        if jcfg.frontend != "none":
            patches = rng.standard_normal(
                (W.B, jcfg.n_frontend_tokens, jcfg.d_frontend)).astype(
                    np.float32)
            batch["patches"] = jnp.asarray(patches)
        w = {"logits": np.asarray(japi.forward(jp, jcfg, batch,
                                               remat=False)[0])}
        if jcfg.frontend == "none":
            last, cache = jT.prefill(jp, jcfg, jnp.asarray(prompts),
                                     pad_to=W.PAD)
            w["prefill"] = np.asarray(last)
            for t in range(W.DECODE):
                lg, cache = japi.decode_step(
                    jp, jcfg, jnp.asarray(decode_toks[:, t:t + 1]), cache)
                w[f"decode{t}"] = np.asarray(lg)
            w["tokens"] = jengine.LMEngine(jp, jcfg, max_len=W.PAD) \
                .generate(prompts, W.GEN)
            tb = {k: jnp.asarray(v) for k, v in train.items()}

            def loss_fn(q, jcfg=jcfg, tb=tb):
                logits, aux = japi.forward(q, jcfg, tb, remat=True)
                return japi.loss(jcfg, logits, tb["labels"], aux)

            if jcfg.moe is None or jcfg.moe.dispatch != "a2a":
                w["loss"], w["grad"] = jax.value_and_grad(loss_fn)(jp)
        want[case] = w
    inputs["patches"] = patches
    inputs["psum/x"] = rng.standard_normal((4, 1000)).astype(np.float32)
    for i in range(W.ELASTIC_STEPS):
        for k in ("tokens", "labels"):
            inputs[f"elastic/{i}/{k}"] = rng.integers(
                0, 512, (W.TRAIN_B, W.S), dtype=np.int32)
    # a reference checkpoint of a (params, AdamW state) tree
    jp = japi.init(jax.random.PRNGKey(1), jconfig("qwen3"), n_shards=4)
    st = jopt.adamw_init(jp)
    st = {"m": jax.tree.map(lambda a: a + 0.5, st["m"]),
          "v": jax.tree.map(lambda a: a + 0.25, st["v"]),
          "count": jnp.int32(7)}
    jC.save(str(d / "jax_ckpt"), 7, (jp, st))
    want["jax_ckpt"] = (jp, st)
    return inputs, want


_RUNS: dict = {}


def _run(p, tmp_path_factory):
    if p not in _RUNS:
        d = tmp_path_factory.mktemp(f"members{p}")
        inputs, want = _inputs(p, d)
        outs = run_members(ROOT / "tests" / "_torch_members_worker.py", p,
                           inputs, d, timeout=600)
        _RUNS[p] = (p, d, inputs, want, outs)
    return _RUNS[p]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def members(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def members2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def members4(tmp_path_factory):
    return _run(4, tmp_path_factory)


def test_shard_then_gather_gives_the_tree_back(members):
    p, _, _, _, outs = members
    for o in outs:
        for case in W.CASES:
            assert bool(o[f"{case}/roundtrip"]), case
            assert int(o[f"{case}/n_cut"]) > 0, case


@pytest.mark.parametrize("case", list(W.CASES))
def test_forward_over_members_matches_the_reference(members, case):
    _, _, _, want, outs = members
    for o in outs:
        np.testing.assert_allclose(o[f"{case}/logits"], want[case]["logits"],
                                   **FORWARD_TOL)


@pytest.mark.parametrize("case", [c for c in W.CASES if c != "llava"])
def test_prefill_and_decode_over_members_match_the_reference(members, case):
    p, _, _, want, outs = members
    for o in outs:
        np.testing.assert_allclose(o[f"{case}/prefill"],
                                   want[case]["prefill"], **MODEL_TOL)
        if case.endswith("a2a"):
            # decode has S = 1: the a2a exchange cannot split it
            assert bool(o[f"{case}/decode_raised"])
            msg = str(o[f"{case}/decode_error"])
            assert "S = 1" in msg and f"P = {p}" in msg
            continue
        assert not bool(o[f"{case}/decode_raised"])
        for t in range(W.DECODE):
            np.testing.assert_allclose(o[f"{case}/decode{t}"],
                                       want[case][f"decode{t}"], **MODEL_TOL)
        np.testing.assert_array_equal(o[f"{case}/tokens"],
                                      want[case]["tokens"])


@pytest.mark.parametrize("case", [c for c in W.CASES
                                  if c not in ("llava", "qwen2moe_a2a")])
def test_gradients_over_members_match_jax_grad(members, case):
    """The tensor-parallel backward through the differentiable collectives:
    every leaf's gradient, gathered, within GRAD_TOL of ``jax.grad`` and
    finite and non-zero (a collective that cut the graph would leave a
    partial or zero gradient)."""
    _, _, _, want, outs = members
    w = want[case]
    grads = {}
    _flat("g", w["grad"], grads)
    for o in outs:
        np.testing.assert_allclose(o[f"{case}/loss"], np.asarray(w["loss"]),
                                   **STEP_TOL)
        for k, g in grads.items():
            got = o[f"{case}/grad/{k[2:]}"]
            assert np.isfinite(got).all() and np.abs(got).max() > 0, k
            np.testing.assert_allclose(got, g, err_msg=k, **GRAD_TOL)


def _port_step(case, batch, accum=1):
    cfg = W.config(case)
    data = {}
    jp = japi.init(jax.random.PRNGKey(list(W.CASES).index(case)),
                   jconfig(case), n_shards=W.N_SHARDS)
    _flat(case, jp, data)
    params = W.nested(data, case)
    state = topt.adamw_init(params)
    step = tsteps.make_train_step(cfg, accum_steps=accum)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return step(params, state, tb)[2]


@pytest.mark.parametrize("name,case,accum", [
    ("tp_qwen3", "qwen3", 1), ("dp_qwen3", "qwen3", 1),
    ("tp_qwen2moe", "qwen2moe", 1),
    # data members route their own rows: the one-device twin accumulates
    # two microbatches (the same capacity a member's rows get)
    ("dp_qwen2moe", "qwen2moe", 2)])
def test_train_steps_over_members_match_one_device(members2, name, case,
                                                   accum):
    _, _, inputs, _, outs = members2
    batch = {k: inputs[f"train/{k}"] for k in ("tokens", "labels")}
    want = _port_step(case, batch, accum)
    for o in outs:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(o[f"train/{name}/{k}"],
                                       want[k].numpy(), err_msg=k,
                                       **STEP_TOL)


# ---------------------------------------------------------------------------
# the reference on its own mesh (a subprocess with 4 host devices)
# ---------------------------------------------------------------------------

MESH_RUN = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import base as cb
from repro.configs.base import ShapeConfig
from repro.launch import specs
from repro.launch.mesh import make_host_mesh
from repro.models import api
from repro.runtime import elastic
from repro.sharding import partition
from repro.train import grad_compression as GC

d = sys.argv[1]
data = dict(np.load(d + "/inputs.npz"))
out = {}
# chatglm3 (Kh 2) at P = 4 under its rules
cfg = cb.get_arch("chatglm3-6b").smoke()
flat = {k.split("/", 1)[1]: v for k, v in data.items()
        if k.startswith("chatglm3/")}
params = {}
for k, v in flat.items():
    node = params
    *head, last = k.split("/")
    for h in head:
        node = node.setdefault(h, {})
    node[last] = jnp.asarray(v)
mesh = make_host_mesh(model=4)
rules = specs.arch_rules(cfg, mesh, ShapeConfig("t", "prefill", 16, 2))
with partition.axis_rules(mesh, rules):
    sh = partition.tree_shardings(api.specs(cfg))
    params = jax.device_put(params, sh)
    logits, _ = jax.jit(lambda p, t: api.forward(p, cfg, {"tokens": t},
                                                 remat=False))(
        params, jnp.asarray(data["prompts"]))
out["chatglm3/logits"] = np.asarray(logits)
# compressed_psum inside a shard_map over 4 devices
m4 = compat.make_mesh((4,), ("d",))
f = compat.shard_map(lambda x: GC.compressed_psum(x[0], "d")[None],
                     mesh=m4, in_specs=P("d", None), out_specs=P("d", None),
                     check_vma=False)
out["psum"] = np.asarray(f(jnp.asarray(data["psum/x"])))
# make_mesh_from over the first n devices
for n in range(1, 5):
    for model in (0, 1, 2, 4):
        m = elastic.make_mesh_from(jax.devices()[:n], model)
        out[f"mesh/{n}/{model}"] = np.array(
            [[dv.id for dv in row] for row in np.asarray(m.devices)])
np.savez(d + "/mesh.npz", **out)
"""


@pytest.fixture(scope="module")
def mesh_run(members4):
    _, d, _, _, _ = members4
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", MESH_RUN, str(d)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(d / "mesh.npz"))


def test_forward_over_members_matches_the_reference_on_its_mesh(members4,
                                                                mesh_run):
    """chatglm3 (2 KV heads) at P = 4: the reference cuts inside a KV head
    under GSPMD; the port keeps the KV heads whole and selects."""
    for o in members4[4]:
        np.testing.assert_allclose(o["chatglm3/logits"],
                                   mesh_run["chatglm3/logits"], **FORWARD_TOL)


def test_compressed_psum_matches_the_reference_bit_for_bit(members4,
                                                           mesh_run):
    for r, o in enumerate(members4[4]):
        np.testing.assert_array_equal(o["psum"], mesh_run["psum"][r])


def test_make_mesh_from_matches_the_reference(mesh_run):
    for n in range(1, 5):
        for model in (0, 1, 2, 4):
            m = telastic.make_mesh_from(range(n), model)
            want = mesh_run[f"mesh/{n}/{model}"]
            assert (m.shape["data"], m.shape["model"]) == want.shape
            assert list(m.ranks) == want.reshape(-1).tolist()


# ---------------------------------------------------------------------------
# checkpoints across packages and meshes, and elastic recovery
# ---------------------------------------------------------------------------


def _like_ref(inputs, case):
    jcfg = jconfig(case)
    jp = japi.init(jax.random.PRNGKey(0), jcfg, n_shards=W.N_SHARDS)
    return (jp, jopt.adamw_init(jp))


@pytest.mark.parametrize("sub", ["port_ckpt", "port_async"])
def test_a_checkpoint_over_members_restores_in_the_reference(members2, sub):
    """A (params, AdamW state) tree laid out over 2 members, saved (the
    members' blocks gathered, the first rank writing), reads back in the
    reference as the whole tree."""
    _, d, inputs, _, _ = members2
    (jp, st), step = jC.restore(str(d / sub), _like_ref(inputs, "qwen3"))
    assert step == 3
    got = {}
    _flat("qwen3", jp, got)
    for k, v in got.items():
        np.testing.assert_array_equal(v, inputs[k], err_msg=k)
    for leaf in jax.tree.leaves(st):
        assert not np.asarray(leaf).any()


def test_a_reference_checkpoint_restores_onto_members(members2):
    _, _, _, want, outs = members2
    jp, st = want["jax_ckpt"]
    ref = {}
    _flat("ckpt/restored", jp, ref)
    for o in outs:
        assert int(o["ckpt/step"]) == 7
        for k, v in ref.items():
            np.testing.assert_array_equal(o[k], v, err_msg=k)


def test_elastic_recovery_matches_an_uninterrupted_run(members4):
    """Data-parallel over 4 ranks; ranks 2 and 3 drop at step FAIL_AT; the
    survivors rebuild a (1, 2) mesh, restore the step-4 checkpoint
    tensor-parallel and replay: every step's loss and the final parameters
    as one device's uninterrupted run."""
    _, _, inputs, _, outs = members4
    assert [bool(o["elastic/evicted"]) for o in outs] == \
        [False, False, True, True]
    cfg = W.config("qwen3")
    params = W.nested(inputs, "qwen3")
    state = topt.adamw_init(params)
    step = tsteps.make_train_step(cfg)
    losses = []
    for i in range(W.ELASTIC_STEPS):
        b = {k: torch.from_numpy(inputs[f"elastic/{i}/{k}"])
             for k in ("tokens", "labels")}
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    want = {}
    W.flat("elastic/params", params, want)
    for o in outs[:2]:
        assert int(o["elastic/recoveries"]) == 1
        assert o["elastic/mesh"].tolist() == [1, 2]
        np.testing.assert_allclose(o["elastic/losses"], losses, **STEP_TOL)
        for k, v in want.items():
            np.testing.assert_allclose(o[k], v, err_msg=k, **ELASTIC_TOL)
