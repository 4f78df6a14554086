"""The port's dry-run cells run for real on the CPU against the reference's,
and the dry run itself on a fake (16, 16) process group.

The whole slice against JAX: a smoke config is registered in both
registries with tiny shapes (popped after the test); the reference's
``build_cell(...).fn``, jitted on the one-device host mesh, and the port's
``cell.fn`` take the same f32 parameters (drawn by the port's ``init``,
which is quick on the CPU, and carried into the reference's tree leaf for
leaf) and the same seeded batch: prefill logits at 1e-4, a decode step's tokens exactly, DLRM CTRs
at 1e-5, a train step's loss at 1e-3.  The smoke configs compute in f32;
a serving cell's stand-ins hold bf16 leaves, whose products the two
frameworks round in other orders, so both sides take the f32 leaves, and
a decode step an f32 cache of the cell's shape (the reference's decode
writes the cache in the compute type).

The dry run (``launch/dryrun.py``) runs in a subprocess on a fake group of
256 ranks: four cells' records, then the CLI over a record file it must
resume.
"""
import contextlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.launch import specs as jspecs
from repro.launch.mesh import make_host_mesh as jhost_mesh
from repro.sharding import partition as jpart
from repro.train import optimizer as jopt
from repro_torch.configs import base as tcb
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_host_mesh as thost_mesh
from repro_torch.models import api as tapi
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import transformer as tT
from repro_torch.sharding import partition as tpart
from repro_torch.train import optimizer as topt

SRC = Path(__file__).resolve().parents[1] / "src"
LOGIT_TOL = {"rtol": 1e-4, "atol": 1e-4}
CTR_TOL = {"rtol": 1e-5, "atol": 1e-5}
LOSS_TOL = {"rtol": 1e-3, "atol": 1e-3}
# one arch a family: dense, MoE, ssm, hybrid, audio
FAMILY_ARCHS = ("qwen3-14b", "qwen2-moe-a2.7b", "rwkv6-1.6b", "zamba2-2.7b",
                "whisper-tiny")
KINDS = ("train", "prefill", "decode")


def _tiny_shapes(cb):
    return (cb.ShapeConfig("t_train", "train", 32, 4),
            cb.ShapeConfig("t_prefill", "prefill", 32, 2),
            cb.ShapeConfig("t_decode", "decode", 32, 2))


def _tiny_dlrm_shape(cb):
    # 16 microbatches of the BLS stream, 4 rows each
    return (cb.ShapeConfig("t_infer", "decode", 1, 64),)


@contextlib.contextmanager
def registered(arch, shapes_of):
    """The smoke config of ``arch`` registered in both registries, under its
    own name, with the tiny shapes; popped on exit."""
    jcfg = jcb.get_arch(arch).smoke()
    tcfg = tcb.get_arch(arch).smoke()
    assert jcfg.name == tcfg.name
    jcb.register(jcb.ArchSpec(config=jcfg, smoke=lambda: jcfg,
                              shapes=shapes_of(jcb)))
    tcb.register(tcb.ArchSpec(config=tcfg, smoke=lambda: tcfg,
                              shapes=shapes_of(tcb)))
    try:
        yield jcfg, tcfg
    finally:
        jcb._REGISTRY.pop(jcfg.name)
        tcb._REGISTRY.pop(tcfg.name)


def _batch(stand_ins, vocab, rng, idx_max=None):
    """Seeded numpy values for a dict of stand-ins: ids below ``vocab`` (or
    ``idx_max`` for DLRM ids), unit normals, and ones for DLRM masks."""
    out = {}
    for k, v in stand_ins.items():
        shape = tuple(v.shape)
        if k == "mask":
            out[k] = np.ones(shape, np.float32)
        elif k == "labels" and idx_max is not None:
            out[k] = rng.integers(0, 2, shape).astype(np.float32)
        elif "int" in str(v.dtype):
            out[k] = rng.integers(0, idx_max or vocab, shape).astype(np.int32)
        else:
            out[k] = rng.standard_normal(shape).astype(np.float32)
    return out


def _to_torch(tree, like):
    """The numpy tree as torch tensors, each of its stand-in's shape."""
    if isinstance(tree, dict):
        return {k: _to_torch(tree[k], like[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(a, b) for a, b in zip(tree, like))
    assert tuple(tree.shape) == tuple(like.shape)
    return torch.from_numpy(np.array(tree, copy=True))


def _to_numpy(tree, like):
    """The port's torch tree as numpy arrays in the reference's tree
    ``like``, each leaf of its stand-in's shape."""
    if isinstance(like, dict):
        assert set(tree) == set(like)
        return {k: _to_numpy(tree[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        assert len(tree) == len(like)
        return type(like)(_to_numpy(a, b) for a, b in zip(tree, like))
    assert tuple(tree.shape) == tuple(like.shape)
    return tree.detach().numpy().copy()


def _params(tcfg, like, seed=0):
    """f32 parameters from the port's ``init`` in the reference's tree."""
    if isinstance(tcfg, tcb.DLRMConfig):
        p = tdlrm.init_dlrm(seed, tcfg, n_shards=16, device="cpu")
    else:
        p = tapi.init(seed, tcfg, "cpu", n_shards=16, dtype="float32")
    return _to_numpy(p, like)


def _run_both(arch, kind, jcfg, tcfg):
    jmesh, tmesh = jhost_mesh(), thost_mesh()
    shape = f"t_{kind}"
    jcell = jspecs.build_cell(jcfg.name, shape, jmesh)
    tcell = tspecs.build_cell(tcfg.name, shape, tmesh)
    rng = np.random.default_rng(0)
    is_dlrm = isinstance(jcfg, jcb.DLRMConfig)
    vocab = None if is_dlrm else jcfg.vocab_size
    idx_max = min(jcfg.table_sizes) if is_dlrm else None
    batch = _batch(tspecs.input_specs(tcfg, tcell.shape), vocab, rng,
                   idx_max)
    jp = _params(tcfg, jcell.args[0])
    jargs = [jax.tree.map(jnp.asarray, jp)]
    targs = [_to_torch(jp, tcell.args[0])]
    if kind == "train":
        jargs.append(jax.tree.map(jnp.asarray,
                                  jopt.adamw_init(jargs[0])))
        targs.append(topt.adamw_init(targs[0]))
    if kind == "decode" and not is_dlrm:
        jargs += [jnp.asarray(batch["tokens"]), jax.tree.map(
            lambda s: jnp.zeros(s.shape, jnp.float32 if s.ndim else s.dtype),
            jcell.args[2])]
        cache = tT._map(lambda t: torch.zeros(t.shape)
                        if isinstance(t, torch.Tensor) else t, tcell.args[2])
        targs += [torch.from_numpy(batch["tokens"]), cache]
    else:
        jargs.append({k: jnp.asarray(v) for k, v in batch.items()})
        targs.append({k: torch.from_numpy(v) for k, v in batch.items()})
    with jpart.axis_rules(jmesh, jcell.rules):
        want = jax.jit(jcell.fn)(*jargs)
    with tpart.axis_rules(tmesh, tcell.rules):
        got = tcell.fn(*targs)
    return got, want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cell_fn_matches_the_reference(arch, kind):
    with registered(arch, _tiny_shapes) as (jcfg, tcfg):
        got, want = _run_both(arch, kind, jcfg, tcfg)
    if kind == "prefill":
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **LOGIT_TOL)
    elif kind == "decode":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert got[1]["pos"] == int(want[1]["pos"]) == 1
    else:
        np.testing.assert_allclose(float(got[2]["loss"]),
                                   float(want[2]["loss"]), **LOSS_TOL)


def test_dlrm_serve_cell_matches_the_reference():
    with registered("dlrm-kaggle", _tiny_dlrm_shape) as (jcfg, tcfg):
        got, want = _run_both("dlrm-kaggle", "infer", jcfg, tcfg)
    assert got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CTR_TOL)


def test_dlrm_train_cell_builds():
    cell = tspecs.build_cell("dlrm-kaggle", "dlrm_train", thost_mesh())
    assert cell.in_place == (0, 1)
    assert set(cell.args[2]) == {"dense", "idx", "mask", "labels"}
    assert tspecs.nbytes(cell.args[1]["m"]) == tspecs.nbytes(cell.args[0])


# ---------------------------------------------------------------------------
# the dry run on a fake (16, 16) group
# ---------------------------------------------------------------------------

RUN_CELLS = [("whisper-tiny", "train_4k"), ("rwkv6-1.6b", "decode_32k"),
             ("qwen2-moe-a2.7b", "decode_32k"), ("dlrm-kaggle", "dlrm_infer"),
             ("whisper-tiny", "prefill_32k"), ("whisper-tiny", "decode_32k"),
             ("dlrm-kaggle", "dlrm_train")]
KEYS = {"arch", "shape", "mesh", "status", "trace_s", "memory", "flops",
        "collective_bytes", "per_collective", "replicated_param_bytes",
        "replicated_leaves", "global_batch", "seq_len"}

_RUN = textwrap.dedent('''
    import json, os, subprocess, sys
    import torch
    from repro_torch.configs.base import DLRMConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer as opt

    def block_bytes(mesh, spec, t):
        # a member's block of the whole stand-in t: each dimension over the
        # blocks its entry names (a fused leaf's cut segments only)
        n_el = 1
        for d, e in enumerate(spec):
            if isinstance(e, partition.Segments):
                n_el *= sum(e.local(mesh.shape[e.axis]))
            else:
                n_el *= t.shape[d] // partition.block(mesh, e)[0]
        return n_el * t.element_size()

    def whole_args(cell):
        cfg, shape = cell.cfg, cell.shape
        batch = specs.input_specs(cfg, shape)
        if isinstance(cfg, DLRMConfig):
            p = specs.param_shapes(cfg, dtype=torch.float32)
            if shape.kind == "train":
                return p, opt.adamw_init(p), batch
            return p, batch
        if shape.kind == "train":
            p = specs.param_shapes(cfg)
            return p, opt.adamw_init(p), batch
        p = specs.param_shapes(cfg, dtype=torch.bfloat16)
        if shape.kind == "prefill":
            return p, batch
        return p, batch["tokens"], None

    cells, out = json.loads(sys.argv[1]), sys.argv[2]
    recs, expect = [], {}
    with dryrun.production_mesh(False) as mesh:
        for arch, shape in cells:
            recs.append(dryrun.run_cell(arch, shape, mesh, False))
            cell = specs.build_cell(arch, shape, mesh)
            total = 0
            for i, (whole, lay) in enumerate(zip(whole_args(cell),
                                                 cell.layouts)):
                if lay is None:   # the cache: make_cache's, per member
                    total += specs.nbytes(cell.args[i])
                    continue
                total += sum(opt.leaves(partition.map_specs(
                    lambda _, spec, t: block_bytes(mesh, spec, t),
                    lay.specs, whole)))
            expect[f"{arch}/{shape}"] = total
    with open(out, "w") as f:
        json.dump(recs, f)
    # the CLI over the same file: whisper's three cells are done, its
    # long_500k cell is skipped with the reference's reason
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", "whisper-tiny", "--out",
                          os.path.dirname(out)], capture_output=True,
                         text=True, timeout=600)
    print(json.dumps({"recs": recs, "expect": expect, "cli_rc": cli.returncode,
                      "cli_out": cli.stdout, "cli_err": cli.stderr[-4000:]}))
''')


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def dry_started(tmp_path_factory):
    """The dry run's subprocess (four cells' records, then the CLI over
    the record file), started with the module's first test so that it
    runs beside the parity tests."""
    d = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.Popen([sys.executable, "-c", _RUN,
                             json.dumps(RUN_CELLS),
                             str(d / "dryrun_16x16.json")], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        yield d, proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def dry(dry_started):
    d, proc = dry_started
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["cli_rc"] == 0, res["cli_err"]
    path = d / "dryrun_16x16.json"
    return (res["recs"], res["expect"], res["cli_out"],
            json.loads(path.read_text()))


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in RUN_CELLS[:4]])
def test_run_cell_records(dry, cell):
    recs, expect, _, _ = dry
    rec = next(r for r in recs if f"{r['arch']}/{r['shape']}" == cell)
    assert rec["status"] == "ok"
    assert set(rec) == KEYS
    assert rec["mesh"] == "16x16"
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == expect[cell]
    assert mem["output_size_in_bytes"] > 0 and rec["flops"] > 0
    if not cell.startswith("whisper"):
        assert rec["collective_bytes"] > 0     # cut over the model axis


def test_dlrm_record_holds_the_member_tables(dry):
    recs, _, _, _ = dry
    rec = next(r for r in recs if r["arch"] == "dlrm-kaggle"
               and r["shape"] == "dlrm_infer")
    cfg = tcb.get_arch("dlrm-kaggle").config
    stats = tdlrm.table_stats(cfg)
    # a member's 2 of 32 padded tables, the MLPs whole, 8192 rows
    tables = stats["bytes"] // 16
    rows = 131_072 // 16
    t_pad = stats["t_pad"]
    batch = rows * (cfg.n_dense_features + 2 * t_pad) * 4
    mlp = rec["memory"]["argument_size_in_bytes"] - tables - batch
    dims = [cfg.n_dense_features, *cfg.bottom_mlp]
    n_feat = cfg.n_tables + 1
    top = [n_feat * (n_feat - 1) // 2 + cfg.embed_dim, *cfg.top_mlp]
    want = sum((a + 1) * b for d in (dims, top) for a, b in zip(d, d[1:]))
    assert mlp == 4 * want
    assert rec["replicated_param_bytes"] == 0


def test_dlrm_train_record_holds_the_member_state(dry):
    """The train cell's record on (16, 16): a member's 2 of 32 tables and
    the MLPs in f32, AdamW's m and v of the same, its step count, and the
    member's 8192 rows with their labels; the step issues the exchange,
    its backward and the data all-reduces."""
    recs, expect, _, _ = dry
    rec = next(r for r in recs if r["arch"] == "dlrm-kaggle"
               and r["shape"] == "dlrm_train")
    assert rec["status"] == "ok" and set(rec) == KEYS
    cfg = tcb.get_arch("dlrm-kaggle").config
    stats = tdlrm.table_stats(cfg)
    dims = [cfg.n_dense_features, *cfg.bottom_mlp]
    n_feat = cfg.n_tables + 1
    top = [n_feat * (n_feat - 1) // 2 + cfg.embed_dim, *cfg.top_mlp]
    mlp = 4 * sum((a + 1) * b for d in (dims, top) for a, b in zip(d, d[1:]))
    params = stats["bytes"] // 16 + mlp
    rows = 131_072 // 16
    batch = rows * (cfg.n_dense_features + 2 * stats["t_pad"] + 1) * 4
    want = 3 * params + 4 + batch
    assert rec["memory"]["argument_size_in_bytes"] == want == \
        expect["dlrm-kaggle/dlrm_train"]
    assert rec["memory"]["alias_size_in_bytes"] == 3 * params + 4
    assert rec["replicated_param_bytes"] == 0
    assert {"alltoall_base_", "allreduce_"} <= set(rec["per_collective"])


def test_cli_resumes_and_keeps_skip_reasons(dry):
    _, _, out, final = dry
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert f"[skip-done] whisper-tiny/{shape} @ 16x16" in out
    skipped = [r for r in final if r["status"] == "skipped"]
    assert [(r["arch"], r["shape"], r["reason"]) for r in skipped] == [
        ("whisper-tiny", "long_500k",
         jcb.get_arch("whisper-tiny").skips["long_500k"])]
    assert len(final) == len(RUN_CELLS) + 1
