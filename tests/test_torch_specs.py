"""The port's dry-run cells (``repro_torch/launch/specs.py``) against the
reference's ``repro/launch/specs.py``, at full size and without values:
input stand-ins, cells and skip reasons, parameter shapes (the port's
``init`` on the meta device) in f32 and bf16, the AdamW state and its
specs, a decode cache, and each member's parameter bytes on the (16, 16)
production mesh (JAX over 256 forced host devices, the port on a fake
process group, both in one subprocess: ``_per_member_bytes.py`` below).
"""
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
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch.configs import base as tcb
from repro_torch.launch import specs as tspecs
from repro_torch.models import api as tapi
from repro_torch.train import optimizer as topt

ARCHS = tcb.list_archs()
LM_ARCHS = [a for a in ARCHS if not a.startswith("dlrm")]
CELLS = [(a, s.name) for a in ARCHS for s in tcb.get_arch(a).shapes]
SRC = Path(__file__).resolve().parents[1] / "src"


def _flat(tree, pre=""):
    """{path: (shape, dtype name)} of a torch tree (meta tensors or ints)."""
    out = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(_flat(tree[k], f"{pre}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{pre}/{i}"))
    elif isinstance(tree, torch.Tensor):
        out[pre] = (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    return out


def _jflat(tree):
    """{path: (shape, dtype name)} of a JAX tree of shape structs."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "".join(f"/{getattr(p, 'key', getattr(p, 'idx', p))}"
                      for p in path)
        out[key] = (tuple(v.shape), str(v.dtype))
    return out


def _configs(arch):
    return jcb.get_arch(arch).config, tcb.get_arch(arch).config


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    jcfg, tcfg = _configs(arch)
    jshape = next(s for s in jcb.get_arch(arch).shapes if s.name == shape)
    tshape = next(s for s in tcb.get_arch(arch).shapes if s.name == shape)
    assert _flat(tspecs.input_specs(tcfg, tshape)) == \
        _jflat(jspecs.input_specs(jcfg, jshape))
    for x in tspecs.input_specs(tcfg, tshape).values():
        assert x.device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_for_match_the_reference(arch):
    got = [(s.name, s.kind, s.seq_len, s.global_batch, why)
           for s, why in tspecs.cells_for(arch)]
    want = [(s.name, s.kind, s.seq_len, s.global_batch, why)
            for s, why in jspecs.cells_for(arch)]
    assert got == want


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_the_reference_at_full_size(arch, dtype):
    jcfg, tcfg = _configs(arch)
    got = tspecs.param_shapes(
        tcfg, dtype=None if dtype is None else torch.bfloat16)
    want = jspecs.param_shapes(
        jcfg, dtype=None if dtype is None else jnp.bfloat16)
    assert _flat(got) == _jflat(want)
    assert all(t.device.type == "meta" for t in topt.leaves(got))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_adamw_state_and_specs_match_the_reference(arch):
    jcfg, tcfg = _configs(arch)
    got = topt.adamw_init(tspecs.param_shapes(tcfg))
    want = jax.eval_shape(jopt.adamw_init, jspecs.param_shapes(jcfg))
    assert _flat(got) == _jflat(want)
    assert topt.adamw_specs(tapi.specs(tcfg)) == \
        jopt.adamw_specs(japi.specs(jcfg))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_cache_matches_the_reference(arch):
    """The decode_32k cache (128 rows, 32768 positions, bf16); the port's
    ``pos`` is a host int, the reference's an int32 scalar."""
    jcfg, tcfg = _configs(arch)
    got = tapi.make_cache(tcfg, 128, 32_768, dtype="bfloat16", device="meta")
    want = jax.eval_shape(
        lambda: japi.make_cache(jcfg, 128, 32_768, dtype=jnp.bfloat16))
    want = _jflat(want)
    assert want.pop("/pos") == ((), "int32")
    assert got["pos"] == 0
    assert _flat(got) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_allocates_nothing(arch):
    _, tcfg = _configs(arch)
    tree = tspecs.param_shapes(tcfg)
    assert all(t.device.type == "meta" for t in topt.leaves(tree))
    assert tspecs.nbytes(tree) > 0


# ---------------------------------------------------------------------------
# a member's parameter bytes on the (16, 16) production mesh
# ---------------------------------------------------------------------------

_PER_MEMBER = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import base as jcb
    from repro.launch import specs as jspecs
    from repro.launch.mesh import make_production_mesh as jmesh
    from repro_torch.launch import dryrun, specs as tspecs

    cells, cache_cells = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    jm = jmesh()
    out = {}
    from repro.models import api as japi
    for arch, shape in cache_cells:
        cfg = jcb.get_arch(arch).config
        sh = next(s for s in jcb.get_arch(arch).shapes if s.name == shape)
        rules = jspecs.arch_rules(cfg, jm, sh)
        shard = jspecs.tree_shardings(japi.cache_specs(cfg), jm, rules)
        whole = jax.eval_shape(lambda: japi.make_cache(
            cfg, sh.global_batch, sh.seq_len, dtype=jnp.bfloat16))
        blocks = {}
        for (path, c), s in zip(jax.tree_util.tree_flatten_with_path(
                whole)[0], jax.tree.leaves(shard)):
            if c.ndim:
                blocks["/".join(str(getattr(k, "key", k)) for k in path)] = \
                    list(s.shard_shape(c.shape))
        out[f"cache:{arch}/{shape}"] = {"jax": blocks}
    for arch, shape in cells:
        cfg = jcb.get_arch(arch).config
        sh = next(s for s in jcb.get_arch(arch).shapes if s.name == shape)
        rules = jspecs.arch_rules(cfg, jm, sh)
        shard = jspecs.tree_shardings(jspecs.param_spec_tree(cfg), jm, rules)
        # a train cell holds the f32 masters, a serve cell bf16 leaves
        ps = jspecs.param_shapes(
            cfg, dtype=None if sh.kind == "train" else jnp.bfloat16)
        leaves = {}
        for (path, p), s in zip(jax.tree_util.tree_flatten_with_path(ps)[0],
                                jax.tree.leaves(shard)):
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            leaves[key] = int(np.prod(s.shard_shape(p.shape))) * \\
                p.dtype.itemsize
        out[f"{arch}/{shape}"] = {"jax": leaves}
    with dryrun.production_mesh(False) as mesh:
        for arch, shape in cells:
            cell = tspecs.build_cell(arch, shape, mesh)
            port = {}

            def walk(t, path):
                if isinstance(t, dict):
                    for k in t:
                        walk(t[k], path + [k])
                else:
                    port["/".join(path)] = t.numel() * t.element_size()
            walk(cell.args[0], [])
            out[f"{arch}/{shape}"].update(
                port=port, replicated=dryrun.replicated_leaves(cell))
        for arch, shape in cache_cells:
            cell = tspecs.build_cell(arch, shape, mesh)
            out[f"cache:{arch}/{shape}"]["port"] = {
                k: list(v.shape) for k, v in cell.args[2].items()
                if hasattr(v, "shape")}
    print(json.dumps(out))
''')

SERVE_CELLS = [(a, s) for a, s in CELLS
               if a in LM_ARCHS and s in ("prefill_32k", "decode_32k",
                                          "train_4k")]


# every cell with a KV cache or a recurrent state that the arch runs
CACHE_CELLS = [(a, s) for a, s in CELLS if a in LM_ARCHS
               and s in ("decode_32k", "long_500k")
               and not tcb.get_arch(a).skips.get(s)]


@pytest.fixture(scope="module", autouse=True)
def per_member_started():
    """The per-member subprocess, started with the module's first test so
    that it runs beside the full-size shape tests."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _PER_MEMBER,
                             json.dumps(SERVE_CELLS),
                             json.dumps(CACHE_CELLS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def per_member(per_member_started):
    out, err = per_member_started.communicate(timeout=300)
    assert per_member_started.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_member_param_bytes_match_the_reference(per_member, arch, shape):
    """A member's block of every parameter equals JAX's
    ``NamedSharding.shard_shape`` under the same rules, but for the leaves
    the port keeps whole (or less cut), whose excess is the cell's
    ``replicated_leaves``, exactly.  A train cell is cut over ``data`` as
    the reference's (FSDP): its ``replicated_leaves`` are the leaves the
    port keeps whole over ``model``, those of the arch's prefill cell."""
    rec = per_member[f"{arch}/{shape}"]
    assert set(rec["port"]) == set(rec["jax"])
    extra = {k: rec["port"][k] - rec["jax"][k] for k in rec["port"]
             if rec["port"][k] != rec["jax"][k]}
    assert extra == rec["replicated"], (
        f"{arch}/{shape}: leaves the port holds beyond the reference's "
        f"rules: {sorted(extra)}")
    if shape == "train_4k" and f"{arch}/prefill_32k" in per_member:
        assert set(extra) == set(
            per_member[f"{arch}/prefill_32k"]["replicated"])
    if arch == "qwen3-14b":    # 40 query heads over 8 KV heads at model 16
        assert {k.split("/")[-2] for k in extra} == {"wq", "wk", "wv", "wo"}


@pytest.mark.parametrize("arch,shape", CACHE_CELLS)
def test_member_cache_blocks_match_the_reference(per_member, arch, shape):
    """A member's block of every cache leaf equals JAX's
    ``NamedSharding.shard_shape`` of the reference's ``cache_specs`` under
    ``arch_rules``, exactly: under ``kv_seq`` a KV cache holds a block of
    positions for every KV head (qwen3-14b's decode_32k cache 1/16 of its
    rows' whole cache).  zamba2's conv state alone differs: the port cuts
    its channels x | B | C segment by segment (x by heads, B and C whole),
    where the reference's one "heads" axis cuts them as one block."""
    rec = per_member[f"cache:{arch}/{shape}"]
    assert set(rec["port"]) == set(rec["jax"])
    for k, want in rec["jax"].items():
        got = rec["port"][k]
        if arch == "zamba2-2.7b" and k == "conv":
            cfg = tcb.get_arch(arch).config
            d_inner = cfg.ssm.expand * cfg.d_model
            assert got[:-1] == want[:-1]
            assert got[-1] == d_inner // 16 + 2 * cfg.ssm.d_state
            continue
        assert got == want, (k, got, want)
    if (arch, shape) == ("qwen3-14b", "decode_32k"):
        cfg = tcb.get_arch(arch).config
        rows = 128 // 16
        assert rec["port"]["k"] == [cfg.n_layers, 1, rows, 32_768 // 16,
                                    cfg.n_kv_heads, cfg.head_dim]
