"""The port's MoE family (configs, ``models/moe.py``, the transformer's MoE
FFN, ``LMEngine``) against the JAX reference on the same inputs, on the
CPU.

Parameters come from the reference's ``init_moe`` / ``api.init`` and cross
over as numpy, so no RNG has to match.  Held:

- config copies exactly; ``capacity`` and ``dispatch_indices`` bit for bit
  (out-of-range expert ids included), ``route``'s expert ids exactly (ties
  included) and its weights and probabilities at 1e-6;
- ``_moe_local`` / ``moe_gather`` at capacity factors 1.0 and 1.25 (slots
  dropped) and 8.0 (none) at f32 1e-5, ``moe_ref_dense`` and the aux loss
  at 1e-6;
- the qwen2-moe and granite-moe smoke models: forward logits and aux,
  prefill and 8 decode steps at f32 rtol = atol = 1e-4 (as
  ``test_torch_lm.py``), a bf16 forward within the relative Frobenius
  error of ``test_torch_rwkv6.py`` (rows of near-tie routings left out),
  and ``LMEngine`` tokens equal to the reference engine's;
- on 2 and 4 gloo members (``_torch_moe_worker.py``, one run per P):
  ``moe_gather(group)`` and ``moe_a2a(group)`` within 1e-4 of JAX
  ``moe_ref_dense`` at capacity factor 8, within 1e-5 of the reference's
  own ``moe_gather`` / ``moe_a2a`` on a P-device ``("model",)`` mesh at
  1.0, where slots drop and the drop pattern depends on the sharding; the
  a2a stages under ``bls_pipeline`` at bounds 0, 1, 2 bit-identical to
  ``reference_loop``, which is within 1e-4 of the dense oracle.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import run_members
from _torch_moe_worker import BLS_CFG, BOUNDS, COUNTED, FACTORS, FFN_CFG
from repro.configs import granite_moe_3b_a800m as jgranite
from repro.configs import qwen2_moe_a2_7b as jqwen2
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import api as japi
from repro.models import moe as jM
from repro.models import transformer as jT
from repro.serving import engine as jengine
from repro_torch.configs import base as tbase
from repro_torch.configs import granite_moe_3b_a800m as tgranite
from repro_torch.configs import qwen2_moe_a2_7b as tqwen2
from repro_torch.configs.base import MoEConfig
from repro_torch.launch import mesh
from repro_torch.models import api as tapi
from repro_torch.models import moe as tM
from repro_torch.models import transformer as tT
from repro_torch.serving.engine import LMEngine

ROOT = Path(__file__).resolve().parents[1]
LAYER_TOL = {"rtol": 1e-6, "atol": 1e-6}
FFN_TOL = {"rtol": 1e-5, "atol": 1e-5}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
# bf16 logits: the relative Frobenius error of tests/test_torch_rwkv6.py,
# and each element within 2^-5 of the largest |logit| (a few bf16 ulps of
# the largest logits: 8 significant bits, rounded at every layer)
BF16_REL = 1.25e-2
BF16_SCALE = 2 ** -5
ARCHS = {"qwen2_moe": (jqwen2, tqwen2), "granite_moe": (jgranite, tgranite)}
# the smoke models' routed experts padded to 8 (phantoms in both)
N_SHARDS = 4


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, dtype=np.float32), **tol)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t_tree(np_tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), np_tree)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def jax_config(cfg, **moe_kw):
    """The reference's twin of a port ``ModelConfig`` with an MoE."""
    fields = dataclasses.asdict(cfg)
    moe = JMoEConfig(**{**fields.pop("moe"), **moe_kw})
    return JModelConfig(**fields, moe=moe)


def port_config(cfg, **moe_kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
def test_config_copies_match_the_reference(arch, which):
    j, t = (getattr(m, which) for m in ARCHS[arch])
    j, t = (j() if callable(j) else j), (t() if callable(t) else t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_registry_resolves_the_moe_archs():
    assert tbase.get_arch("qwen2-moe-a2.7b").config == tqwen2.CONFIG
    assert tbase.get_arch("granite-moe-3b-a800m").smoke() == tgranite.smoke()
    assert "long_500k" in tbase.get_arch("qwen2-moe-a2.7b").skips
    assert tbase.get_arch("granite-moe-3b-a800m").shapes == tbase.LM_SHAPES


# ---------------------------------------------------------------------------
# init, routing, dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [16, 4, 1])
def test_init_moe_has_the_reference_layout(n_shards):
    cfg = tqwen2.smoke().replace(dtype="bfloat16")
    want = _np_tree(jM.init_moe(jax.random.PRNGKey(0), jax_config(cfg),
                                n_shards))
    gen = torch.Generator().manual_seed(0)
    got = tM.init_moe(gen, cfg, "cpu", n_shards)
    assert jax.tree.map(lambda a: tuple(a.shape), want) == \
        jax.tree.map(lambda a: tuple(a.shape), got)
    e_pad = tM.padded_experts(cfg.moe, n_shards)
    assert e_pad == jM.padded_experts(cfg.moe, n_shards)
    assert got["gate"].shape[0] == e_pad
    assert got["router"].dtype == torch.float32
    others = [v for k, v in got.items() if k != "router"]
    assert all(a.dtype == torch.bfloat16 for a in jax.tree.leaves(others))
    d, f = cfg.d_model, cfg.moe.d_expert
    for name, scale in (("router", d ** -0.5), ("gate", d ** -0.5),
                        ("up", d ** -0.5), ("down", f ** -0.5)):
        w = got[name].float()
        assert w.abs().max() <= 2 * scale * (1 + 2 ** -7), name
        assert 0.5 * scale < w.std() < scale, name


def _route_inputs(seed, t, e_pad, d=32):
    return _x(seed, (t, d)), _x(seed + 1, (d, e_pad), d ** -0.5)


@pytest.mark.parametrize("n_experts,e_pad,k", [(6, 8, 2), (6, 6, 2),
                                               (60, 64, 4), (5, 8, 2)])
def test_route_matches_jax(n_experts, e_pad, k):
    moe = MoEConfig(n_experts=n_experts, experts_per_token=k)
    x, w = _route_inputs(1, 96, e_pad)
    jw, jidx, jprobs = jM.route(jnp.asarray(w), jnp.asarray(x), moe, e_pad)
    tw, tidx, tprobs = tM.route(torch.from_numpy(w), torch.from_numpy(x),
                                moe, e_pad)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw, LAYER_TOL)
    _close(tprobs, jprobs, LAYER_TOL)
    assert int(tidx.max()) < n_experts       # phantoms never win
    assert float(tprobs[:, n_experts:].abs().sum()) == 0.0


def test_route_breaks_ties_by_the_lower_expert():
    """Equal probabilities: ``jax.lax.top_k`` puts the lower index first,
    and so does the port's stable descending sort."""
    e_pad, d = 8, 8
    rows = np.array([[1, 3, 3, 0, 3, 2, 0, 0],     # three-way tie at the top
                     [2, 2, 2, 2, 2, 2, 2, 2],     # all equal
                     [0, 1, 0, 1, 5, 0, 5, 9],     # tie in second place
                     [4, 4, 1, 0, 0, 0, 0, 4]], np.float32)
    x = np.eye(d, dtype=np.float32)[:len(rows)]    # token t reads row t
    w = np.zeros((d, e_pad), np.float32)
    w[:len(rows)] = rows
    moe = MoEConfig(n_experts=7, experts_per_token=3)  # expert 7: phantom
    jw, jidx, _ = jM.route(jnp.asarray(w), jnp.asarray(x), moe, e_pad)
    tw, tidx, _ = tM.route(torch.from_numpy(w), torch.from_numpy(x), moe,
                           e_pad)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx.tolist() == [[1, 2, 4], [0, 1, 2], [4, 6, 1], [0, 1, 2]]
    _close(tw, jw, LAYER_TOL)


def test_capacity_is_the_reference_integer():
    for t in (1, 2, 7, 8, 33, 100, 2304, 9216):
        for k in (1, 2, 4, 8):
            for n in (1, 4, 6, 60, 64):
                for f in (0.5, 1.0, 1.25, 2.0, 8.0):
                    assert tM.capacity(t, k, n, f) == \
                        jM.capacity(t, k, n, f), (t, k, n, f)


@pytest.mark.parametrize("t,k,n_exp,cap,lo,hi", [
    (40, 2, 8, 8, 0, 8),          # in range, some over capacity
    (40, 2, 8, 16, -3, 11),       # negative ids and ids >= n_exp
    (33, 4, 3, 24, -1, 9),        # an expert slice of a larger set
    (16, 1, 4, 8, 4, 8),          # every id out of range
])
def test_dispatch_indices_bit_exact(t, k, n_exp, cap, lo, hi):
    ids = np.random.default_rng(t + n_exp).integers(lo, hi, (t, k)).astype(
        np.int32)
    want = jM.dispatch_indices(jnp.asarray(ids), n_exp, cap)
    got = tM.dispatch_indices(torch.from_numpy(ids), n_exp, cap)
    for name, g, w in zip(("fe", "ft", "pos", "valid", "order"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _ffn_case(cf, n_shards=N_SHARDS, seed=3, t=96):
    cfg = port_config(tqwen2.smoke(), capacity_factor=cf)
    jcfg = jax_config(cfg)
    jp = jM.init_moe(jax.random.PRNGKey(seed), jcfg, n_shards)
    x = _x(seed, (2, t // 2, cfg.d_model))
    return cfg, jcfg, jp, _t_tree(_np_tree(jp)), x


def _drops(tp, cfg, x, cap):
    e_pad = tp["gate"].shape[0]
    _, idx, _ = tM.route(tp["router"], torch.from_numpy(x).reshape(
        -1, cfg.d_model), cfg.moe, e_pad)
    valid = tM.dispatch_indices(idx, e_pad, cap)[3]
    return int((~valid).sum())


@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_moe_local_and_gather_match_jax(cf):
    cfg, jcfg, jp, tp, x = _ffn_case(cf)
    e_pad = tp["gate"].shape[0]
    t = x.shape[0] * x.shape[1]
    cap = tM.capacity(t, cfg.moe.experts_per_token, e_pad, cf)
    drops = _drops(tp, cfg, x, cap)
    assert (drops > 0) == (cf < 8.0), drops
    xl = x.reshape(t, -1)
    jout, (jprobs, jidx) = jM._moe_local(jp, jnp.asarray(xl), jcfg.moe,
                                         jcfg.act, e_pad, cap)
    tout, (tprobs, tidx) = tM._moe_local(tp, torch.from_numpy(xl), cfg.moe,
                                         cfg.act, e_pad, cap)
    _close(tout, jout, FFN_TOL)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # one member's slice of the experts, as a shard of the gather mode sees
    sl = slice(2, 6)
    jloc = dict(jp, **{k: jp[k][sl] for k in ("gate", "up", "down")})
    tloc = dict(tp, **{k: tp[k][sl] for k in ("gate", "up", "down")})
    jout, _ = jM._moe_local(jloc, jnp.asarray(xl), jcfg.moe, jcfg.act, e_pad,
                            cap, expert_offset=2, n_local=4)
    tout, _ = tM._moe_local(tloc, torch.from_numpy(xl), cfg.moe, cfg.act,
                            e_pad, cap, expert_offset=2, n_local=4)
    _close(tout, jout, FFN_TOL)
    jy, jaux = jM.moe_gather(jp, jcfg, jnp.asarray(x))
    ty, taux = tM.moe_gather(tp, cfg, torch.from_numpy(x))
    _close(ty, jy, FFN_TOL)
    _close(taux, jaux, LAYER_TOL)
    # without a group the a2a mode is the gather mode, as the reference's
    # without a mesh
    a2a_cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="a2a"))
    assert torch.equal(tM.moe_ffn(tp, a2a_cfg, torch.from_numpy(x))[0], ty)


def test_moe_ref_dense_and_aux_match_jax():
    cfg, jcfg, jp, tp, x = _ffn_case(1.0, seed=4)
    jy, jaux = jM.moe_ref_dense(jp, jcfg, jnp.asarray(x))
    ty, taux = tM.moe_ref_dense(tp, cfg, torch.from_numpy(x))
    _close(ty, jy, LAYER_TOL)
    _close(taux, jaux, LAYER_TOL)
    # at a capacity that drops nothing the gather mode is the oracle
    big = port_config(cfg, capacity_factor=8.0)
    _close(tM.moe_gather(tp, big, torch.from_numpy(x))[0], jy, FFN_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_mlp_matches_jax(act):
    p = {"gate": _x(5, (3, 16, 24), 0.25), "up": _x(6, (3, 16, 24), 0.25),
         "down": _x(7, (3, 24, 16), 0.2)}
    buf = _x(8, (3, 10, 16))
    want = jM._expert_mlp({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(buf), act)
    got = tM._expert_mlp(_t_tree(p), torch.from_numpy(buf), act)
    _close(got, want, LAYER_TOL)


def test_one_member_group_computes_the_local_values(tmp_path):
    """On a one-member gloo group ``moe_gather`` runs its ``all_reduce``
    over the local values, and ``moe_a2a`` sends every slot to itself:
    at P = 1 its capacities drop nothing the local dispatch keeps."""
    cfg, _, _, tp, x = _ffn_case(1.25, n_shards=1, seed=5)
    xt = torch.from_numpy(x)
    local, aux = tM.moe_gather(tp, cfg, xt)
    mesh.init_model_group("gloo", 1, 0, f"file://{tmp_path / 'store'}")
    try:
        group = mesh.current_group()
        g, gaux = tM.moe_gather(tp, cfg, xt, group)
        a, aaux = tM.moe_a2a(tp, cfg, xt, group)
    finally:
        mesh.destroy_model_group()
    assert torch.equal(g, local) and torch.equal(gaux, aux)
    torch.testing.assert_close(a, local, **FFN_TOL)
    assert torch.equal(aaux, aux)


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------

PROMPT, PAD, STEPS = 24, 40, 8


def _model(arch):
    jcfg, tcfg = ARCHS[arch][0].smoke(), ARCHS[arch][1].smoke()
    jp = japi.init(jax.random.PRNGKey(0), jcfg, N_SHARDS)
    tp = tT.params_from_jax(_np_tree(jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    assert tp["layers"]["sub0"]["ffn"]["gate"].shape[1] == 8   # (groups, E)
    toks = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jaux = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, taux = tapi.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, MODEL_TOL)
    _close(taux, jaux, MODEL_TOL)
    assert float(taux) > 0.0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_logits_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jl, jc = jT.prefill(jp, jcfg, jnp.asarray(toks), pad_to=PAD)
    with torch.no_grad():
        tl, tc = tT.prefill(tp, tcfg, torch.from_numpy(toks), pad_to=PAD)
    _close(tl, jl, MODEL_TOL)
    for key in ("k", "v"):
        _close(tc[key], jc[key], MODEL_TOL)
    jstep = jax.jit(lambda p, t, c: jT.decode_step(p, jcfg, t, c))
    for _ in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jstep(jp, jnp.asarray(tok), jc)
        with torch.no_grad():
            tl, tc = tT.decode_step(tp, tcfg, torch.from_numpy(tok), tc)
        _close(tl, jl, MODEL_TOL)
    assert tc["pos"] == int(jc["pos"]) == PROMPT + STEPS
    _close(tc["k"], jc["k"], MODEL_TOL)


def _bf16_errors(port, want):
    """(relative Frobenius error, max abs error over the largest |want|)."""
    got = port.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    d = got - want
    return (np.linalg.norm(d) / np.linalg.norm(want),
            np.abs(d).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_forward_matches_jax_bf16(arch, monkeypatch):
    """f32 masters cast at apply time, the routers kept in f32, as the
    reference's ``cast_params``.  Routing is discontinuous: a token whose
    k-th and (k+1)-th router probabilities lie within bf16's relative
    resolution (2^-8) at some layer may take another expert in either
    package, so its logits row is left out of the check (and such rows
    must be few); every other row is held at the bf16 tolerance."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = np.random.default_rng(13).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, _ = japi.forward(jp, jcfg.replace(dtype="bfloat16"),
                         {"tokens": jnp.asarray(toks)})
    ffn_inputs = []
    moe_ffn = tM.moe_ffn

    def spy(params, cfg, h, group=None):
        ffn_inputs.append((params["router"], h))
        return moe_ffn(params, cfg, h, group)

    monkeypatch.setattr(tM, "moe_ffn", spy)
    with torch.no_grad():
        tl, _ = tapi.forward(tp, tcfg.replace(dtype="bfloat16"),
                             {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    assert len(ffn_inputs) == tcfg.n_layers
    k = tcfg.moe.experts_per_token
    near = torch.zeros(toks.size, dtype=torch.bool)
    for router, h in ffn_inputs:
        _, _, probs = tM.route(router, h.reshape(toks.size, -1), tcfg.moe,
                               router.shape[1])
        top = torch.sort(probs, dim=-1, descending=True).values
        near |= top[:, k - 1] - top[:, k] < 2 ** -8 * top[:, k - 1]
    assert int(near.sum()) <= toks.size // 10, int(near.sum())
    keep = ~near.numpy().reshape(toks.shape)
    rel, worst = _bf16_errors(tl[torch.from_numpy(keep)], jl[keep])
    assert rel <= BF16_REL and worst <= BF16_SCALE, (rel, worst)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_engine_generate_matches_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    prompts = np.random.default_rng(14).integers(
        0, jcfg.vocab_size, (3, PROMPT)).astype(np.int32)
    want = jengine.LMEngine(jp, jcfg, max_len=PAD).generate(prompts, STEPS)
    got = LMEngine(tp, tcfg, max_len=PAD, device="cpu").generate(prompts,
                                                                  STEPS)
    assert got.shape == (3, STEPS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_lm_has_the_reference_layout(arch):
    jcfg, tcfg = ARCHS[arch][0].smoke(), ARCHS[arch][1].smoke()
    jp = _np_tree(japi.init(jax.random.PRNGKey(0), jcfg))   # n_shards 16
    tp = tapi.init(0, tcfg.replace(dtype="bfloat16"), device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        jax.tree.map(lambda a: tuple(a.shape), tp)
    ffn = tp["layers"]["sub0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["gate"].dtype == torch.bfloat16
    assert ffn["gate"].shape[1] == 16


def test_params_from_jax_keeps_the_router_f32():
    """The reference's ``cast_params`` skips every leaf whose path holds
    ``router``: a bf16 conversion must too."""
    _, _, jp, _ = _model("qwen2_moe")
    tp = tT.params_from_jax(_np_tree(jp), "cpu", dtype="bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(tp)[0]
    routers = [v for path, v in flat if "router" in jax.tree_util.keystr(path)]
    others = [v for path, v in flat
              if "router" not in jax.tree_util.keystr(path)]
    assert len(routers) == 1 and routers[0].dtype == torch.float32
    assert others and all(v.dtype == torch.bfloat16 for v in others)


# ---------------------------------------------------------------------------
# 2 and 4 gloo members against the reference's mesh runs
# ---------------------------------------------------------------------------

FFN_SHAPE = (2, 64)        # (B, S): 128 tokens, S split over the members
N_MB, MB_TOKENS = 5, 64    # the BLS stream: 5 microbatches of 64 tokens

MESH_RUN = """
import dataclasses, json, sys
from pathlib import Path
import jax, numpy as np
from repro import compat
from repro.configs.base import ModelConfig, MoEConfig
from repro.models import moe as M
from repro.sharding import partition

d, p = Path(sys.argv[1]), int(sys.argv[2])
fields = json.loads(sys.argv[3])
base = ModelConfig(**{**fields, "moe": MoEConfig(**fields["moe"])})
data = np.load(d / "inputs.npz")
params = {}
for k in data.files:
    if k.startswith("ffn/"):
        parts = k.split("/")[1:]
        node = params
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[k]
mesh = compat.make_mesh((p,), ("model",))
out = {}
with partition.axis_rules(mesh):
    for f in json.loads(sys.argv[4]):
        cfg = base.replace(moe=dataclasses.replace(base.moe,
                                                   capacity_factor=f))
        for mode in ("gather", "a2a"):
            fn = getattr(M, "moe_" + mode)
            y, aux = jax.jit(lambda q, x: fn(q, cfg, x))(params, data["x"])
            out[f"{mode}/cf{f}"] = np.asarray(y)
            out[f"{mode}_aux/cf{f}"] = np.asarray(aux)
np.savez(d / "mesh.npz", **out)
"""


def _flat(prefix, tree, out):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(k.key for k in path)] = np.asarray(v)


def _mesh_run(p, d):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={p}")
    r = subprocess.run(
        [sys.executable, "-c", MESH_RUN, str(d), str(p),
         json.dumps(dataclasses.asdict(FFN_CFG)), json.dumps(FACTORS)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(d / "mesh.npz"))


_RUNS: dict = {}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def members(request, tmp_path_factory):
    p = request.param
    if p not in _RUNS:
        d = tmp_path_factory.mktemp(f"moe{p}")
        inputs = {}
        jffn = jM.init_moe(jax.random.PRNGKey(0), jax_config(FFN_CFG), p)
        jbls = jM.init_moe(jax.random.PRNGKey(0), jax_config(BLS_CFG), p)
        _flat("ffn", jffn, inputs)
        _flat("bls", jbls, inputs)
        x = _x(1, FFN_SHAPE + (FFN_CFG.d_model,))
        xs = _x(2, (N_MB, MB_TOKENS, BLS_CFG.d_model))
        inputs.update(x=x, xs=xs)
        np.savez(d / "inputs.npz", **inputs)
        want = {
            "dense": np.asarray(jM.moe_ref_dense(
                jffn, jax_config(FFN_CFG), jnp.asarray(x))[0]),
            "bls_dense": np.asarray(jM.moe_ref_dense(
                jbls, jax_config(BLS_CFG),
                jnp.asarray(xs.reshape(1, -1, BLS_CFG.d_model)))[0]),
            "mesh": _mesh_run(p, d)}
        outs = run_members(ROOT / "tests" / "_torch_moe_worker.py", p,
                           inputs, d)
        _RUNS[p] = (p, want, outs)
    return _RUNS[p]


def _a2a_whole(outs, key):
    """Each member's sequence shard, put back in order along S."""
    return np.concatenate([o[key] for o in outs], axis=1)


def test_gather_matches_the_dense_oracle(members):
    _, want, outs = members
    for o in outs:
        np.testing.assert_allclose(o["gather/cf8.0"], want["dense"],
                                   **MODEL_TOL)
        np.testing.assert_array_equal(o["gather/cf8.0"],
                                      outs[0]["gather/cf8.0"])


def test_a2a_matches_the_dense_oracle(members):
    _, want, outs = members
    np.testing.assert_allclose(_a2a_whole(outs, "a2a/cf8.0"), want["dense"],
                               **MODEL_TOL)


@pytest.mark.parametrize("mode", ["gather", "a2a"])
def test_tight_capacity_matches_the_reference_mesh_run(members, mode):
    """At capacity factor 1.0 slots drop, and which ones depends on the
    sharding: only the reference's own P-device run can hold it."""
    _, want, outs = members
    key = f"{mode}/cf1.0"
    got = _a2a_whole(outs, key) if mode == "a2a" else outs[0][key]
    np.testing.assert_allclose(got, want["mesh"][key], **FFN_TOL)
    assert not np.allclose(got, want["dense"], **MODEL_TOL)   # slots dropped
    np.testing.assert_allclose(want["mesh"]["a2a/cf8.0"], want["dense"],
                               **MODEL_TOL)
    if mode == "gather":
        np.testing.assert_allclose(outs[0]["gather_aux/cf1.0"],
                                   want["mesh"]["gather_aux/cf1.0"],
                                   **LAYER_TOL)


def test_a2a_under_bls_is_bit_identical_to_the_loop(members):
    _, _, outs = members
    for o in outs:
        for k in BOUNDS:
            np.testing.assert_array_equal(o[f"bls/b{k}"], o["loop"])


def test_a2a_loop_matches_the_dense_oracle(members):
    """The reference's ``test_moe_a2a_dispatch_under_bls_pipeline`` oracle:
    the stream flattened through ``moe_ref_dense``."""
    _, want, outs = members
    loop = np.concatenate([o["loop"] for o in outs], axis=1)  # (N, T, D)
    np.testing.assert_allclose(loop.reshape(-1, BLS_CFG.d_model),
                               want["bls_dense"][0], **MODEL_TOL)


def test_collective_calls_a_forward(members):
    """gather: one all_reduce; a2a: two dispatch all_to_all_single and one
    reply."""
    _, _, outs = members
    calls = {k: i for i, k in enumerate(COUNTED)}
    for o in outs:
        gather, a2a = o["calls"]
        assert gather[calls["all_reduce"]] == 1
        assert gather[calls["all_to_all_single"]] == 0
        assert a2a[calls["all_to_all_single"]] == 3
        assert a2a[calls["all_reduce"]] == 0
