"""rwkv6 and zamba2 tensor-parallel over members and whisper data-parallel
(the port's ``sharding/tp.py``, ``sharding/partition.py`` segmented
layouts, ``models/rwkv6.py``, ``models/mamba2.py``, ``models/zamba2.py``)
against the JAX reference, on the CPU.

Without processes: ``api.param_layout`` for rwkv6 and zamba2 at P in {1,
2, 4} (which leaves are cut, and the parts that run replicated where a
head count does not divide), whisper whole, and the segmented cut of
Mamba-2's fused ``in_proj``/``conv_w``/``conv_b`` (each member's block,
and the blocks joined back bit for bit; the full config by shape).

On 2 and 4 gloo members (``tests/_torch_members_ssm_worker.py``, one run
per P) the smoke models run on the reference's parameters on a (1, P)
mesh under ``arch_rules``: logits within FORWARD_TOL of the reference's
one-device ``api.forward``, the collected states, the prompt fed token by
token, 8 decode steps and the final cache within MODEL_TOL, ``LMEngine``
tokens equal, every leaf's gradient within GRAD_TOL (rwkv6:
RWKV6_GRAD_TOL) and a relative Frobenius GRAD_REL of ``jax.grad``; at
P = 2 tensor- and data-parallel train steps within STEP_TOL of the port's
one device (rwkv6 and zamba2 computing in bf16 too, within BF16_STEP_TOL
of one device's bf16 step), and checkpoints across packages (the segmented leaves restore
in the reference's order); at P = 4 ``elastic.reshard`` onto a (2, 2)
mesh gives the tree back.
"""
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import api as japi
from repro.runtime import checkpoint as jC
from repro.serving import engine as jengine
from repro.train import optimizer as jopt
from repro_torch.configs import base as tbase
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs as tspecs
from repro_torch.models import api as tapi
from repro_torch.sharding import partition as tpart
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps

import _torch_members_ssm_worker as W
from _torch_dist_worker import run_members

ROOT = Path(__file__).resolve().parents[1]
FORWARD_TOL = {"rtol": 1e-5, "atol": 1e-5}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}
# rwkv6's one-device gradient already differs from jax.grad by up to
# ~1.3e-6 in single elements (the f32 recurrence sums in another order; at
# P = 4 its time mix runs replicated, the one-device code), so its
# elementwise atol is 1e-5; a gradient that is one member's part is off by
# the gradient's own size (~1e-2).  Every leaf of every case is also held
# at a relative Frobenius error of GRAD_REL, as the one-device train tests
# hold them
RWKV6_GRAD_TOL = {"rtol": 1e-4, "atol": 1e-5}
GRAD_REL = 1e-4
STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}
BF16_STEP_TOL = {"loss": {"rtol": 1e-3, "atol": 0},
                 "grad_norm": {"rtol": 1e-2, "atol": 0},
                 "lr": {"rtol": 0, "atol": 0}}
STATE_CASES = ("rwkv6", "zamba2")


def jconfig(case):
    return jbase.get_arch(W.CASES[case]).smoke()


def _flat(prefix, tree, out):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(v)


# ---------------------------------------------------------------------------
# layouts, without processes
# ---------------------------------------------------------------------------


def _mesh(model, m=0, data=1):
    """A mesh stand-in: what the layout code reads (shape, axis names, this
    member's index, no group)."""
    return types.SimpleNamespace(
        shape={"data": data, "model": model}, axis_names=("data", "model"),
        index=lambda axis: m if axis == "model" else 0,
        group=lambda axis: None)


def _cut_paths(cfg, p, kind="prefill"):
    mesh = _mesh(p)
    rules = tspecs.arch_rules(cfg, mesh, ShapeConfig("t", kind, 16, 2))
    specs = tapi.param_layout(cfg, mesh, rules).specs
    out = {}
    tpart.map_specs(lambda path, s: out.__setitem__("/".join(path), s)
                    if tpart.is_cut(s) else None, specs)
    return out


RWKV_TIME = {f"layers/{k}/kernel" for k in ("wr", "wk", "wv", "wg", "wo")} \
    | {"layers/time_faaaa"}
RWKV_CHANNEL = {"layers/cm_k/kernel", "layers/cm_v/kernel"}
VOCAB = {"embed/table", "head/kernel"}
MAMBA = {f"mamba/{k}" for k in ("in_proj/kernel", "conv_w", "conv_b",
                                "A_log", "dt_bias", "D", "gate_norm/scale",
                                "out_proj/kernel")}
SHARED = {f"shared/attn/{k}/kernel" for k in ("wq", "wk", "wv", "wo")} | \
    {f"shared/ffn/{k}" for k in ("gate", "up", "down")}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_rwkv6_layout_cuts_heads_and_channel_mix(p, smoke):
    """rwkv6's time mix is cut where its heads (d_model / 64) divide, its
    channel mix where d_ff divides; ``cm_r`` and the "embed" leaves stay
    whole.  The smoke config has 2 heads: at P = 4 its time mix runs
    replicated and only its channel mix and vocab are cut."""
    spec = tbase.get_arch("rwkv6-1.6b")
    cfg = spec.smoke() if smoke else spec.config
    cut = _cut_paths(cfg, p)
    if p == 1:
        assert cut == {}
        return
    heads = cfg.d_model // 64
    want = RWKV_CHANNEL | VOCAB | (RWKV_TIME if heads % p == 0 else set())
    assert set(cut) == want
    if smoke and p == 4:
        assert not RWKV_TIME & set(cut)      # the named fallback
    for path, s in cut.items():
        assert "model" in s, path


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_zamba2_layout_cuts_mamba_heads_by_segment(p, smoke):
    """Every Mamba-2 leaf the reference puts on "heads" is cut (80 heads at
    full width, 8 in the smoke config), the fused ones segment by segment;
    the shared block as the transformer's; norms whole."""
    spec = tbase.get_arch("zamba2-2.7b")
    cfg = spec.smoke() if smoke else spec.config
    cut = _cut_paths(cfg, p)
    if p == 1:
        assert cut == {}
        return
    assert set(cut) == MAMBA | SHARED | VOCAB
    d_inner = cfg.ssm.expand * cfg.d_model
    n, nh = cfg.ssm.d_state, d_inner // cfg.ssm.head_dim
    assert cut["mamba/in_proj/kernel"][-1] == tpart.Segments(
        "model", (d_inner, d_inner, n, n, nh),
        (True, True, False, False, True))
    for k in ("conv_w", "conv_b"):
        assert cut[f"mamba/{k}"][-1] == tpart.Segments(
            "model", (d_inner, n, n), (True, False, False))
    assert cut["mamba/out_proj/kernel"] == (None, None, "model", None)


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("p", [2, 4])
def test_whisper_stays_whole(p, kind):
    assert _cut_paths(tbase.get_arch("whisper-tiny").config, p, kind) == {}


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("leaf", ["in_proj/kernel", "conv_w", "conv_b"])
def test_segmented_blocks_join_back_bit_for_bit(leaf, p):
    """Each member's block of a fused smoke-config leaf holds its heads of
    z / x / dt and the whole B and C; the blocks joined give the leaf back,
    and the clip norm's pieces count each whole segment once."""
    cfg = tbase.get_arch("zamba2-2.7b").smoke()
    full = tapi.init(0, cfg, "cpu")
    node = full["mamba"]
    for k in leaf.split("/"):
        node = node[k]
    # f64 integers: every sum of squares below is exact in any order
    x = torch.arange(node.numel(), dtype=torch.float64).reshape(node.shape)
    spec = _cut_paths(cfg, p)[f"mamba/{leaf}"]
    seg, d = spec[-1], x.dim() - 1
    blocks = [tpart.shard_leaf(x, spec, _mesh(p, m)) for m in range(p)]
    width = sum(seg.local(p))
    assert all(b.shape == x.shape[:-1] + (width,) for b in blocks)
    pieces = [seg.pieces(b, d, p) for b in blocks]
    full_pieces = torch.split(x, list(seg.sizes), d)
    for j, c in enumerate(seg.cut):
        got = torch.cat([pc[j][0] for pc in pieces], d) if c \
            else pieces[0][j][0]
        assert torch.equal(got, full_pieces[j]), j
        if not c:
            assert all(torch.equal(pc[j][0], got) for pc in pieces)
    assert torch.equal(tpart.join_blocks(blocks, seg, d), x)
    sq = sum(float(pc.square().sum()) for pc, c in pieces[0] if not c) + \
        sum(float(pc.square().sum()) for ps in pieces for pc, c in ps if c)
    assert sq == float(x.square().sum())


@pytest.mark.parametrize("p", [2, 4])
def test_segmented_cut_of_the_full_config_by_shape(p):
    """zamba2-2.7b's ``in_proj`` (2560 x 10448) and conv leaves cut and
    joined on meta tensors: shapes only, nothing drawn."""
    cfg = tbase.get_arch("zamba2-2.7b").config
    d_inner = cfg.ssm.expand * cfg.d_model
    n, nh = cfg.ssm.d_state, d_inner // cfg.ssm.head_dim
    cut = _cut_paths(cfg, p)
    shapes = {"in_proj/kernel": ((cfg.d_model, 2 * d_inner + 2 * n + nh),
                                 (2 * d_inner + nh) // p + 2 * n),
              "conv_w": ((cfg.ssm.d_conv, d_inner + 2 * n),
                         d_inner // p + 2 * n),
              "conv_b": ((d_inner + 2 * n,), d_inner // p + 2 * n)}
    for leaf, (shape, width) in shapes.items():
        lead = (9, 6)                 # (n_groups, shared_attn_every)
        x = torch.empty(lead + shape, device="meta")
        spec = cut[f"mamba/{leaf}"]
        blocks = [tpart.shard_leaf(x, spec, _mesh(p, m)) for m in range(p)]
        assert all(b.shape == x.shape[:-1] + (width,) for b in blocks)
        assert tpart.join_blocks(blocks, spec[-1], x.dim() - 1).shape == \
            x.shape


# ---------------------------------------------------------------------------
# the gloo runs
# ---------------------------------------------------------------------------


def _batch(rng, b, s, cfg, prefix, inputs):
    inputs[f"{prefix}tokens"] = rng.integers(0, 512, (b, s), dtype=np.int32)
    inputs[f"{prefix}labels"] = rng.integers(0, 512, (b, s), dtype=np.int32)
    inputs[f"{prefix}frames"] = rng.standard_normal(
        (b, s, cfg.d_frontend)).astype(np.float32)
    out = {k: jnp.asarray(inputs[f"{prefix}{k}"])
           for k in ("tokens", "labels")}
    if cfg.family == "audio":
        out["frames"] = jnp.asarray(inputs[f"{prefix}frames"])
    return out


def _inputs(p, d):
    inputs, want = {}, {}
    rng = np.random.default_rng(100 + p)
    wcfg = jconfig("whisper")
    serve = _batch(rng, W.B, W.S, wcfg, "serve/", inputs)
    grad = _batch(rng, W.TRAIN_B, W.S, wcfg, "grad/", inputs)
    _batch(rng, W.TRAIN_B, W.TRAIN_S, wcfg, "train/", inputs)
    inputs["decode_toks"] = rng.integers(0, 512, (W.B, W.DECODE),
                                         dtype=np.int32)
    prompts = inputs["serve/tokens"]
    for i, case in enumerate(W.CASES):
        jcfg = jconfig(case)
        jp = japi.init(jax.random.PRNGKey(i), jcfg)
        _flat(case, jp, inputs)
        batch = {"tokens": serve["tokens"]}
        tb = {"tokens": grad["tokens"], "labels": grad["labels"]}
        if jcfg.family == "audio":
            batch["frames"], tb["frames"] = serve["frames"], grad["frames"]
        w = {"logits": np.asarray(japi.forward(jp, jcfg, batch,
                                               remat=False)[0])}
        if jcfg.family == "ssm":
            from repro.models import rwkv6 as jR
            st = jR.forward(jp, jcfg, serve["tokens"], remat=False,
                            collect_cache=True)[2]
            _flat("collect", dict(st), w)
        elif jcfg.family == "hybrid":
            from repro.models import zamba2 as jZ
            (k, v), st = jZ.forward(jp, jcfg, serve["tokens"], remat=False,
                                    collect_cache=True)[2]
            _flat("collect", {"k": k, "v": v, "ssd": st["ssd"]}, w)
        cache = japi.make_cache(jcfg, W.B, W.MAX_LEN)
        for t in range(W.S):
            lg, cache = japi.decode_step(jp, jcfg,
                                         jnp.asarray(prompts[:, t:t + 1]),
                                         cache)
        w["prefill"] = np.asarray(lg)
        for t in range(W.DECODE):
            lg, cache = japi.decode_step(
                jp, jcfg, jnp.asarray(inputs["decode_toks"][:, t:t + 1]),
                cache)
            w[f"decode{t}"] = np.asarray(lg)
        if jcfg.family != "audio":
            _flat("cache", {k: v for k, v in cache.items() if k != "pos"},
                  w)
        w["tokens"] = jengine.LMEngine(jp, jcfg, max_len=W.MAX_LEN) \
            .generate(prompts, W.GEN)

        def loss_fn(q, jcfg=jcfg, tb=tb):
            logits, aux = japi.forward(q, jcfg, tb, remat=True)
            return japi.loss(jcfg, logits, tb["labels"], aux)

        w["loss"], w["grad"] = jax.value_and_grad(loss_fn)(jp)
        want[case] = w
    # a reference checkpoint of a zamba2 (params, AdamW state) tree
    jp = japi.init(jax.random.PRNGKey(7), jconfig("zamba2"))
    st = jopt.adamw_init(jp)
    st = {"m": jax.tree.map(lambda a: a + 0.5, st["m"]),
          "v": jax.tree.map(lambda a: a + 0.25, st["v"]),
          "count": jnp.int32(5)}
    jC.save(str(d / "jax_ckpt"), 5, (jp, st))
    want["jax_ckpt"] = (jp, st)
    return inputs, want


_RUNS: dict = {}


def _run(p, tmp_path_factory):
    if p not in _RUNS:
        d = tmp_path_factory.mktemp(f"members_ssm{p}")
        inputs, want = _inputs(p, d)
        outs = run_members(ROOT / "tests" / "_torch_members_ssm_worker.py",
                           p, inputs, d, timeout=600)
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
    _, _, _, _, outs = members
    for o in outs:
        for case in W.CASES:
            assert bool(o[f"{case}/roundtrip"]), case
            n_cut = int(o[f"{case}/n_cut"])
            assert (n_cut == 0) if case == "whisper" else (n_cut > 0), case


@pytest.mark.parametrize("case", list(W.CASES))
def test_forward_over_members_matches_the_reference(members, case):
    _, _, _, want, outs = members
    for o in outs:
        np.testing.assert_allclose(o[f"{case}/logits"], want[case]["logits"],
                                   **FORWARD_TOL)


@pytest.mark.parametrize("case", STATE_CASES)
def test_collected_states_over_members_match_the_reference(members, case):
    """``forward(collect_cache=True)``: rwkv6's shift vectors and WKV
    states, zamba2's K/V and SSD states, each member's heads gathered."""
    _, _, _, want, outs = members
    keys = [k for k in want[case] if k.startswith("collect/")]
    assert keys
    for o in outs:
        for k in keys:
            np.testing.assert_allclose(o[f"{case}/{k}"], want[case][k],
                                       err_msg=k, **MODEL_TOL)


@pytest.mark.parametrize("case", list(W.CASES))
def test_prefill_and_decode_over_members_match_the_reference(members, case):
    """The prompt fed token by token into a member's cache, 8 decode steps
    and the final cache (gathered: zamba2's conv state through its
    segmented layout), then ``LMEngine``'s tokens."""
    _, _, _, want, outs = members
    w = want[case]
    for o in outs:
        np.testing.assert_allclose(o[f"{case}/prefill"], w["prefill"],
                                   **MODEL_TOL)
        for t in range(W.DECODE):
            np.testing.assert_allclose(o[f"{case}/decode{t}"],
                                       w[f"decode{t}"], **MODEL_TOL)
        for k in (k for k in w if k.startswith("cache/")):
            np.testing.assert_allclose(o[f"{case}/{k}"], w[k], err_msg=k,
                                       **MODEL_TOL)
        np.testing.assert_array_equal(o[f"{case}/tokens"], w["tokens"])


@pytest.mark.parametrize("case", list(W.CASES))
def test_gradients_over_members_match_jax_grad(members, case):
    """Every leaf's gradient, gathered, within GRAD_TOL of ``jax.grad``:
    a whole leaf sliced inside a cut region without ``copy_to`` (rwkv6's
    ``ln_x``, ``time_decay``, ``decay_B``; Mamba-2's ``B``/``C`` columns)
    or a ``gate_norm`` statistic whose backward did not sum would leave a
    member's part."""
    _, _, _, want, outs = members
    w = want[case]
    grads = {}
    _flat("g", w["grad"], grads)
    tol = RWKV6_GRAD_TOL if case == "rwkv6" else GRAD_TOL
    for o in outs:
        np.testing.assert_allclose(o[f"{case}/loss"], np.asarray(w["loss"]),
                                   **STEP_TOL)
        for k, g in grads.items():
            got = o[f"{case}/grad/{k[2:]}"]
            assert np.isfinite(got).all(), k
            np.testing.assert_allclose(got, g, err_msg=k, **tol)
            g64 = np.asarray(g, np.float64)
            assert np.linalg.norm(got - g64) <= \
                GRAD_REL * max(np.linalg.norm(g64), 1e-30), k


def _port_step(case, inputs, dtype=None):
    cfg = W.config(case)
    cfg = cfg.replace(dtype=dtype or cfg.dtype)
    params = W.nested(inputs, case)
    batch = W.batch_of(cfg, inputs, "train/")
    return tsteps.make_train_step(cfg)(params, topt.adamw_init(params),
                                       batch)[2]


@pytest.mark.parametrize("mode", ["tp", "dp"])
@pytest.mark.parametrize("case", list(W.CASES))
def test_train_steps_over_members_match_one_device(members2, case, mode):
    """A step on a (1, 2) mesh (tensor-parallel; whisper replicated: its
    rules are all None) and on a (2, 1) mesh (each member half the batch,
    whisper's frames sliced with its tokens) against one device's."""
    _, _, inputs, _, outs = members2
    want = _port_step(case, inputs)
    for o in outs:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(o[f"train/{mode}_{case}/{k}"],
                                       want[k].numpy(), err_msg=k,
                                       **STEP_TOL)


@pytest.mark.parametrize("mode", ["tp", "dp"])
@pytest.mark.parametrize("case", list(W.BF16_CASES))
def test_bf16_train_steps_over_members_match_one_device(members2, case,
                                                        mode):
    """The same steps computing in bf16 (the configs' own type at full
    width) against one device's bf16 step: the members round their partial
    sums to bf16 where one device keeps a GEMM's f32 accumulator, so they
    are held at the card's gates (loss 1e-3, grad_norm 1e-2 relative)."""
    _, _, inputs, _, outs = members2
    want = _port_step(case, inputs, "bfloat16")
    for o in outs:
        for k, tol in BF16_STEP_TOL.items():
            np.testing.assert_allclose(o[f"train/{mode}_{case}_bf16/{k}"],
                                       want[k].numpy(), err_msg=k, **tol)


def test_a_zamba2_checkpoint_over_members_restores_in_the_reference(
        members2):
    """A zamba2 (params, AdamW state) laid out over 2 members, the fused
    Mamba-2 leaves cut segment by segment, saved and read back by the
    reference as the whole tree, column for column."""
    _, d, inputs, _, _ = members2
    jp = japi.init(jax.random.PRNGKey(0), jconfig("zamba2"))
    (got, st), step = jC.restore(str(d / "port_ckpt"),
                                 (jp, jopt.adamw_init(jp)))
    assert step == 3
    flat = {}
    _flat("zamba2", got, flat)
    assert "zamba2/mamba/in_proj/kernel" in flat
    for k, v in flat.items():
        np.testing.assert_array_equal(v, inputs[k], err_msg=k)
    for leaf in jax.tree.leaves(st):
        assert not np.asarray(leaf).any()


def test_a_reference_checkpoint_restores_onto_members(members2):
    _, _, _, want, outs = members2
    jp, _ = want["jax_ckpt"]
    ref = {}
    _flat("ckpt/restored", jp, ref)
    for o in outs:
        assert int(o["ckpt/step"]) == 5
        for k, v in ref.items():
            np.testing.assert_array_equal(o[k], v, err_msg=k)


def test_reshard_between_layouts_gives_the_tree_back(members4):
    """zamba2's parameters moved from a (1, 4) layout onto a (2, 2) one by
    ``elastic.reshard``, gathered: the reference's tree bit for bit."""
    _, _, inputs, _, outs = members4
    for o in outs:
        keys = [k for k in o if k.startswith("reshard/params/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                o[k], inputs["zamba2/" + k[len("reshard/params/"):]],
                err_msg=k)
