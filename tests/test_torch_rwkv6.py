"""The port's rwkv6 serving path (config, layernorm, the model, api, steps,
LMEngine, the serve CLI) against the JAX reference on the same inputs, on
the CPU.

Parameters come from the reference's ``api.init`` and cross over as numpy
(``params_from_jax``), so no RNG has to match.  Layer functions are held at
f32 rtol = atol = 1e-5 (matmuls and the WKV sum in other orders; a whole
block at 5e-5), layernorm
at 1e-6, and the smoke model's logits and states at f32 rtol = atol = 1e-4
(the tolerance of the dense model's tests).  On the CPU the port's chunked
WKV is the kernel's plain version.  Config copies are held exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_1_6b as jrwkv
from repro.models import api as japi
from repro.models import layers as jL
from repro.models import rwkv6 as jR
from repro.serving import engine as jengine
from repro_torch.configs import base as tbase
from repro_torch.configs import rwkv6_1_6b as trwkv
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import layers as tL
from repro_torch.models import rwkv6 as tR
from repro_torch.models import transformer as tT
from repro_torch.serving.engine import LMEngine
from repro_torch.train import steps as tsteps

NORM_TOL = {"rtol": 1e-6, "atol": 1e-6}
LAYER_TOL = {"rtol": 1e-5, "atol": 1e-5}
# a block adds both mixes, each a chain of several matmuls, to the stream
BLOCK_TOL = {"rtol": 5e-5, "atol": 5e-5}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
# bf16: each framework rounds the bf16 activations at its own places (XLA
# may fuse an elementwise chain and round once, torch rounds after every
# op), so after two layers the logits (of order 1) differ by up to ~8 bf16
# ulps here: max 0.066, relative Frobenius error 1.0e-2.  The same model
# run without the bf16 casts (the f32 logits) is 0.19 and 1.5e-2 away, so
# the check fails it, which the test asserts.
BF16_TOL = {"rtol": 0.1, "atol": 0.1}
BF16_REL = 1.25e-2
SEQ, STEPS = 64, 16


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, dtype=np.float32), **tol)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jrwkv.smoke(), trwkv.smoke()
    jp = japi.init(jax.random.PRNGKey(0), jcfg, 1)
    np_params = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, np_params, tT.params_from_jax(np_params, "cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# config and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
def test_config_copies_match_the_reference(which):
    j, t = getattr(jrwkv, which), getattr(trwkv, which)
    j, t = (j() if callable(j) else j), (t() if callable(t) else t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_registry_resolves_rwkv6():
    spec = tbase.get_arch("rwkv6-1.6b")
    assert spec.config == trwkv.CONFIG and spec.config.family == "ssm"
    assert spec.smoke() == trwkv.smoke()
    assert spec.shapes == tbase.LM_SHAPES and spec.skips == {}


def test_layernorm_uses_the_population_variance():
    # 6 features: the sample variance is 6/5 of the population variance,
    # so torch's default var would miss the tolerance by far
    x, w, b = _x(0, (3, 5, 6), 3.0), _x(1, (6,)), _x(2, (6,))
    params = {"scale": w, "bias": b}
    want = jL.layernorm(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got = tL.layernorm({k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x))
    _close(got, want, NORM_TOL)
    xt = torch.from_numpy(x)
    sample = (xt - xt.mean(-1, keepdim=True)) * torch.rsqrt(
        xt.var(-1, keepdim=True) + 1e-5) * torch.from_numpy(w) + \
        torch.from_numpy(b)
    assert not np.allclose(sample.numpy(), np.asarray(want), **LAYER_TOL)


def test_layernorm_keeps_the_input_type():
    x = torch.from_numpy(_x(3, (2, 4, 16))).to(torch.bfloat16)
    out = tL.layernorm(tL.init_layernorm(16, "float32", "cpu"), x)
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# init and the family's entry points
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


def test_an_ssm_config_initialises_with_the_reference_layout(model):
    _, tcfg, _, np_params, _ = model
    tp = tapi.init(0, tcfg.replace(dtype="bfloat16"), device="cpu")
    want = {k: v.shape for k, v in _leaves(np_params)}
    got = dict(_leaves(tp))
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    assert torch.all(got["layers/maa_x"] == 0)
    assert torch.all(got["layers/ln1/scale"] == 1)
    wr = got["layers/wr/kernel"].float()
    assert 0.5 * tcfg.d_model ** -0.5 < wr.std() < tcfg.d_model ** -0.5
    # layers are drawn one after another, not copies of one draw
    assert not torch.equal(wr[0], wr[1])
    again = tapi.init(0, tcfg.replace(dtype="bfloat16"), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(tp), _leaves(again)))


def test_make_cache_is_the_recurrent_state(model):
    jcfg, tcfg, _, _, _ = model
    want = japi.make_cache(jcfg, 3, 99)
    got = tapi.make_cache(tcfg, 3, 99, device="cpu")
    for key in ("tm_shift", "cm_shift", "wkv"):
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[1] == str(want[key].dtype)
    assert got["pos"] == 0


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trwkv.smoke()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tapi.init(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tapi.make_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        LMEngine(tR.init_rwkv6(0, cfg, device="cpu"), cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tserve.main(["--arch", "rwkv6-1.6b", "--smoke"])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _layer0(model):
    jcfg, tcfg, jp, _, tp = model
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = tT._map(lambda a: a[0], tp["layers"])
    return jcfg, tcfg, jl, tl


@pytest.mark.parametrize("s", [SEQ, 33, 1])
def test_time_mix_matches_jax(model, s):
    jcfg, tcfg, jl, tl = _layer0(model)
    h = tR.n_heads(tcfg)
    x = _x(4, (2, s, tcfg.d_model))
    prev = _x(5, (2, 1, tcfg.d_model))
    st = _x(6, (2, h, 64, 64), 0.1)
    jout = jR.time_mix(jl, jcfg, jnp.asarray(x), shift_prev=jnp.asarray(prev),
                       wkv_state=jnp.asarray(st))
    tout = tR.time_mix(tl, tcfg, torch.from_numpy(x),
                       shift_prev=torch.from_numpy(prev),
                       wkv_state=torch.from_numpy(st))
    for got, want in zip(tout, jout):
        _close(got, want, LAYER_TOL)


def test_channel_mix_matches_jax(model):
    _, tcfg, jl, tl = _layer0(model)
    x = _x(7, (2, 24, tcfg.d_model))
    jout = jR.channel_mix(jl, jnp.asarray(x))
    tout = tR.channel_mix(tl, torch.from_numpy(x))
    for got, want in zip(tout, jout):
        _close(got, want, LAYER_TOL)


def test_block_matches_jax(model):
    jcfg, tcfg, jl, tl = _layer0(model)
    x = _x(8, (2, SEQ, tcfg.d_model))
    jx, jst = jR.block(jl, jcfg, jnp.asarray(x))
    tx, tst = tR.block(tl, tcfg, torch.from_numpy(x))
    _close(tx, jx, BLOCK_TOL)
    for key in ("tm_shift", "cm_shift", "wkv"):
        _close(tst[key], jst[key], BLOCK_TOL)


# ---------------------------------------------------------------------------
# the model: forward, decode, generate
# ---------------------------------------------------------------------------


def test_forward_and_states_match_jax(model):
    jcfg, tcfg, jp, _, tp = model
    toks = _tokens(9, 2, SEQ, jcfg.vocab_size)
    jl, _, jst = jR.forward(jp, jcfg, jnp.asarray(toks), collect_cache=True,
                            remat=False)
    with torch.no_grad():
        tl, aux, tst = tR.forward(tp, tcfg, torch.from_numpy(toks),
                                  collect_cache=True)
    assert tl.shape == (2, SEQ, jcfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl, MODEL_TOL)
    for key in ("tm_shift", "cm_shift", "wkv"):
        assert tuple(tst[key].shape) == jst[key].shape
        _close(tst[key], jst[key], MODEL_TOL)


def test_api_forward_and_prefill_step(model):
    jcfg, tcfg, jp, _, tp = model
    toks = _tokens(10, 2, SEQ, jcfg.vocab_size)
    jl, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        tl, _ = tapi.forward(tp, tcfg, batch)
        ref_impl, _ = tapi.forward(tp, tcfg, batch, wkv_impl="ref")
    last = tsteps.make_prefill_step(tcfg)(tp, batch)
    _close(tl, jl, MODEL_TOL)
    assert torch.equal(ref_impl, tl)      # on the CPU "auto" is the plain path
    # the head's matmul over one row may block differently from 64
    torch.testing.assert_close(last, tl[:, -1:], **MODEL_TOL)


def _bf16_check(port, want):
    got = port.detach().float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    return np.allclose(got, want, **BF16_TOL) and rel <= BF16_REL


def test_bf16_forward_matches_jax_bf16(model):
    jcfg, tcfg, jp, _, tp = model
    toks = _tokens(11, 2, SEQ, jcfg.vocab_size)
    bf16 = tcfg.replace(dtype="bfloat16")
    jl, _ = jR.forward(jp, jcfg.replace(dtype="bfloat16"), jnp.asarray(toks),
                       remat=False)
    with torch.no_grad():
        # f32 masters, cast at apply time as the reference does
        tl, _ = tR.forward(tp, bf16, torch.from_numpy(toks))
        f32, _ = tR.forward(tp, tcfg, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    assert _bf16_check(tl, jl)
    assert not _bf16_check(f32, jl)


def test_decode_steps_match_jax(model):
    jcfg, tcfg, jp, _, tp = model
    rng = np.random.default_rng(12)
    jst = jR.make_state(jcfg, 2)
    tst = tR.make_state(tcfg, 2, device="cpu")
    jstep = jax.jit(lambda p, t, s: jR.decode_step(p, jcfg, t, s))
    for _ in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jst = jstep(jp, jnp.asarray(tok), jst)
        before = tst["wkv"].clone()
        with torch.no_grad():
            tl, new = tR.decode_step(tp, tcfg, torch.from_numpy(tok), tst)
        assert torch.equal(tst["wkv"], before)     # the state handed in
        tst = new
        _close(tl, jl, MODEL_TOL)
    assert tst["pos"] == int(jst["pos"]) == STEPS
    for key in ("tm_shift", "cm_shift", "wkv"):
        _close(tst[key], jst[key], MODEL_TOL)


def test_decode_matches_forward(model):
    _, tcfg, _, _, tp = model
    toks = torch.from_numpy(_tokens(13, 2, 16, tcfg.vocab_size))
    with torch.no_grad():
        full, _ = tR.forward(tp, tcfg, toks)
        st = tR.make_state(tcfg, 2, device="cpu")
        outs = []
        for t in range(16):
            lg, st = tR.decode_step(tp, tcfg, toks[:, t:t + 1], st)
            outs.append(lg)
    # the reference's own tolerance (tests/test_attention_and_ssm.py)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=2e-3)


@pytest.mark.parametrize("s,chunked", [(33, False), (32, True), (1, False)])
def test_only_whole_chunks_take_the_kernel_op(model, monkeypatch, s, chunked):
    jcfg, tcfg, jp, _, tp = model
    calls = []
    op = ops.rwkv6_wkv_op

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return op(*args, **kw)

    monkeypatch.setattr(ops, "rwkv6_wkv_op", spy)
    toks = _tokens(14, 1, s, jcfg.vocab_size)
    with torch.no_grad():
        tl, _ = tR.forward(tp, tcfg, torch.from_numpy(toks))
    assert len(calls) == (tcfg.n_layers if chunked else 0)
    jl, _ = jR.forward(jp, jcfg, jnp.asarray(toks), remat=False)
    _close(tl, jl, MODEL_TOL)


def test_unknown_wkv_impl_raises(model):
    _, tcfg, _, _, tp = model
    # S = 1 never reaches the op, so the check cannot rest on it
    with pytest.raises(ValueError, match="unknown wkv_impl"):
        tR.forward(tp, tcfg, torch.zeros((1, 1), dtype=torch.int64),
                   wkv_impl="triton")


def test_lm_engine_generate_matches_jax(model):
    jcfg, tcfg, jp, _, tp = model
    prompts = _tokens(15, 3, 12, jcfg.vocab_size)
    want = jengine.LMEngine(jp, jcfg, max_len=32).generate(prompts, 8)
    eng = LMEngine(tp, tcfg, max_len=32, device="cpu")
    got = eng.generate(prompts, 8)
    assert got.shape == (3, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(eng.monitor.lat) == 8


def test_serve_cli_rwkv6_on_cpu(capsys):
    tserve.main(["--arch", "rwkv6-1.6b", "--smoke", "--tokens", "3",
                 "--device", "cpu"])
    assert "generated (4, 3)" in capsys.readouterr().out
