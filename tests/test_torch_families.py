"""The rest of the attention families on the port, against the JAX
reference on the same inputs, on the CPU, at their smoke configs:
chatglm3-6b (glm2d rope on half of each head, QKV bias, multi-query-like
GQA), qwen2-72b (GQA, QKV bias) and llava-next-mistral-7b (the vision
frontend's patch embeddings ahead of the text), and the layers they and
whisper bring (``causal_mask``, ``attend_full`` with positions and without
the causal mask, ``attend_cross``, the plain MLP), the registry's
``list_archs`` and the config properties.

Parameters come from the reference's ``api.init`` through
``params_from_jax``.  Layers are held at f32 rtol = atol = 1e-6; model
logits and caches at f32 rtol = atol = 1e-4 (``MODEL_TOL``, as
``tests/test_torch_lm.py``, whose parametrised config-copy, prefill + 8
decode, ``LMEngine`` and init-layout tests run these three archs too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import chatglm3_6b as jglm
from repro.configs import llava_next_mistral_7b as jllava
from repro.configs import qwen2_72b as jqwen2
from repro.models import api as japi
from repro.models import attention as jA
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch.configs import base as tbase
from repro_torch.configs import chatglm3_6b as tglm
from repro_torch.configs import llava_next_mistral_7b as tllava
from repro_torch.configs import qwen2_72b as tqwen2
from repro_torch.models import api as tapi
from repro_torch.models import attention as tA
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.train import steps as tsteps

LAYER_TOL = {"rtol": 1e-6, "atol": 1e-6}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
ARCHS = {"chatglm3": (jglm, tglm), "qwen2_72b": (jqwen2, tqwen2),
         "llava": (jllava, tllava)}
# archs of the reference the port has no config for yet: none since the
# hybrid zamba2-2.7b was ported
UNPORTED_ARCHS = set()


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _model(arch):
    jcfg, tcfg = ARCHS[arch][0].smoke(), ARCHS[arch][1].smoke()
    jp = japi.init(jax.random.PRNGKey(0), jcfg, 1)
    tp = tT.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _patches(seed, cfg, b=2):
    return _x(seed, (b, cfg.n_frontend_tokens, cfg.d_frontend))


# ---------------------------------------------------------------------------
# registry and configs
# ---------------------------------------------------------------------------


def test_list_archs_is_the_references_minus_the_unported():
    assert tbase.list_archs() == sorted(set(jbase.list_archs())
                                        - UNPORTED_ARCHS)
    for name in UNPORTED_ARCHS:
        with pytest.raises(KeyError):
            tbase.get_arch(name)


def test_config_properties_match_the_reference():
    for name in tbase.list_archs():
        j, t = jbase.get_arch(name), tbase.get_arch(name)
        if not hasattr(j.config, "is_encdec"):       # the DLRM configs
            continue
        for cfg_j, cfg_t in ((j.config, t.config), (j.smoke(), t.smoke())):
            assert cfg_t.is_encdec == cfg_j.is_encdec, name
            assert cfg_t.attention_free == cfg_j.attention_free, name
    assert tbase.get_arch("whisper-tiny").config.is_encdec
    assert tbase.get_arch("rwkv6-1.6b").config.attention_free


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp(act):
    x = _x(1, (2, 7, 32))
    p = {"fc1": {"kernel": 0.2 * _x(2, (32, 64)), "bias": 0.1 * _x(3, (64,))},
         "fc2": {"kernel": 0.1 * _x(4, (64, 32)), "bias": 0.1 * _x(5, (32,))}}
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.from_numpy, p)
    _close(tL.mlp(tp, torch.from_numpy(x), act), jL.mlp(jp, jnp.asarray(x),
                                                        act), LAYER_TOL)


def test_init_mlp_has_the_reference_layout():
    want = jL.init_mlp(jax.random.PRNGKey(0), 32, 96, "float32")
    gen = torch.Generator().manual_seed(0)
    got = tL.init_mlp(gen, 32, 96, "bfloat16", "cpu")
    assert jax.tree.map(lambda a: a.shape, want) == \
        jax.tree.map(lambda a: tuple(a.shape), got)
    assert not got["fc1"]["bias"].any() and not got["fc2"]["bias"].any()
    assert got["fc2"]["kernel"].float().abs().max() <= \
        2 * 96 ** -0.5 * (1 + 2 ** -7)
    assert "bias" not in tL.init_mlp(gen, 8, 16, "float32", "cpu",
                                     bias=False)["fc1"]


@pytest.mark.parametrize("s,t,window,offset", [(5, 5, 0, 0), (4, 9, 0, 5),
                                               (7, 7, 3, 0), (3, 8, 2, 4)])
def test_causal_mask(s, t, window, offset):
    got = tA.causal_mask(s, t, window, offset)
    want = np.asarray(jA.causal_mask(s, t, window, offset))
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
def test_attend_full_with_positions(causal):
    """The reference's ``positions`` and ``causal`` arguments: an offset
    rope position and the mask switched off (whisper's encoder)."""
    jcfg, tcfg, jp, tp = _model("chatglm3")
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["sub0"]["attn"])
    tattn = tT._map(lambda a: a[0], tp["layers"]["sub0"]["attn"])
    x = _x(6, (2, 11, jcfg.d_model))
    pos = (np.arange(11, dtype=np.int32) + 7)[None, :]
    jo, (jk, _) = jA.attend_full(jattn, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos), causal=causal)
    with torch.no_grad():
        to, (tk, _) = tA.attend_full(tattn, tcfg, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos),
                                     causal=causal)
    _close(to, jo, MODEL_TOL)
    _close(tk, jk, LAYER_TOL)


def test_attend_cross():
    jcfg, tcfg, jp, tp = _model("qwen2_72b")
    jattn = jax.tree.map(lambda a: a[1], jp["layers"]["sub0"]["attn"])
    tattn = tT._map(lambda a: a[1], tp["layers"]["sub0"]["attn"])
    x = _x(7, (2, 5, jcfg.d_model))
    ek = _x(8, (2, 13, jcfg.n_kv_heads, jcfg.head_dim))
    ev = _x(9, (2, 13, jcfg.n_kv_heads, jcfg.head_dim))
    want = jA.attend_cross(jattn, jcfg, *map(jnp.asarray, (x, ek, ev)))
    with torch.no_grad():
        got = tA.attend_cross(tattn, tcfg, *map(torch.from_numpy,
                                                (x, ek, ev)))
    assert got.shape == (2, 5, jcfg.d_model)
    _close(got, want, MODEL_TOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_logits_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    toks = np.random.default_rng(21).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        tl, aux = tapi.forward(tp, tcfg, batch)
        ref_impl, _ = tapi.forward(tp, tcfg, batch, attn_impl="ref")
    assert tl.shape == (2, 16, jcfg.vocab_size) and float(aux) == 0.0
    _close(tl, jl, MODEL_TOL)
    assert torch.equal(ref_impl, tl)      # on the CPU "auto" is the plain path


def test_llava_forward_with_patches():
    """``batch["patches"]`` (B, n_frontend_tokens, d_frontend) ahead of the
    text: the logits cover n_frontend_tokens + S positions, as the
    reference's (tests/test_models_smoke.py)."""
    jcfg, tcfg, jp, tp = _model("llava")
    toks = np.random.default_rng(22).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    patches = _patches(23, jcfg)
    jl, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                    "patches": jnp.asarray(patches)})
    batch = {"tokens": torch.from_numpy(toks),
             "patches": torch.from_numpy(patches)}
    with torch.no_grad():
        tl, _ = tapi.forward(tp, tcfg, batch)
        text, _ = tapi.forward(tp, tcfg, {"tokens": batch["tokens"]})
    last = tsteps.make_prefill_step(tcfg)(tp, batch)
    assert tl.shape == (2, jcfg.n_frontend_tokens + 12, jcfg.vocab_size)
    _close(tl, jl, MODEL_TOL)
    torch.testing.assert_close(last, tl[:, -1:], **MODEL_TOL)
    # the patches change what the text sees
    assert not torch.allclose(tl[:, -1], text[:, -1], rtol=0, atol=1e-4)


def test_llava_prefill_with_frontend_embeds_and_decode():
    jcfg, tcfg, jp, tp = _model("llava")
    rng = np.random.default_rng(24)
    toks = rng.integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    patches = _patches(25, jcfg)
    n = jcfg.n_frontend_tokens + 10
    jl, jc = jT.prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(patches),
                        pad_to=n + 6)
    with torch.no_grad():
        tl, tc = tT.prefill(tp, tcfg, torch.from_numpy(toks),
                            frontend_embeds=torch.from_numpy(patches),
                            pad_to=n + 6)
    assert tl.shape == (2, 1, jcfg.vocab_size)
    _close(tl, jl, MODEL_TOL)
    assert tc["pos"] == int(jc["pos"]) == n
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key], MODEL_TOL)
    jstep = jax.jit(lambda p, t, c: jT.decode_step(p, jcfg, t, c))
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jstep(jp, jnp.asarray(tok), jc)
        with torch.no_grad():
            tl, tc = tT.decode_step(tp, tcfg, torch.from_numpy(tok), tc)
        _close(tl, jl, MODEL_TOL)
    assert tc["pos"] == int(jc["pos"]) == n + 3
    _close(tc["k"], jc["k"], MODEL_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_three_decode_steps_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(26)
    toks = rng.integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    jl, jc = jT.prefill(jp, jcfg, jnp.asarray(toks), pad_to=14)
    with torch.no_grad():
        tl, tc = tT.prefill(tp, tcfg, torch.from_numpy(toks), pad_to=14)
    _close(tl, jl, MODEL_TOL)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = jT.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        with torch.no_grad():
            tl, tc = tT.decode_step(tp, tcfg, torch.from_numpy(tok), tc)
        _close(tl, jl, MODEL_TOL)
    _close(tc["v"], jc["v"], MODEL_TOL)


def test_params_from_jax_carries_the_frontend_projection():
    _, _, jp, _ = _model("llava")
    tp = tT.params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                            dtype="bfloat16")
    want = np.array(jp["frontend_proj"]["kernel"])
    got = tp["frontend_proj"]["kernel"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert torch.equal(got, torch.from_numpy(want).to(torch.bfloat16))
