"""The port's whisper (``repro_torch.models.whisper``: encoder, cross K/V,
decoder, caches, decode) and the ``audio`` family through ``api``, the
prefill step and ``LMEngine`` against the JAX reference on the same
inputs, on the CPU, at the smoke config.

Parameters come from the reference's ``api.init`` through
``params_from_jax`` (a plain copy of its pytree).  Logits and caches are
held at f32 rtol = atol = 1e-4 (``MODEL_TOL``, as the dense LM: sums in
other orders through several layers, and the port's encoder attention is
the flash function's plain version where the reference runs ``_sdpa``);
generated tokens exactly.  ``sinusoids`` keeps the reference's f32
arithmetic, but XLA's CPU ``exp``, ``sin`` and ``cos`` round differently
from torch's in the last place (22 of the 192 frequencies of 384 channels
differ by an ulp, and the angle t * inv carries it), so the tables are held
within two ulps of the largest angle, not bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_tiny as jwh
from repro.models import api as japi
from repro.models import whisper as jW
from repro.serving import engine as jengine
from repro_torch.configs import whisper_tiny as twh
from repro_torch.models import api as tapi
from repro_torch.models import transformer as tT
from repro_torch.models import whisper as tW
from repro_torch.serving.engine import LMEngine
from repro_torch.train import steps as tsteps

MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
B, S_ENC, S_DEC, MAX_LEN = 2, 24, 12, 20


def _close(port, ref, tol=MODEL_TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jwh.smoke(), twh.smoke()
    jp = japi.init(jax.random.PRNGKey(0), jcfg, 1)
    tp = tT.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(seed, cfg, b=B, s_enc=S_ENC, s_dec=S_DEC):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, cfg.d_frontend),
                                 dtype=np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32)
    return frames, toks


@pytest.mark.parametrize("length,channels", [(1536, 384), (64, 64),
                                             (100, 20), (4864, 384)])
def test_sinusoids(length, channels):
    want = np.asarray(jW.sinusoids(length, channels))
    got = tW.sinusoids(length, channels)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2 * np.spacing(np.float32(length)))
    # position 0: sin 0 and cos 0 exactly
    assert torch.equal(got[0], torch.cat([torch.zeros(channels // 2),
                                          torch.ones(channels // 2)]))


def test_encode_and_cross_kv_match_jax(model):
    jcfg, tcfg, jp, tp = model
    frames, _ = _inputs(1, jcfg)
    je = jW.encode(jp, jcfg, jnp.asarray(frames))
    with torch.no_grad():
        te = tW.encode(tp, tcfg, torch.from_numpy(frames))
        plain = tW.encode(tp, tcfg, torch.from_numpy(frames),
                          attn_impl="ref")
    assert te.shape == (B, S_ENC, tcfg.d_model)
    _close(te, je)
    assert torch.equal(plain, te)      # on the CPU "auto" is the plain path
    jk, jv = jW._cross_kv(jp, jcfg, je)
    with torch.no_grad():
        tk, tv = tW._cross_kv(tp, tcfg, torch.from_numpy(np.array(je)))
    assert tk.shape == (tcfg.n_layers, B, S_ENC, tcfg.n_kv_heads,
                        tcfg.head_dim)
    _close(tk, jk, {"rtol": 1e-6, "atol": 1e-6})
    _close(tv, jv, {"rtol": 1e-6, "atol": 1e-6})


def test_encoder_attention_is_not_causal(model):
    """A later frame changes an earlier frame's encoding (it would not
    under a causal mask), as in the reference."""
    jcfg, tcfg, _, tp = model
    frames, _ = _inputs(2, jcfg)
    other = frames.copy()
    other[:, -1] += 1.0
    with torch.no_grad():
        a = tW.encode(tp, tcfg, torch.from_numpy(frames))
        b = tW.encode(tp, tcfg, torch.from_numpy(other))
    assert not torch.allclose(a[:, 0], b[:, 0], rtol=0, atol=1e-6)


def test_forward_with_caches_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    frames, toks = _inputs(3, jcfg)
    jl, jaux, (jkv, jcross) = jW.forward(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(frames), collect_cache=True,
        remat=False)
    with torch.no_grad():
        tl, taux, (tkv, tcross) = tW.forward(
            tp, tcfg, torch.from_numpy(toks), torch.from_numpy(frames),
            collect_cache=True)
        last, _ = tW.forward(tp, tcfg, torch.from_numpy(toks),
                             torch.from_numpy(frames), last_only=True)
    assert tl.shape == (B, S_DEC, tcfg.vocab_size) and float(taux) == 0.0
    _close(tl, jl)
    torch.testing.assert_close(last, tl[:, -1:], **MODEL_TOL)
    for got, want in zip(tkv + tcross, jkv + jcross):
        assert tuple(got.shape) == want.shape
        _close(got, want)


def test_make_cache_shapes(model):
    jcfg, tcfg, _, _ = model
    want = jW.make_cache(jcfg, 3, 17, 40)
    got = tW.make_cache(tcfg, 3, 17, 40, device="cpu")
    for key in ("self_k", "self_v", "cross_k", "cross_v"):
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[1] == str(want[key].dtype)
        assert not got[key].any()
    assert got["pos"] == int(want["pos"]) == 0
    api = tapi.make_cache(tcfg, 2, 9, device="cpu")
    jap = japi.make_cache(jcfg, 2, 9)
    assert {k: tuple(v.shape) for k, v in api.items() if k != "pos"} == \
        {k: v.shape for k, v in jap.items() if k != "pos"}
    assert api["cross_k"].shape[2] == tapi.AUDIO_ENC_LEN == 1536


def _cache_from_forward(kv, cross, s, max_len, pad):
    """The decode cache the forward's caches give: self K/V padded from
    ``s`` to ``max_len`` positions, the cross K/V as they are."""
    (k, v), (ck, cv) = kv, cross
    return {"self_k": pad(k, max_len - s), "self_v": pad(v, max_len - s),
            "cross_k": ck, "cross_v": cv, "pos": s}


def test_decode_steps_from_the_forward_cache_match_jax(model):
    jcfg, tcfg, jp, tp = model
    frames, toks = _inputs(4, jcfg)
    _, _, jkv, jcross = (lambda r: (r[0], r[1], *r[2]))(jW.forward(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(frames),
        collect_cache=True, remat=False))
    with torch.no_grad():
        _, _, (tkv, tcross) = tW.forward(
            tp, tcfg, torch.from_numpy(toks), torch.from_numpy(frames),
            collect_cache=True)
    jpad = lambda a, n: jnp.pad(a, [(0, 0), (0, 0), (0, n), (0, 0), (0, 0)])
    tpad = lambda a, n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, n))
    jc = _cache_from_forward(jkv, jcross, S_DEC, MAX_LEN, jpad)
    jc["pos"] = jnp.int32(S_DEC)
    tc = _cache_from_forward(tkv, tcross, S_DEC, MAX_LEN, tpad)
    rng = np.random.default_rng(5)
    jstep = jax.jit(lambda p, t, c: jW.decode_step(p, jcfg, t, c))
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jstep(jp, jnp.asarray(tok), jc)
        with torch.no_grad():
            tl, tc = tW.decode_step(tp, tcfg, torch.from_numpy(tok), tc)
        assert tl.shape == (B, 1, tcfg.vocab_size)
        _close(tl, jl)
    assert tc["pos"] == int(jc["pos"]) == S_DEC + 3
    for key in ("self_k", "self_v"):
        _close(tc[key], jc[key])


def test_api_forward_on_frames_and_the_prefill_step(model):
    jcfg, tcfg, jp, tp = model
    frames, toks = _inputs(6, jcfg)
    jl, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                    "frames": jnp.asarray(frames)})
    batch = {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)}
    with torch.no_grad():
        tl, aux = tapi.forward(tp, tcfg, batch)
    last = tsteps.make_prefill_step(tcfg)(tp, batch)
    _close(tl, jl)
    assert float(aux) == 0.0
    torch.testing.assert_close(last, tl[:, -1:], **MODEL_TOL)


def test_lm_engine_generate_matches_jax(model):
    """As the reference serves ``audio``: zero cross K/V over 1536 frames,
    the prompt fed token by token, then greedy steps."""
    jcfg, tcfg, jp, tp = model
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    want = jengine.LMEngine(jp, jcfg, max_len=MAX_LEN).generate(prompts, 6)
    eng = LMEngine(tp, tcfg, max_len=MAX_LEN, device="cpu")
    got = eng.generate(prompts, 6)
    assert got.shape == (3, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(eng.monitor.lat) == 6


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


def test_init_whisper_has_the_reference_layout(model):
    _, tcfg, jp, _ = model
    cfg = tcfg.replace(dtype="bfloat16")
    tp = tW.init_whisper(0, cfg, device="cpu")
    jl = {k: v.shape for k, v in _leaves(jax.tree.map(np.asarray, jp))}
    tl = dict(_leaves(tp))
    assert {k: tuple(v.shape) for k, v in tl.items()} == jl
    assert all(v.dtype == torch.bfloat16 for v in tl.values())
    assert torch.all(tl["enc_layers/ln1/scale"] == 1)
    assert torch.all(tl["dec_layers/mlp/fc1/bias"] == 0)
    assert torch.all(tl["frontend_proj/bias"] == 0)
    wq = tl["dec_layers/cross/wq/kernel"].float()
    scale = cfg.d_model ** -0.5
    assert wq.abs().max() <= 2 * scale * (1 + 2 ** -7)
    assert 0.5 * scale < wq.std() < scale
    fc2 = tl["enc_layers/mlp/fc2/kernel"].float()
    assert fc2.abs().max() <= 2 * cfg.d_ff ** -0.5 * (1 + 2 ** -7)
    # layers are drawn one after another, not copies of one draw
    assert not torch.equal(wq[0], wq[1])
    again = tW.init_whisper(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(tp), _leaves(again)))


def test_bf16_params_from_jax_run(model):
    """The reference's pytree cast to bf16 (every f32 leaf, as its
    apply-time cast) serves the same greedy tokens' shapes on the CPU."""
    jcfg, tcfg, jp, _ = model
    tp = tT.params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                            dtype="bfloat16")
    assert all(v.dtype == torch.bfloat16 for _, v in _leaves(tp))
    cfg = tcfg.replace(dtype="bfloat16")
    frames, toks = _inputs(8, jcfg)
    with torch.no_grad():
        logits, _ = tW.forward(tp, cfg, torch.from_numpy(toks),
                               torch.from_numpy(frames))
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()
