"""The port's dense LM serving path (configs, layers, attention, transformer,
api, steps, LMEngine, the serve CLI) against the JAX reference on the same
inputs, on the CPU.

Parameters come from the reference's ``api.init`` and cross over as numpy
(``params_from_jax``), so no RNG has to match.  Layers are held at f32
rtol = atol = 1e-6; prefill and decode logits and caches at f32
rtol = atol = 1e-4 (sums in other orders through several layers, and the
port's attention is the flash function's plain version where the reference
runs ``_sdpa``).  Config copies are held exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_9b as jgemma
from repro.configs import qwen3_14b as jqwen
from repro.models import api as japi
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.serving import engine as jengine
from repro_torch.configs import base as tbase
from repro_torch.configs import gemma2_9b as tgemma
from repro_torch.configs import qwen3_14b as tqwen
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.serving.engine import LMEngine
from repro_torch.train import steps as tsteps

LAYER_TOL = {"rtol": 1e-6, "atol": 1e-6}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
ARCHS = {"gemma2": (jgemma, tgemma), "qwen3": (jqwen, tqwen)}


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
def test_config_copies_match_the_reference(arch, which):
    j, t = (getattr(m, which) for m in ARCHS[arch])
    j, t = (j() if callable(j) else j), (t() if callable(t) else t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_registry_resolves_the_lm_archs():
    assert tbase.get_arch("gemma2-9b").config == tgemma.CONFIG
    assert tbase.get_arch("qwen3-14b").smoke() == tqwen.smoke()
    assert tbase.get_arch("gemma2-9b").shapes == tbase.LM_SHAPES
    assert "long_500k" in tbase.get_arch("qwen3-14b").skips
    assert tbase.get_arch("dlrm-kaggle").config.name == "dlrm-kaggle"


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm(plus_one):
    x, w = _x(0, (3, 5, 32)), 0.1 * _x(1, (32,))
    ref = jL.rmsnorm({"scale": jnp.asarray(w)}, jnp.asarray(x), 1e-6,
                     plus_one)
    port = tL.rmsnorm({"scale": torch.from_numpy(w)}, torch.from_numpy(x),
                      1e-6, plus_one)
    _close(port, ref, LAYER_TOL)


@pytest.mark.parametrize("theta,fraction,style",
                         [(10_000.0, 1.0, "neox"),
                          (1_000_000.0, 1.0, "neox"),
                          (10_000.0, 0.5, "glm2d")])
def test_apply_rope(theta, fraction, style):
    x = _x(2, (2, 24, 4, 16))
    pos = np.arange(24, dtype=np.int32)[None, :]
    ref = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction,
                        style)
    port = tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                         fraction, style)
    _close(port, ref, LAYER_TOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_glu_mlp(act):
    x = _x(3, (2, 7, 32))
    p = {"gate": 0.2 * _x(4, (32, 64)), "up": 0.2 * _x(5, (32, 64)),
         "down": 0.1 * _x(6, (64, 32))}
    ref = jL.glu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), act)
    port = tL.glu_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), act)
    _close(port, ref, LAYER_TOL)


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap(cap):
    x = 40.0 * _x(7, (4, 64))
    _close(tL.softcap(torch.from_numpy(x), cap),
           jL.softcap(jnp.asarray(x), cap), LAYER_TOL)


# ---------------------------------------------------------------------------
# the model: prefill, decode, generate
# ---------------------------------------------------------------------------

PROMPT, PAD, STEPS = 24, 40, 8


def _model(arch):
    jcfg, tcfg = ARCHS[arch][0].smoke(), ARCHS[arch][1].smoke()
    jp = japi.init(jax.random.PRNGKey(0), jcfg, 1)
    tp = tT.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_logits_match_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jl, jc = jT.prefill(jp, jcfg, jnp.asarray(toks), pad_to=PAD)
    with torch.no_grad():
        tl, tc = tT.prefill(tp, tcfg, torch.from_numpy(toks), pad_to=PAD)
    assert tl.shape == (2, 1, jcfg.vocab_size)
    _close(tl, jl, MODEL_TOL)
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape
        _close(tc[key], jc[key], MODEL_TOL)
    assert tc["pos"] == int(jc["pos"]) == PROMPT
    jstep = jax.jit(lambda p, t, c: jT.decode_step(p, jcfg, t, c))
    for _ in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jstep(jp, jnp.asarray(tok), jc)
        with torch.no_grad():
            tl, tc = tT.decode_step(tp, tcfg, torch.from_numpy(tok), tc)
        _close(tl, jl, MODEL_TOL)
    assert tc["pos"] == int(jc["pos"]) == PROMPT + STEPS
    _close(tc["k"], jc["k"], MODEL_TOL)


def test_forward_matches_jax_and_last_only_slices():
    jcfg, tcfg, jp, tp = _model("gemma2")
    toks = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, aux = tapi.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        last = tsteps.make_prefill_step(tcfg)(
            tp, {"tokens": torch.from_numpy(toks)})
        ref_impl, _ = tapi.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                   attn_impl="ref")
    _close(tl, jl, MODEL_TOL)
    assert float(aux) == 0.0
    # the head's matmul over one row may block differently from twenty
    torch.testing.assert_close(last, tl[:, -1:], **MODEL_TOL)
    assert torch.equal(ref_impl, tl)      # on the CPU "auto" is the plain path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_engine_generate_matches_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    prompts = np.random.default_rng(13).integers(
        0, jcfg.vocab_size, (3, PROMPT)).astype(np.int32)
    want = jengine.LMEngine(jp, jcfg, max_len=PAD).generate(prompts, STEPS)
    eng = LMEngine(tp, tcfg, max_len=PAD, device="cpu")
    got = eng.generate(prompts, STEPS)
    assert got.shape == (3, STEPS) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(eng.monitor.lat) == STEPS


def test_lm_engine_generate_past_max_len_matches_jax():
    """Decoding past the cache's end writes the last slot, as the
    reference's ``dynamic_update_slice`` clamps it, while rope and the mask
    keep the true position: 6-token prompts, ``max_len`` 8, 5 tokens."""
    jcfg, tcfg, jp, tp = _model("gemma2")
    prompts = np.random.default_rng(14).integers(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want = jengine.LMEngine(jp, jcfg, max_len=8).generate(prompts, 5)
    got = LMEngine(tp, tcfg, max_len=8, device="cpu").generate(prompts, 5)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)


def test_serve_step_takes_the_first_largest_logit():
    jcfg, tcfg, jp, tp = _model("qwen3")
    cache = tT.make_cache(tcfg, 2, 8, device="cpu")
    step = tsteps.make_serve_step(tcfg)
    tok, cache = step(tp, torch.tensor([[1], [2]], dtype=torch.int32), cache)
    assert tok.shape == (2, 1) and tok.dtype == torch.int32
    assert cache["pos"] == 1


# ---------------------------------------------------------------------------
# init, conversion, options
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_lm_has_the_reference_layout(arch):
    jcfg, tcfg, jp, _ = _model(arch)
    tp = tT.init_lm(0, tcfg.replace(dtype="bfloat16"), device="cpu")
    jl = {k: v.shape for k, v in _leaves(jax.tree.map(np.asarray, jp))}
    tl = dict(_leaves(tp))
    assert {k: tuple(v.shape) for k, v in tl.items()} == jl
    assert all(v.dtype == torch.bfloat16 for v in tl.values())
    norm = tl["layers/sub0/ln1/scale"]
    want = 0.0 if tcfg.norm_plus_one else 1.0
    assert torch.all(norm == want)
    wq = tl["layers/sub0/attn/wq/kernel"].float()
    scale = tcfg.d_model ** -0.5
    assert wq.abs().max() <= 2 * scale * (1 + 2 ** -7)
    assert 0.5 * scale < wq.std() < scale
    # groups are drawn one after another, not copies of one draw
    assert not torch.equal(wq[0], wq[1])
    again = tT.init_lm(0, tcfg.replace(dtype="bfloat16"), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(tp), _leaves(again)))


def test_params_from_jax_casts_f32_leaves():
    _, _, jp, _ = _model("qwen3")
    tp = tT.params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                            dtype="bfloat16")
    assert all(v.dtype == torch.bfloat16 for _, v in _leaves(tp))


@pytest.mark.parametrize("change,match", [
    ({"frontend": "audio_frames"}, "frontend"),
    ({"family": "hybrid"}, "zamba2"),
    ({"family": "audio"}, "whisper"),
    ({"frontend": "vision_patches"}, "frontend"),
])
def test_unported_options_raise(change, match):
    cfg = tqwen.smoke().replace(**change)
    with pytest.raises(NotImplementedError, match=match):
        tapi.init(0, cfg, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tgemma.smoke()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tT.init_lm(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tT.init_lm(0, tbase.get_arch("qwen2-moe-a2.7b").smoke())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tT.params_from_jax({"a": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tT.make_cache(cfg, 1, 4)
    tp = tT.init_lm(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        LMEngine(tp, cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tserve.main(["--arch", "qwen3-14b", "--smoke"])


def test_unknown_attn_impl_raises():
    _, tcfg, _, tp = _model("qwen3")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown impl"):
        tT.forward(tp, tcfg, toks, attn_impl="triton")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tT.decode_step(tp, tcfg, toks[:, :1],
                       tT.make_cache(tcfg, 1, 4, device="cpu"),
                       attn_impl="triton")


@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma2-9b", "qwen2-moe-a2.7b",
                                  "granite-moe-3b-a800m"])
def test_serve_cli_lm_branch_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--tokens", "3",
                 "--device", "cpu"])
    assert "generated (4, 3)" in capsys.readouterr().out


def test_serve_cli_dlrm_branch_on_cpu(capsys):
    tserve.main(["--arch", "dlrm-kaggle", "--smoke", "--batches", "2",
                 "--batch-size", "16", "--bound", "2", "--microbatches", "2",
                 "--device", "cpu"])
    assert "served 32 requests" in capsys.readouterr().out
