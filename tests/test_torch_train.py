"""The port's training pieces against the JAX reference on the CPU: the
flash attention VJP and the other backward passes, the optimizer, the
losses, rematerialisation, gradient accumulation, a step above the flash
threshold, and the SSD gradient repair.

Inputs come from numpy seeds; model parameters from the reference's
``api.init`` carried over as f32 masters (``params_from_jax``).  The flash
backward is held against ``jax.vjp`` of the reference's
``flash_attention`` itself (its custom VJP; the model reaches it only above
``FLASH_THRESHOLD``) at f32 rtol = atol = 1e-5; the optimizer at 1e-6;
accumulation at the reference's own 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import api as japi
from repro.models import attention as jA
from repro.models import dlrm as jdlrm
from repro.models import layers as jL
from repro.models import mamba2 as jM2
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jT
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.models import api as tapi
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import layers as tL
from repro_torch.models import mamba2 as tM2
from repro_torch.models import transformer as tT
from repro_torch.train import optimizer as topt
from repro_torch.train import steps as tsteps

from _torch_train_helpers import TRAIN_FILE_ARCHS, check_train_step

FLASH_TOL = {"rtol": 1e-5, "atol": 1e-5}
OPT_TOL = {"rtol": 1e-6, "atol": 1e-6}


def _np(t):
    return t.detach().numpy()


def tiny_cfg(cls=ModelConfig, **kw):
    """The reference suite's tiny LM (tests/test_train_and_runtime.py)."""
    return cls(name="tiny", family="dense", n_layers=2, d_model=32,
               n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
               dtype="float32", remat="none", **kw)


def tiny_params(seed: int = 0):
    jp = japi.init(jax.random.PRNGKey(seed), tiny_cfg(JModelConfig), 1)
    return jp, tT.params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                                  dtype="float32")


def grads_of(params, cfg, batch, **kw):
    """(loss, gradient leaves in the optimizer's order) of the port."""
    flat = topt.leaves(params)
    for p in flat:
        p.requires_grad_(True)
        p.grad = None
    logits, aux = tapi.forward(params, cfg, batch, **kw)
    loss = tapi.loss(cfg, logits, batch["labels"], aux)
    loss.backward()
    grads = [p.grad.clone() for p in flat]
    for p in flat:
        p.requires_grad_(False)
        p.grad = None
    return loss.detach(), grads


def rel_fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# flash attention: lse and the backward
# ---------------------------------------------------------------------------


FLASH_CASES = [(c, w, cap, heads)
               for c in (True, False) for w in (0, 8) for cap in (0.0, 50.0)
               for heads in ((4, 2, 16), (4, 2, 8))]


def _qkv(seed, b, s, h, kh, hd):
    rng = np.random.default_rng(seed)
    q = 2.0 * rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, kh, hd), dtype=np.float32)
            for _ in range(2))
    return q, k, v


def _jcfg(cap):
    return tiny_cfg(JModelConfig, attn_logit_softcap=cap)


@pytest.mark.parametrize("causal,window,cap,heads", FLASH_CASES)
def test_flash_vjp_matches_the_reference(causal, window, cap, heads):
    h, kh, hd = heads
    q, k, v = _qkv(hd + window + int(cap) + causal, 2, 32, h, kh, hd)
    dout = np.random.default_rng(7).standard_normal(
        (2, 32, h * hd), dtype=np.float32)
    cfg = _jcfg(cap)
    out, vjp = jax.vjp(lambda a, b, c: jA.flash_attention(
        cfg, a, b, c, window, causal, 16, 16), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_out = ops.flash_attention_op(tq, tk, tv, causal=causal,
                                     window=window, softcap=cap)
    np.testing.assert_allclose(_np(got_out).reshape(2, 32, -1),
                               np.asarray(out), **FLASH_TOL)
    got = torch.autograd.grad(got_out, (tq, tk, tv),
                              torch.from_numpy(dout).view(got_out.shape))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **FLASH_TOL)


@pytest.mark.parametrize("causal,window,cap,heads", FLASH_CASES[::3])
def test_flash_lse_matches_the_reference(causal, window, cap, heads):
    h, kh, hd = heads
    q, k, v = _qkv(hd + 1, 2, 32, h, kh, hd)
    out, lse = jA._flash_fwd_impl(_jcfg(cap), *map(jnp.asarray, (q, k, v)),
                                  window=window, causal=causal, cq=16, ck=16)
    kw = {"causal": causal, "window": window, "softcap": cap}
    got, got_lse = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       return_lse=True, **kw)
    assert got_lse.shape == lse.shape == (2, kh, h // kh, 32)
    np.testing.assert_allclose(_np(got_lse), np.asarray(lse), **FLASH_TOL)
    np.testing.assert_allclose(_np(got).reshape(2, 32, -1), np.asarray(out),
                               **FLASH_TOL)
    # what the kernel computes at hd 8: zero-padded to 16, hd 8's scale
    qp, kp, vp, scale = tfa.pad_head_dim(*map(torch.from_numpy, (q, k, v)))
    pout, plse = tref.flash_attention_ref(qp, kp, vp, scale=scale,
                                          return_lse=True, **kw)
    np.testing.assert_allclose(_np(plse), np.asarray(lse), **FLASH_TOL)
    np.testing.assert_allclose(_np(pout[..., :hd]).reshape(2, 32, -1),
                               np.asarray(out), **FLASH_TOL)


def test_flash_lse_of_a_row_without_keys():
    # S > T, non-causal but windowed past every key: rows 10.. admit none
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 12, 2, 2, 16))
    out, lse = tref.flash_attention_ref(q, k[:, :4], v[:, :4], causal=False,
                                        window=7, return_lse=True)
    assert torch.all(out[:, 10:] == 0)
    np.testing.assert_allclose(_np(lse[..., 10:]), np.log(1e-30),
                               rtol=1e-6)
    assert torch.isfinite(lse).all()


def test_flash_backward_chunks_change_no_value():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 40, 4, 2, 16))
    out, lse = tref.flash_attention_ref(q, k, v, window=9, softcap=30.0,
                                        return_lse=True)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    whole = flash_attention_bwd(q, k, v, out, lse, dout, window=9,
                                softcap=30.0)
    tiled = flash_attention_bwd(q, k, v, out, lse, dout, window=9,
                                softcap=30.0, chunk=7)
    for a, b in zip(whole, tiled):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_flash_op_goes_through_the_function_only_under_grad():
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 1, 8, 2, 2, 16))
    assert ops.flash_attention_op(q, k, v).grad_fn is None
    q.requires_grad_()
    out = ops.flash_attention_op(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert ops.flash_attention_op(q, k, v).grad_fn is None


# ---------------------------------------------------------------------------
# the other backward passes
# ---------------------------------------------------------------------------


def _wkv(seed, b=1, s=64, h=2, logw_mean=-3.0):
    """The reference suite's WKV inputs with log-decays -exp(N(mean, 1)).
    At mean 0 a chunk's decays sum past 88 and the reference's
    ``wkv_chunked`` overflows above its diagonal, where its gradient is NaN
    (see the test below); at -3 it stays finite."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, 64), dtype=np.float32)
               for _ in range(3))
    w = -np.exp(rng.standard_normal((b, s, h, 64), dtype=np.float32)
                + np.float32(logw_mean))
    u = 0.5 * rng.standard_normal((h, 64), dtype=np.float32)
    s0 = 0.1 * rng.standard_normal((b, h, 64, 64), dtype=np.float32)
    return r, k, v, w, u, s0


# the WKV forms' stated tolerance (tests/test_torch_kernels.py): atol 5e-4
# elementwise beside a relative Frobenius error of 1e-5
WKV_TOL = {"rtol": 1e-5, "atol": 5e-4}


def test_wkv_vjp_matches_jax_grad_of_wkv_chunked():
    x = _wkv(11)
    rng = np.random.default_rng(12)
    do = rng.standard_normal((1, 64, 2, 64), dtype=np.float32)
    ds = rng.standard_normal((1, 2, 64, 64), dtype=np.float32)

    def f(*a):
        out, st = jrwkv.wkv_chunked(*a, chunk=32)
        return jnp.sum(out * do) + jnp.sum(st * ds)

    want = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, x))
    tx = [torch.from_numpy(a).requires_grad_() for a in x]
    out, st = ops.rwkv6_wkv_op(*tx, chunk=32)
    assert type(out.grad_fn).__name__ == "Rwkv6WkvFnBackward"
    got = torch.autograd.grad((out, st), tx, (torch.from_numpy(do),
                                              torch.from_numpy(ds)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **WKV_TOL)
        assert rel_fro(_np(g), w) < 1e-5


def test_wkv_vjp_stays_finite_where_the_reference_overflows():
    x = _wkv(13, logw_mean=1.0)

    def f(*a):
        out, st = jrwkv.wkv_chunked(*a, chunk=32)
        return jnp.sum(out) + jnp.sum(st)

    jg = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, x))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)
    tx = [torch.from_numpy(a).requires_grad_() for a in x]
    out, st = ops.rwkv6_wkv_op(*tx, chunk=32)
    got = torch.autograd.grad(out.sum() + st.sum(), tx)
    t64 = [torch.from_numpy(a).double().requires_grad_() for a in x]
    out, st = tref.rwkv6_wkv_ref(*t64)
    want = torch.autograd.grad(out.sum() + st.sum(), t64)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert rel_fro(_np(g), _np(w)) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_vjp_matches_the_reference(dtype, plus_one):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32)
    sc = 0.3 * rng.standard_normal((48,), dtype=np.float32)
    g = rng.standard_normal((2, 5, 48), dtype=np.float32)
    jdt = jnp.dtype(dtype)
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    out, vjp = jax.vjp(lambda s, a: jL._rmsnorm_cvjp(s, a, 1e-6, plus_one),
                       jnp.asarray(sc), jx)
    dsc, dx = vjp(jg)
    tdt = getattr(torch, dtype)
    tsc = torch.from_numpy(sc).requires_grad_()
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tout = tL.rmsnorm({"scale": tsc}, tx, 1e-6, plus_one)
    assert tout.dtype == tdt
    tdsc, tdx = torch.autograd.grad(
        tout, (tsc, tx), torch.from_numpy(g).to(tdt))
    assert tdx.dtype == tdt and tdsc.dtype == torch.float32
    tol = FLASH_TOL if dtype == "float32" else {"rtol": 1e-2, "atol": 1e-2}
    np.testing.assert_allclose(_np(tout.float()),
                               np.asarray(out, np.float32), **tol)
    np.testing.assert_allclose(_np(tdx.float()), np.asarray(dx, np.float32),
                               **tol)
    np.testing.assert_allclose(_np(tdsc), np.asarray(dsc), **tol)


def test_kernel_ops_without_a_backward_raise_on_tracked_inputs(monkeypatch):
    # the dispatch predicate sends CPU tensors to the kernels here (whose
    # wrappers take their plain versions on the CPU): a tracked table or z
    # goes through the op's autograd Function, and a bag's mask, which has
    # no backward, is refused before any launch
    monkeypatch.setattr(ops, "use_kernel", lambda impl, t: True)
    z = torch.randn(4, 3, 8, requires_grad=True)
    assert type(ops.dot_interaction_op(z).grad_fn).__name__ == \
        "DotInteractionFnBackward"
    table = torch.randn(10, 8, requires_grad=True)
    idx = torch.zeros(4, 2, dtype=torch.int32)
    mask = torch.ones(4, 2)
    calls = (lambda t, w: ops.embedding_bag_op(t, idx, w),
             lambda t, w: ops.embedding_bag_stacked_op(t[None], idx[:, None],
                                                       w[:, None]),
             lambda t, w: ops.embedding_bag_rows_op(
                 t[None], torch.zeros(4, dtype=torch.int32), idx, w))
    for call in calls:
        assert type(call(table, mask).grad_fn).__name__ == \
            "EmbeddingBagFnBackward"
        with pytest.raises(RuntimeError, match="no backward"):
            call(table.detach(), mask.clone().requires_grad_())


# ---------------------------------------------------------------------------
# the optimizer and the losses
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((6, 5), dtype=np.float32)},
            "b": rng.standard_normal((7,), dtype=np.float32),
            "c": 3.0 * rng.standard_normal((2, 3, 4), dtype=np.float32)}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_adamw_update_matches_the_reference():
    params, g1, g2 = _tree(0), _tree(1), _tree(2)
    jp, js = params, jopt.adamw_init(params)
    tp = _torch_tree(params)
    ts = topt.adamw_init(tp)
    for step, g in enumerate((g1, g2, g1)):
        lr = jopt.cosine_schedule(js["count"], peak_lr=1e-2, warmup=2,
                                  total=10)
        tlr = topt.cosine_schedule(ts["count"], peak_lr=1e-2, warmup=2,
                                   total=10)
        np.testing.assert_allclose(float(tlr), float(lr), **OPT_TOL)
        jp, js = jopt.adamw_update(g, js, jp, lr)
        tp, ts = topt.adamw_update(_torch_tree(g), ts, tp, tlr)
        assert ts["count"].dtype == torch.int32
        assert int(ts["count"]) == int(js["count"]) == step + 1
        for a, b in zip(topt.leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(_np(a), np.asarray(b), **OPT_TOL)
        for key in ("m", "v"):
            for a, b in zip(topt.leaves(ts[key]), jax.tree.leaves(js[key])):
                np.testing.assert_allclose(_np(a), np.asarray(b), **OPT_TOL)


@pytest.mark.parametrize("step", [0, 5, 10, 50, 100, 200])
def test_cosine_schedule_matches_the_reference(step):
    want = jopt.cosine_schedule(jnp.int32(step), peak_lr=1e-3, warmup=10,
                                total=100)
    got = topt.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                               peak_lr=1e-3, warmup=10, total=100)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **OPT_TOL)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _tree(4)
    want, wnorm = jopt.clip_by_global_norm(g, max_norm)
    got, norm = topt.clip_by_global_norm(_torch_tree(g), max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), **OPT_TOL)
    for a, b in zip(topt.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **OPT_TOL)


def test_grad_clip_like_the_reference_suite():
    clipped, norm = topt.clip_by_global_norm({"a": torch.full((4,), 10.0)},
                                             1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0)


@pytest.mark.parametrize("aux", [None, 0.37])
def test_lm_loss_matches_the_reference(aux):
    rng = np.random.default_rng(5)
    logits = 3.0 * rng.standard_normal((2, 7, 11), dtype=np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 6] = -5
    ja = None if aux is None else jnp.float32(aux)
    ta = None if aux is None else torch.tensor(aux, dtype=torch.float32)
    want = jT.lm_loss(jnp.asarray(logits), jnp.asarray(labels), ja)
    got = tT.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels), ta)
    np.testing.assert_allclose(float(got), float(want), **OPT_TOL)
    every = np.full((2, 7), -1, np.int32)
    assert float(tT.lm_loss(torch.from_numpy(logits),
                            torch.from_numpy(every))) == 0.0


def test_bce_loss_matches_the_reference():
    rng = np.random.default_rng(6)
    logits = 30.0 * rng.standard_normal((64,), dtype=np.float32)
    labels = (rng.random(64) < 0.3).astype(np.float32)
    want = jdlrm.bce_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tdlrm.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), **OPT_TOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _batch(seed, b, s, vocab=128):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())})


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_remat_policies_give_the_full_remat_gradients(remat):
    _, tp = tiny_params(3)
    _, tb = _batch(3, 2, 16)
    cfg = tiny_cfg()
    loss, full = grads_of(tp, cfg.replace(remat="full"), tb)
    loss2, other = grads_of(tp, cfg.replace(remat=remat), tb)
    assert float(loss) == float(loss2)
    for a, b in zip(full, other):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_full_recomputes_each_layer_once(monkeypatch):
    calls = []
    real = tT.block_full
    monkeypatch.setattr(tT, "block_full",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tp = tiny_params(4)
    _, tb = _batch(4, 2, 16)
    grads_of(tp, tiny_cfg().replace(remat="full"), tb)
    assert len(calls) == 2 * 2   # 2 layers, forward and recompute
    calls.clear()
    grads_of(tp, tiny_cfg(), tb)
    assert len(calls) == 2


def test_grad_accumulation_equivalent():
    jp, tp = tiny_params(1)
    _, tb = _batch(11, 8, 16)
    cfg = tiny_cfg()
    runs = []
    for accum in (1, 4):
        p = jax.tree.map(lambda t: t.clone(), tp)
        step = tsteps.make_train_step(cfg, accum_steps=accum)
        p, st, m = step(p, topt.adamw_init(p), tb)
        assert int(st["count"]) == 1
        runs.append((p, m))
    (p1, m1), (p4, m4) = runs
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               atol=1e-5)
    for a, b in zip(topt.leaves(p1), topt.leaves(p4)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    # and the reference's accumulated step on the same parameters
    jb = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tb)
    js = jax.jit(jsteps.make_train_step(tiny_cfg(JModelConfig),
                                        accum_steps=4))
    jp4, _, jm = js(jp, jopt.adamw_init(jp), jb)
    np.testing.assert_allclose(float(m4["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m4["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for a, b in zip(topt.leaves(p4), jax.tree.leaves(jp4)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)


def test_loss_decreases_over_steps():
    _, tp = tiny_params(0)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 128, (4, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    step = tsteps.make_train_step(tiny_cfg(), peak_lr=1e-2)
    st = topt.adamw_init(tp)
    losses = []
    for _ in range(30):
        tp, st, m = step(tp, st, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    assert all(not p.requires_grad and p.grad is None
               for p in topt.leaves(tp))


def test_step_above_the_flash_threshold_matches_the_reference():
    # S 4096 > FLASH_THRESHOLD: the reference's forward and backward run
    # its scan flash and custom VJP (1024-query tiles)
    s = 4096
    assert s > jA.FLASH_THRESHOLD
    jp, tp = tiny_params(2)
    jb, tb = _batch(2, 1, s)
    cfg, jcfg = tiny_cfg(), tiny_cfg(JModelConfig)

    def jloss(p):
        logits, aux = japi.forward(p, jcfg, jb, remat=True)
        return japi.loss(jcfg, logits, jb["labels"], aux)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jp)
    loss, got = grads_of(tp, cfg, tb)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(got, jax.tree.leaves(want)):
        assert rel_fro(_np(g), w) < 1e-4


@pytest.mark.parametrize("arch", TRAIN_FILE_ARCHS)
def test_train_step_matches_the_reference(arch):
    # the other archs run in tests/test_torch_train_runtime.py
    check_train_step(arch)


# ---------------------------------------------------------------------------
# the SSD gradient repair
# ---------------------------------------------------------------------------


def _ssd_inputs(seed):
    rng = np.random.default_rng(seed)
    b, s, h, p, n = 1, 16, 2, 4, 3
    x = rng.standard_normal((b, s, h, p))
    dt = np.full((b, s, h), 8.0)       # decay exp(-e^A_log * 8) per token
    a_log = np.log(np.full((h,), 12.0))
    bb, cc = (rng.standard_normal((b, s, n)) for _ in range(2))
    d = rng.standard_normal((h,))
    st = np.zeros((b, h, p, n))
    return [a.astype(np.float32) for a in (x, dt, a_log, bb, cc, d, st)]


def test_ssd_chunked_gradient_is_finite_where_the_exponent_overflows():
    # the in-chunk exponent above the diagonal reaches 96 * 15 = 1440:
    # exp overflows in f32 and the reference's masked branch gives NaN
    args = _ssd_inputs(0)

    def jf(x, dt, bb, cc):
        y, st = jM2.ssd_chunked(x, dt, jnp.asarray(args[2]), bb, cc,
                                jnp.asarray(args[5]), jnp.asarray(args[6]),
                                chunk=16)
        return jnp.sum(y) + jnp.sum(st)

    jg = jax.grad(jf, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (args[0], args[1], args[3], args[4])))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)

    def port(dtype, fn, **kw):
        t = [torch.from_numpy(a).to(dtype) for a in args]
        for i in (0, 1, 3, 4):
            t[i].requires_grad_()
        y, st = fn(*t, **kw)
        (y.sum() + st.sum()).backward()
        return [t[i].grad for i in (0, 1, 3, 4)], y.detach()

    got, y = port(torch.float32, tM2.ssd_chunked, chunk=16)
    want, y64 = port(torch.float64, tM2.ssd_recurrent)
    np.testing.assert_allclose(_np(y), _np(y64), rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)


def test_ssd_chunked_forward_is_unchanged_below_the_diagonal():
    args = [torch.from_numpy(a) for a in _ssd_inputs(1)]
    args[1] = args[1] / 40.0       # ordinary decays: nothing overflows
    y, st = tM2.ssd_chunked(*args, chunk=8)
    jy, jst = jM2.ssd_chunked(*map(jnp.asarray, (a.numpy() for a in args)),
                              chunk=8)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(st), np.asarray(jst), rtol=1e-5,
                               atol=1e-5)
