"""The port's model, data, wire and BLS modules against the JAX reference
on the same inputs, on the CPU.

Parameters come from the reference's ``init_dlrm`` and cross over as numpy
(``params_from_jax``), so no RNG has to match.  Logits are held at f32
rtol=1e-5, atol=1e-5 (sums in other orders); wire bytes, BLS accounting,
synthetic batches and the config copies are held exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_kaggle as jkaggle
from repro.core import alltoallv as ja2a
from repro.core import bls as jbls
from repro.data import synthetic as jsyn
from repro.models import dlrm as jdlrm
from repro.runtime import straggler as jstrag
from repro.serving import engine as jengine
from repro_torch.configs import base as tbase
from repro_torch.configs import dlrm_kaggle as tkaggle
from repro_torch.core import alltoallv as ta2a
from repro_torch.core import bls as tbls
from repro_torch.data import synthetic as tsyn
from repro_torch.models import dlrm as tdlrm
from repro_torch.runtime import straggler as tstrag
from repro_torch.runtime.freshness import FreshnessManager
from repro_torch.serving import hot_cache as thc
from repro_torch.serving.engine import DLRMEngine

LOGIT_TOL = {"rtol": 1e-5, "atol": 1e-5}
CFGS = ("smoke", "smoke_alicpp")


def _cfgs(name):
    return getattr(jkaggle, name)(), getattr(tkaggle, name)()


def _params(jcfg, n_shards=1, seed=0):
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(seed), jcfg, n_shards=n_shards)
    return jp, tdlrm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


# ---------------------------------------------------------------------------
# configs and synthetic traffic: exact copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CFGS + ("CONFIG", "ALICPP"))
def test_config_copies_match_the_reference(name):
    j = getattr(jkaggle, name)
    t = getattr(tkaggle, name)
    j, t = (j() if callable(j) else j), (t() if callable(t) else t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_registry():
    assert tbase.get_arch("dlrm-kaggle").config == tkaggle.CONFIG
    assert tbase.get_arch("dlrm-alicpp").smoke() == tkaggle.smoke_alicpp()
    with pytest.raises(KeyError):
        tbase.get_arch("zamba2-2.7b")     # no config copy in the port yet


@pytest.mark.parametrize("mode", ["uniform", "hetero", "powerlaw",
                                  "powerlaw_hetero", "drift"])
def test_make_batch_is_byte_identical(mode):
    for name in CFGS:
        jcfg, tcfg = _cfgs(name)
        jb = jsyn.make_batch(jcfg, 17, mode=mode, t_pad=8, seed=3, step=2,
                             phase=1)
        tb = tsyn.make_batch(tcfg, 17, mode=mode, t_pad=8, seed=3, step=2,
                             phase=1)
        for f in ("dense", "idx", "mask", "labels"):
            a, b = getattr(jb, f), getattr(tb, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)


def test_table_heat_and_sizes_match():
    assert tsyn.CRITEO_KAGGLE_TABLE_SIZES == jsyn.CRITEO_KAGGLE_TABLE_SIZES
    assert tsyn.ALI_CCP_TABLE_SIZES == jsyn.ALI_CCP_TABLE_SIZES
    for phase in range(3):
        np.testing.assert_array_equal(tsyn.table_heat(26, phase, seed=5),
                                      jsyn.table_heat(26, phase, seed=5))


# ---------------------------------------------------------------------------
# parameters and the local forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 16])
def test_init_matches_reference_shapes(n_shards):
    jcfg, tcfg = _cfgs("smoke")
    jp = jax.eval_shape(lambda: jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg,
                                                n_shards=n_shards))
    tp = tdlrm.init_dlrm(0, tcfg, n_shards=n_shards, device="cpu")
    js = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    ts = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), tp)
    assert js == ts
    again = tdlrm.init_dlrm(0, tcfg, n_shards=n_shards, device="cpu")
    assert torch.equal(tp["tables"], again["tables"])
    assert tp["tables"].abs().max() <= 2.0 / tcfg.embed_dim


def test_params_from_jax_is_a_plain_copy():
    jcfg, _ = _cfgs("smoke")
    jp, tp = _params(jcfg, n_shards=2)
    np.testing.assert_array_equal(tp["tables"].numpy(), jp["tables"])
    for part in ("bot", "top"):
        for jl, tl in zip(jp[part], tp[part]):
            assert jl.keys() == tl.keys()
            for k in jl:
                np.testing.assert_array_equal(tl[k].numpy(), jl[k])


@pytest.mark.parametrize("name", CFGS)
@pytest.mark.parametrize("mode", ["uniform", "hetero", "powerlaw"])
def test_forward_local_matches_jax(name, mode):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    b = jsyn.make_batch(jcfg, 48, mode=mode, seed=7)
    want = np.asarray(jdlrm.forward_local(jp, jcfg, b.dense, b.idx, b.mask))
    got = tdlrm.forward_local(tp, tcfg, *_t(b.dense, b.idx, b.mask))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("backend", ["ref", "interpret", "auto"])
def test_cpu_backends_agree(backend):
    jcfg, tcfg = _cfgs("smoke")
    _, tp = _params(jcfg)
    b = tsyn.make_batch(tcfg, 16, mode="hetero", seed=1)
    args = _t(b.dense, b.idx, b.mask)
    base = tdlrm.forward_local(tp, tcfg.replace(sparse_backend="ref"), *args)
    got = tdlrm.forward_local(tp, tcfg.replace(sparse_backend=backend),
                              *args)
    assert torch.equal(got, base)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdlrm.forward_local(tp, tcfg.replace(sparse_backend="pallas"), *args)


def test_no_group_falls_back_to_forward_local():
    jcfg, tcfg = _cfgs("smoke")
    _, tp = _params(jcfg)
    b = tsyn.make_batch(tcfg, 16, mode="hetero", seed=2)
    args = _t(b.dense, b.idx, b.mask)
    assert torch.equal(
        tdlrm.forward_distributed(tp, tcfg, *args, bound=1, microbatches=2),
        tdlrm.forward_local(tp, tcfg, *args))


# ---------------------------------------------------------------------------
# unported options raise; entry points default to the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"deltas": {}}, {"migration": {}}, {"repair": {}},
    {"quarantine": [1]}, {"table_inv": [0]}, {"wire_check": True},
    {"audit_words": [0]}])
def test_forward_distributed_refuses_unported_options(kw):
    """Every rider is ported (ROADMAP A10-A12).  Without a model group the
    ones that ride the exchange (deltas, migration and repair rows, the
    wire check, the audit words) raise as the reference's do without a
    mesh; quarantine
    and table_inv fall back to forward_local, as the reference's do.  The
    name, from when the riders were refused, is kept so the test count
    holds."""
    jcfg, tcfg = _cfgs("smoke")
    _, tp = _params(jcfg)
    b = tsyn.make_batch(tcfg, 8, seed=0)
    args = _t(b.dense, b.idx, b.mask)
    if set(kw) & {"deltas", "migration", "repair", "wire_check",
                  "audit_words"}:
        with pytest.raises(ValueError, match="model group"):
            tdlrm.forward_distributed(tp, tcfg, *args, **kw)
        return
    assert torch.equal(tdlrm.forward_distributed(tp, tcfg, *args, **kw),
                       tdlrm.forward_local(tp, tcfg, *args))


@pytest.mark.parametrize("kw", [
    {"wire_dtype": "bfloat16"}, {"wire_dtype": "int8"},
    {"exchange": "ragged"}, {"exchange_pipeline": "ring"},
    {"cache": "calibrated"}, {"return_diag": True}])
def test_forward_distributed_serves_the_exchange_options(kw):
    """Without a model group these options fall back to forward_local, as
    in the reference, warning where a cache or a lossy wire is inactive."""
    jcfg, tcfg = _cfgs("smoke")
    _, tp = _params(jcfg)
    b = tsyn.make_batch(tcfg, 8, mode="hetero", seed=0)
    args = _t(b.dense, b.idx, b.mask)
    if kw.get("cache") == "calibrated":
        kw = {"cache": thc.build_from_batch(tp["tables"], b.idx, b.mask, 4)}
    want = tdlrm.forward_local(tp, tcfg, *args)
    if "cache" in kw or kw.get("wire_dtype", "float32") != "float32":
        with pytest.warns(UserWarning, match="inactive"):
            got = tdlrm.forward_distributed(tp, tcfg, *args, **kw)
    else:
        got = tdlrm.forward_distributed(tp, tcfg, *args, **kw)
    if kw.get("return_diag"):
        got, diag = got
        assert (diag.exchange, diag.live_max, diag.drops) == ("local", 0, 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [
    {"freshness": "manager"}, {"rebalance": True}, {"scrub_budget": 4}])
def test_engine_refuses_unported_options(kw):
    """Freshness, rebalancing and scrubbing are ported (ROADMAP A10-A12):
    each is accepted and armed, beside the others, and one that writes the
    whole stack is refused on a member's shard.  The name, from when the
    options were refused, is kept so the test count holds."""
    jcfg, tcfg = _cfgs("smoke")
    _, tp = _params(jcfg)
    if "freshness" in kw:
        kw = {"freshness": FreshnessManager(iter(()))}
    eng = DLRMEngine(tp, tcfg, batch_size=8, device="cpu", **kw)
    assert eng.freshness is kw.get("freshness")
    assert eng.rebalance == bool(kw.get("rebalance"))
    assert (eng.scrub is not None) == ("scrub_budget" in kw)
    if eng.scrub is not None:
        assert eng.scrub.budget == 4 and eng.scrub.mirror is not None
    both = DLRMEngine(tp, tcfg, batch_size=8, device="cpu",
                      **{"rebalance": True, "scrub_budget": 2, **kw})
    assert both.rebalance and both.scrub is not None
    shard = dict(tp, tables=tp["tables"][:3])
    with pytest.raises(ValueError, match="whole"):
        DLRMEngine(shard, tcfg, batch_size=8, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    {"faults": object()}, {"freshness": object()}, {"rebalance": True},
    {"scrub_budget": 4}])
def test_engine_refuses_options_with_the_plan_pipeline(kw):
    """The reference's mutual exclusions: each of these drives the
    synchronous flush path, which the pipeline's deferred harvest would
    tear."""
    jcfg, tcfg = _cfgs("smoke")
    jp, tp = _params(jcfg)
    with pytest.raises(ValueError, match="plan_pipeline"):
        DLRMEngine(tp, tcfg, batch_size=8, device="cpu", plan_pipeline=True,
                   **kw)
    with pytest.raises(ValueError, match="plan_pipeline"):
        jengine.DLRMEngine(jp, jcfg, batch_size=8, plan_pipeline=True, **kw)


@pytest.mark.parametrize("kw", [{"plan_pipeline": True},
                                {"faults": "injector"},
                                {"deadline_s": 0.5, "on_deadline": "evict"}])
def test_engine_serves_plans_and_chaos_options(kw):
    """Without a model group these engines serve forward_local's CTRs (the
    plan pipeline one flush late)."""
    from repro_torch.runtime.faults import FaultInjector, FaultPlan

    jcfg, tcfg = _cfgs("smoke")
    _, tp = _params(jcfg)
    if kw.get("faults") == "injector":
        kw = {"faults": FaultInjector(FaultPlan.none(1, 4))}
    b = tsyn.make_batch(tcfg, 16, mode="hetero", seed=3)
    eng = DLRMEngine(tp, tcfg, batch_size=8, device="cpu", **kw)
    got = [o for i in range(16)
           if (o := eng.submit(b.dense[i], b.idx[i], b.mask[i])) is not None]
    tail = eng.drain()
    if tail is not None:
        got.append(tail)
    want = torch.sigmoid(tdlrm.forward_local(tp, tcfg,
                                             *_t(b.dense, b.idx, b.mask)))
    assert torch.equal(torch.from_numpy(np.concatenate(got)), want)
    assert eng.stats.batches == 2


@pytest.mark.parametrize("kw", [
    {"wire_dtype": "bf16"}, {"wire_dtype": "int8"}, {"exchange": "ragged"},
    {"exchange_pipeline": "ring"}, {"exchange": "auto", "ragged_cap": 8}])
def test_engine_takes_the_exchange_options(kw):
    jcfg, tcfg = _cfgs("smoke")
    _, tp = _params(jcfg)
    eng = DLRMEngine(tp, tcfg, batch_size=8, device="cpu", retune_every=2,
                     **kw)
    b = tsyn.make_batch(tcfg, 8, mode="hetero", seed=1)
    cache = eng.calibrate_cache(b.idx, b.mask, 4)
    assert eng.cache is cache and cache.cache_rows == 4
    eng.adopt_cache(None)
    assert eng.cache is None
    assert eng.retune_cap() is None             # nothing observed yet


def test_entry_points_default_to_cuda():
    assert not torch.cuda.is_available()
    jcfg, tcfg = _cfgs("smoke")
    jp, tp = _params(jcfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdlrm.init_dlrm(0, tcfg, n_shards=1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tdlrm.params_from_jax(jax.tree.map(np.asarray, jp))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DLRMEngine(tp, tcfg, batch_size=8)


# ---------------------------------------------------------------------------
# the fused wire: byte-identical to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,bs,t_loc,s", [(1, 4, 8, 16), (2, 3, 4, 8),
                                          (4, 2, 7, 64)])
def test_dense_wire_bytes_match_jax(p, bs, t_loc, s):
    jl = ja2a.exchange_wire_layout(ragged=False, n_dest=p, cap=bs * t_loc,
                                   bs=bs, t_loc=t_loc, embed_dim=s)
    tl = ta2a.exchange_wire_layout(ragged=False, n_dest=p, cap=bs * t_loc,
                                   bs=bs, t_loc=t_loc, embed_dim=s)
    assert (tl.n_dest, tl.slot_bytes, tl.names) == \
        (jl.n_dest, jl.slot_bytes, jl.names)
    assert [(f.offset, f.shape, f.dtype) for f in tl.fields] == \
        [(f.offset, f.shape, f.dtype) for f in jl.fields]
    pooled = np.random.default_rng(p).standard_normal(
        (p * bs, t_loc, s), dtype=np.float32)
    pooled[0, 0, :3] = [np.nan, -0.0, np.inf]
    jbuf = ja2a.fuse_wire({"q": jnp.asarray(pooled).reshape(p, bs, t_loc, s)},
                          jl)
    tbuf = ta2a.fuse_wire(
        {"q": torch.from_numpy(pooled).reshape(p, bs, t_loc, s)}, tl)
    assert tbuf.dtype == torch.uint8
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    back = ta2a.decode_wire(ta2a.defuse_wire(tbuf, tl))
    assert torch.equal(back.view(torch.int32),
                       torch.from_numpy(pooled).reshape(p, bs, t_loc, s)
                       .view(torch.int32))


def test_mixed_layout_bytes_match_jax():
    # a layout that needs padding and mixes widths, as the ragged and
    # rider layouts will: fuse/defuse stays bitcast-exact
    fields = {"q": ((3, 5), "float32"), "ids": ((3,), "int16"),
              "counts": ((1,), "int32"), "tag": ((3,), "uint8")}
    jl = ja2a.wire_layout(2, {k: (s, jnp.dtype(d))
                              for k, (s, d) in fields.items()})
    tl = ta2a.wire_layout(2, {k: (s, getattr(torch, d))
                              for k, (s, d) in fields.items()})
    assert tl.slot_bytes == jl.slot_bytes and tl.slot_bytes % 4 == 0
    rng = np.random.default_rng(0)
    payload = {"q": rng.standard_normal((2, 3, 5), dtype=np.float32),
               "ids": rng.integers(-300, 300, (2, 3)).astype(np.int16),
               "counts": np.array([[3], [1]], np.int32),
               "tag": rng.integers(0, 255, (2, 3)).astype(np.uint8)}
    jbuf = ja2a.fuse_wire({k: jnp.asarray(v) for k, v in payload.items()},
                          jl)
    tbuf = ta2a.fuse_wire({k: torch.from_numpy(v)
                           for k, v in payload.items()}, tl)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    back = ta2a.defuse_wire(tbuf, tl)
    for k, v in payload.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    chunk = ta2a.defuse_wire(tbuf[1], tl)
    np.testing.assert_array_equal(chunk["ids"].numpy(), payload["ids"][1])


def test_wire_codecs():
    for spelling in (None, "f32", "float32", "bf16", "int8"):
        assert ta2a.canon_wire(spelling) == ja2a.canon_wire(spelling)
    with pytest.raises(ValueError):
        ta2a.canon_wire("fp8")
    x = torch.randn(3, 4)
    assert ta2a.encode_wire(x, "float32")["q"] is x
    for codec in ("bfloat16", "int8"):
        jp = ja2a.encode_wire(jnp.asarray(x.numpy()), codec)
        tp = ta2a.encode_wire(x, codec)
        assert sorted(tp) == sorted(jp)
        for k in jp:
            np.testing.assert_array_equal(
                tp[k].view(torch.int16 if tp[k].dtype == torch.bfloat16
                           else tp[k].dtype).numpy(),
                np.asarray(jp[k]).view(np.int16 if k == "scale" or
                                       codec == "bfloat16" else np.int8))
    with pytest.raises(ValueError):
        ta2a.fuse_wire({"q": x}, ta2a.wire_layout(3, {"q": ((4,),
                                                           torch.int32)}))


# ---------------------------------------------------------------------------
# the BLS pipeline
# ---------------------------------------------------------------------------


def _stages(mod, xp, exchange="flip"):
    def stage_a(x):
        return x * 2.0, x.sum(-1)

    def stage_b(recv, side):
        return recv.sum(-1) + side

    move = (lambda p: p) if exchange == "identity" \
        else (lambda p: xp.flip(p, (0,)))
    if mod is tbls:
        return stage_a, (lambda p: tbls.Issued(move(p))), stage_b
    return stage_a, move, stage_b


@pytest.mark.parametrize("exchange", ["identity", "flip"])
@pytest.mark.parametrize("bound", [0, 1, 2, 3])
def test_bls_outputs_bit_identical_across_bounds(bound, exchange):
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 5, 6), dtype=np.float32))
    a, c, b = _stages(tbls, torch, exchange)
    ref = torch.stack(tbls.reference_loop(a, c, b, list(xs)))
    outs, stats = tbls.bls_pipeline(a, c, b, list(xs), bound)
    assert torch.equal(torch.stack(outs), ref)
    assert (stats.bound, stats.n_iterations) == (bound, 4)


@pytest.mark.parametrize("bound", [0, 1, 2, 3])
def test_bls_stats_match_jax(bound):
    xs = np.random.default_rng(1).standard_normal((4, 5, 6),
                                                  dtype=np.float32)
    ja, jc, jb = _stages(jbls, jnp)
    jout, jstats = jbls.bls_pipeline(ja, jc, jb, jnp.asarray(xs), bound)
    ta, tc, tb = _stages(tbls, torch)
    tout, tstats = tbls.bls_pipeline(ta, tc, tb,
                                     list(torch.from_numpy(xs)), bound)
    assert tstats == tbls.BLSStats(**dataclasses.asdict(jstats))
    np.testing.assert_allclose(torch.stack(tout).numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)


def test_bls_bounds_and_memory_accounting():
    a, c, b = _stages(tbls, torch)
    xs = list(torch.zeros(2, 3, 4))
    for bad in (-1, 3):
        with pytest.raises(ValueError):
            tbls.bls_pipeline(a, c, b, xs, bad)
    payload = torch.empty((4, 100), dtype=torch.uint8, device="meta")
    side = torch.empty((8, 16), dtype=torch.float32, device="meta")
    jp = jax.ShapeDtypeStruct((4, 100), jnp.uint8)
    js = jax.ShapeDtypeStruct((8, 16), jnp.float32)
    for k in range(4):
        assert tbls.memory_overhead_bytes(payload, [side], k) == \
            jbls.memory_overhead_bytes(jp, [js], k)
    assert tbls.ring_slot_bytes({"buf": payload}, [side]) == \
        jbls.ring_slot_bytes({"buf": jp}, [js])


def test_issued_waits_once():
    class Work:
        waits = 0

        def wait(self):
            Work.waits += 1

    recv = torch.ones(2)
    issued = tbls.Issued(recv, Work(), keep=torch.zeros(2))
    assert issued.wait() is recv and issued.wait() is recv
    assert Work.waits == 1


# ---------------------------------------------------------------------------
# engine accounting and the straggler policy copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,mb", [(64, 1), (64, 4), (512, 4)])
def test_engine_slot_bytes_match_reference(batch, mb):
    jcfg, tcfg = _cfgs("smoke")
    jp, tp = _params(jcfg)
    jeng = jengine.DLRMEngine(jp, jcfg, batch_size=batch, microbatches=mb,
                              bound=2)
    teng = DLRMEngine(tp, tcfg, batch_size=batch, microbatches=mb, bound=2,
                      device="cpu")
    assert teng.slot_bytes() == jeng.slot_bytes()


@pytest.mark.parametrize("exchange,cap", [("dense", 0), ("ragged", 0),
                                           ("ragged", 40), ("auto", 40),
                                           ("auto", 0)])
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_engine_slot_bytes_with_a_cache_match_reference(wire, exchange, cap):
    jcfg, tcfg = _cfgs("smoke")
    jp, tp = _params(jcfg)
    b = tsyn.make_batch(tcfg, 64, mode="powerlaw_hetero", seed=3)
    kw = dict(batch_size=64, microbatches=4, bound=2, wire_dtype=wire,
              exchange=exchange, ragged_cap=cap)
    jeng = jengine.DLRMEngine(jp, jcfg, **kw)
    teng = DLRMEngine(tp, tcfg, device="cpu", **kw)
    assert teng.slot_bytes() == jeng.slot_bytes()
    jeng.calibrate_cache(b.idx, b.mask, 8)
    teng.calibrate_cache(b.idx, b.mask, 8)
    assert teng.slot_bytes() == jeng.slot_bytes()


def test_straggler_policy_copies_match():
    lat = np.random.default_rng(3).gamma(2.0, 0.01, size=300)
    jm, tm = jstrag.StragglerMonitor(window=64), \
        tstrag.StragglerMonitor(window=64)
    jt, tt = jstrag.CapAutotuner(), tstrag.CapAutotuner()
    for i, x in enumerate(lat):
        jm.observe(float(x))
        tm.observe(float(x))
        jt.observe(int(x * 1e4), drops=int(i % 50 == 0))
        tt.observe(int(x * 1e4), drops=int(i % 50 == 0))
        if i % 37 == 0:
            kw = {"slot_bytes": 4096 + i, "memory_budget": 1 << 16}
            assert dataclasses.asdict(tm.recommend_bound(**kw)) == \
                dataclasses.asdict(jm.recommend_bound(**kw))
            kw = {"dense_rows": 400, "current_cap": 64 if i % 2 else None}
            assert tt.recommend(**kw) == \
                tstrag.CapRecommendation(**dataclasses.asdict(
                    jt.recommend(**kw)))
