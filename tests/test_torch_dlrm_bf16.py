"""The bf16 DLRM (``DLRMConfig.dtype="bfloat16"``) through the port against
the JAX reference, on the CPU, at smoke shapes.

The reference builds the whole stack in the config's dtype; its served
path keeps the bottom and top MLPs in f32 (f32 dense features through
bf16 weights promote), pools the bags in bf16 and runs the interaction in
f32 (the concatenation promotes).  Parameters come from the reference's
``init_dlrm`` and cross over through ``params_from_jax`` (bf16 leaves as
their bit patterns); inputs come from numpy seeds.

Tolerances:

- bit for bit where no order of a sum is involved: the parameters' round
  trip, hot-1 bags, the stream plans at itemsize 2, ring == mono and
  bound 2 == bound 0 (and, in ``test_torch_dlrm_bf16_runtime.py``, the
  freshness and repair wires' bytes and checksums and the tables after
  every apply, repair and bit flip);
- one bf16 ulp on a bag: both packages sum in f32 and round once, in
  other orders (at these shapes they agree bit for bit);
- 1e-2 on logits and CTRs (a bag one ulp apart moves a logit by ~1e-3
  here; the cache adds its hits to the residual in bf16, one more
  rounding than ``forward_local``);
- the interaction in bf16 at 3e-2 against the reference's kernel in
  interpret mode, as ``tests/test_kernels.py`` holds that kernel.

Multi-member runs: P = 2 over gloo through ``_torch_exchange_worker.py``
(the config ``smoke_bf16``), every codec, exchange, pipeline and schedule
of its grid with and without a cache.
"""
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import flatten, run_members
from _torch_exchange_worker import CODECS, EXCHANGES, PIPES, SCHEDULES, key
from repro.configs import dlrm_kaggle as jkaggle
from repro.data import synthetic as jsyn
from repro.kernels import dot_interaction as jdi
from repro.kernels import embedding_bag as jeb
from repro.models import dlrm as jdlrm
from repro.runtime import elastic as jelastic
from repro.serving import engine as jengine
from repro.sharding import partition
from repro_torch.configs import dlrm_kaggle as tkaggle
from repro_torch.core import alltoallv as ta2a
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import mesh
from repro_torch.models import dlrm as tdlrm
from repro_torch.serving.engine import DLRMEngine

BF16 = "bfloat16"
# the reference's stacked_stream_plan, jitted: one compile per geometry
JAX_STACKED = jax.jit(jeb.stacked_stream_plan, static_argnums=(0, 1, 2, 3),
                      static_argnames=("batch_tile", "row_block"))
LOGIT_TOL = {"rtol": 1e-2, "atol": 1e-2}
TIMING = {"total_s", "throughput_rps", "recovery_s"}


def bits(a) -> np.ndarray:
    """A bf16 array of either package (or f32) as its raw bit patterns."""
    if isinstance(a, torch.Tensor):
        return ta2a.to_numpy(a).view(np.uint16 if a.dtype == torch.bfloat16
                                     else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def ulps(got: torch.Tensor, want) -> int:
    """The most bf16 steps between two bf16 arrays of finite values."""
    g = bits(got).astype(np.int32)
    w = bits(want).astype(np.int32)
    # sign-magnitude -> a monotone integer line
    g = np.where(g & 0x8000, -(g & 0x7FFF), g)
    w = np.where(w & 0x8000, -(w & 0x7FFF), w)
    return int(np.abs(g - w).max()) if g.size else 0


def _cfgs(**kw):
    j = jkaggle.smoke().replace(dtype=BF16, **kw)
    t = tkaggle.smoke().replace(dtype=BF16, **kw)
    return j, t


def _params(jcfg, n_shards=1):
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=n_shards)
    return jp, tdlrm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.fixture
def one_rank(tmp_path):
    mesh.init_model_group("gloo", 1, 0, f"file://{tmp_path / 'store'}")
    try:
        yield
    finally:
        mesh.destroy_model_group()


def _jmesh():
    return partition.axis_rules(jelastic.make_mesh_from(jax.devices()[:1],
                                                        model=1))


def _serve(engines, batches, b):
    """Every batch through every engine request by request -> each
    engine's CTRs."""
    outs = [[] for _ in engines]
    for batch in batches:
        for r in range(b):
            for o, eng in zip(outs, engines):
                got = eng.submit(batch.dense[r], batch.idx[r], batch.mask[r])
                if got is not None:
                    o.append(np.asarray(got))
    return [np.concatenate(o) for o in outs]


# ---------------------------------------------------------------------------
# parameters, the MLPs' promotion, the local forward and the engine
# ---------------------------------------------------------------------------


def test_params_from_jax_round_trip_is_bit_exact():
    """Every bf16 leaf crosses as its bit pattern: the port's tensors are
    bf16 and their bits the reference's, and ``to_numpy`` gives the bits
    back."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, n_shards=2)
    assert tp["tables"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(tp["tables"]), bits(jp["tables"]))
    for part in ("bot", "top"):
        for jl, tl in zip(jp[part], tp[part]):
            assert jl.keys() == tl.keys()
            for k in jl:
                assert tl[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(bits(tl[k]), bits(jl[k]))
    back = ta2a.from_host(ta2a.to_numpy(tp["tables"]), torch.bfloat16)
    assert torch.equal(back.view(torch.int16),
                       tp["tables"].view(torch.int16))
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    mine = tdlrm.init_dlrm(0, tcfg, n_shards=2, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                        mine) == shapes


def test_dense_promotes_as_jax():
    """``layers.dense``: an f32 input through a bf16 layer computes in f32
    (the reference's ``x @ w``), bf16 through bf16 stays bf16, f32
    through f32 is untouched."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    rng = np.random.default_rng(0)
    w = rng.standard_normal((13, 32)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    x = rng.standard_normal((8, 13)).astype(np.float32)
    for xd, wd in ((jnp.float32, jnp.bfloat16), (jnp.bfloat16, jnp.bfloat16),
                   (jnp.float32, jnp.float32)):
        jx = jnp.asarray(x, xd)
        jpar = {"kernel": jnp.asarray(w, wd), "bias": jnp.asarray(b, wd)}
        want = jlayers.dense(jpar, jx)
        tpar = {k: ta2a.from_host(np.asarray(v)) for k, v in jpar.items()}
        got = tlayers.dense(tpar, ta2a.from_host(np.asarray(jx)))
        assert str(got.dtype)[6:] == str(want.dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-2 if xd == jnp.bfloat16 else 1e-6,
                                   atol=1e-2 if xd == jnp.bfloat16 else 1e-6)


@pytest.mark.parametrize("dense_dtype", ["float32", BF16])
def test_forward_local_matches_reference(dense_dtype):
    """f32 dense features (the engine's): f32 logits; bf16 dense features:
    bf16 logits, the interaction in bf16 (B3's bf16 domain)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    b = jsyn.make_batch(jcfg, 48, mode="hetero", seed=7)
    dense = jnp.asarray(b.dense, dense_dtype)
    want = jdlrm.forward_local(jp, jcfg, dense, b.idx, b.mask)
    got = tdlrm.forward_local(tp, tcfg, ta2a.from_host(np.asarray(dense)),
                              *_t(b.idx, b.mask))
    assert str(got.dtype)[6:] == str(want.dtype) == dense_dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **LOGIT_TOL)
    emb = tdlrm.apply_emb(tp["tables"][:tcfg.n_tables],
                          *_t(b.idx[:, :tcfg.n_tables],
                              b.mask[:, :tcfg.n_tables]))
    jemb = jdlrm.apply_emb(jp["tables"][:jcfg.n_tables],
                           b.idx[:, :jcfg.n_tables],
                           b.mask[:, :jcfg.n_tables])
    assert emb.dtype == torch.bfloat16 and ulps(emb, jemb) <= 1


def test_engine_serves_the_reference_ctrs():
    """``DLRMEngine`` on the bf16 smoke model: the reference engine's CTRs
    on the same 32 requests (two flushes of 16)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    b = jsyn.make_batch(jcfg, 32, mode="hetero", seed=1)
    jeng = jengine.DLRMEngine(jp, jcfg, batch_size=16)
    teng = DLRMEngine(tp, tcfg, batch_size=16, device="cpu")
    jo, to = _serve((jeng, teng), [b], 32)
    np.testing.assert_allclose(to, jo, **LOGIT_TOL)
    assert teng.stats.batches == 2


@pytest.mark.parametrize("ekw", [
    {"exchange": "dense", "wire_dtype": "float32"},
    {"exchange": "ragged", "wire_dtype": BF16, "exchange_pipeline": "ring"},
    {"exchange": "ragged", "wire_dtype": "int8"}], ids=str)
def test_engine_at_one_member_with_cache_matches_reference(one_rank, ekw):
    """At P = 1 (the reference on a one-device mesh, the port on a
    one-rank gloo group) with a calibrated 16-row cache, whose pooled hits
    go through the bag in bf16: CTRs within 1e-2 of the reference engine's,
    and bound 2 bit-identical to bound 0."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    calib = jsyn.make_batch(jcfg, 64, mode="powerlaw_hetero", seed=5)
    batches = [jsyn.make_batch(jcfg, 32, mode="powerlaw_hetero", seed=3,
                               step=s) for s in range(3)]
    kw = dict(batch_size=32, microbatches=2, **ekw)
    jeng = jengine.DLRMEngine(dict(jp), jcfg, bound=2, **kw)
    teng = DLRMEngine(dict(tp), tcfg, bound=2, device="cpu", **kw)
    teng0 = DLRMEngine(dict(tp), tcfg, bound=0, device="cpu", **kw)
    with _jmesh():
        for eng in (jeng, teng, teng0):
            eng.calibrate_cache(calib.idx, calib.mask, cache_rows=16)
        assert teng.cache.hot_rows.dtype == torch.bfloat16
        jo, to, to0 = _serve((jeng, teng, teng0), batches, 32)
    np.testing.assert_allclose(to, jo, **LOGIT_TOL)
    np.testing.assert_array_equal(to, to0)


# ---------------------------------------------------------------------------
# the plain versions against the reference's kernels (interpret mode)
# ---------------------------------------------------------------------------


def _bag_inputs(seed, t=3, r=50, s=16, b=8, hot=5):
    rng = np.random.default_rng(seed)
    tab = jnp.asarray(rng.standard_normal((t, r, s)).astype(np.float32),
                      jnp.bfloat16)
    idx = rng.integers(-3, r + 3, (b, t, hot)).astype(np.int32)
    mask = (rng.random((b, t, hot)) < 0.6).astype(np.float32)
    return tab, idx, mask


@pytest.mark.parametrize("row_block", [-1, 0, 16])
@pytest.mark.parametrize("hot", [1, 24])
def test_plain_bag_matches_reference_kernel(row_block, hot):
    """The plain stacked bag in bf16 against the reference's resident
    vector kernel (``_stacked_kernel_vec`` in interpret mode at row_block
    -1 and 0) and its streamed schedule (row_block 16: interpret mode
    runs ``_stream_rows_jnp``; ``_stream_kernel_vec`` needs ``pl.load``,
    ROADMAP C2): within one bf16 ulp, hot 1 bit for bit; the rows and
    single-table forms too (at row_block 0), and the split model (the CUDA
    kernel's order) within one ulp of the plain version."""
    tab, idx, mask = _bag_inputs(hot, hot=hot)
    want = jeb.embedding_bag_stacked(tab, jnp.asarray(idx),
                                     jnp.asarray(mask), row_block=row_block,
                                     pool_mode="vector", interpret=True)
    tt = ta2a.from_host(np.asarray(tab))
    got = tref.embedding_bag_stacked_ref(tt, *_t(idx, mask))
    assert got.dtype == torch.bfloat16
    assert ulps(got, want) <= (0 if hot == 1 else 1)
    t, r, s = tt.shape
    flat = tt.reshape(t * r, s)
    b = idx.shape[0]
    split = tref.embedding_bag_split_ref(
        flat, torch.from_numpy(idx.reshape(b * t, hot)),
        torch.from_numpy(mask.reshape(b * t, hot)), rows=r, n_tables=t,
        groups=2 if hot > 8 else 1)
    assert split.dtype == torch.bfloat16
    assert ulps(split.reshape(b, t, s), got) <= (0 if hot == 1 else 1)
    if row_block != 0:
        return
    tid = np.arange(b, dtype=np.int32) % t
    rows_want = jeb.embedding_bag_rows(
        tab, jnp.asarray(tid), jnp.asarray(idx[:, 0]),
        jnp.asarray(mask[:, 0]), interpret=True)
    rows_got = tref.embedding_bag_rows_ref(tt, *_t(tid, idx[:, 0],
                                                   mask[:, 0]))
    assert ulps(rows_got, rows_want) <= (0 if hot == 1 else 1)
    one_want = jeb.embedding_bag(tab[1], jnp.asarray(idx[:, 1]),
                                 jnp.asarray(mask[:, 1]), interpret=True)
    one_got = tref.embedding_bag_ref(tt[1], *_t(idx[:, 1], mask[:, 1]))
    assert ulps(one_got, one_want) <= (0 if hot == 1 else 1)


def test_plain_bag_weighs_in_f32():
    """A fractional weight multiplies the widened row in f32 and the bag
    is rounded once: not the bf16 product a bf16 multiply would round."""
    row = torch.tensor([[1.0 + 2 ** -7]], dtype=torch.bfloat16)
    w = torch.tensor([[1.0 + 2 ** -7]])
    got = tref.embedding_bag_ref(row, torch.zeros(1, 1, dtype=torch.int32),
                                 w)
    exact = (1.0 + 2 ** -7) ** 2
    assert got.dtype == torch.bfloat16
    assert got.item() == torch.tensor(exact).to(torch.bfloat16).item()


@pytest.mark.parametrize("b,f,s", [(64, 27, 64), (128, 8, 16),
                                   (32, 24, 128), (256, 4, 32)])
def test_plain_interaction_matches_reference_kernel(b, f, s):
    """The plain interaction in bf16 against the reference's ``_kernel``
    in interpret mode at the shapes and tolerance of
    ``tests/test_kernels.py``; the split model (the CUDA kernel's order)
    against the plain version within one bf16 ulp."""
    z = jax.random.normal(jax.random.PRNGKey(0), (b, f, s), jnp.bfloat16)
    want = jdi.dot_interaction(z, batch_tile=min(64, b), interpret=True)
    zt = ta2a.from_host(np.asarray(z))
    got = tref.dot_interaction_ref(zt)
    assert got.dtype == torch.bfloat16 == ta2a.from_host(
        np.asarray(want)).dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)
    assert ulps(tref.dot_interaction_split_ref(zt, 2), got) <= 1
    assert torch.equal(ops.dot_interaction_op(zt, impl="auto"), got)


# ---------------------------------------------------------------------------
# stream plans at itemsize 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,s,row_block", [
    (20_000, 64, 0), (40_000, 64, 0), (40_000, 64, 1024), (300, 16, 32)])
def test_stream_plans_at_itemsize_2_match_reference(rows, s, row_block):
    """``stacked_stream_plan`` over a bf16 stack: the block height comes
    from itemsize 2 (20,000 x 64 rows stay resident in bf16 where f32
    streams; 40,000 stream at the auto height 16,384), and every leaf
    equals the reference's."""
    t, b, hot = 2, 16, 4
    rng = np.random.default_rng(rows)
    idx = rng.integers(-5, rows + 5, (b, t, hot)).astype(np.int32)
    jp = JAX_STACKED(t, rows, s, 2, jnp.asarray(idx), batch_tile=8,
                     row_block=row_block)
    tp = teb.stacked_stream_plan(t, rows, s, 2, torch.from_numpy(idx),
                                 batch_tile=8, row_block=row_block)
    assert (tp is None) == (jp is None)
    if rows == 20_000 and row_block == 0:
        assert tp is None and teb.stacked_stream_plan(
            t, rows, s, 4, torch.from_numpy(idx), row_block=0) is not None
    if tp is None:
        return
    assert (tp.rb, tp.total_rows) == (jp.rb, jp.total_rows)
    for k in ("sid", "pos", "inv", "off", "seg0", "seg1", "nblk", "cum"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)


def test_forward_plans_of_a_bf16_stack(one_rank):
    """``build_forward_plans`` on a bf16 stack builds at itemsize 2: each
    microbatch's plan is the reference's ``stacked_stream_plan`` at
    itemsize 2, and the planned forward equals the inline one bit for
    bit."""
    jcfg, tcfg = _cfgs(sparse_backend="interpret", row_block=32)
    jp, tp = _params(jcfg)
    b = jsyn.make_batch(jcfg, 32, mode="hetero", seed=2)
    plans = tdlrm.build_forward_plans(tp, tcfg, torch.from_numpy(b.idx),
                                      microbatches=2)
    t, r, s = tp["tables"].shape
    for j in range(2):
        want = jeb.stacked_stream_plan(t, r, s, 2,
                                       jnp.asarray(b.idx[j * 16:][:16]),
                                       row_block=32)
        got = plans.map(lambda a: a[j])
        assert (got.rb, got.total_rows) == (want.rb, want.total_rows)
        np.testing.assert_array_equal(got.sid.numpy(), np.asarray(want.sid))
        np.testing.assert_array_equal(got.off.numpy(), np.asarray(want.off))
    args = _t(b.dense, b.idx, b.mask)
    inline = tdlrm.forward_distributed(tp, tcfg, *args, microbatches=2)
    planned = tdlrm.forward_distributed(tp, tcfg, *args, microbatches=2,
                                        plan=plans)
    assert torch.equal(inline, planned)


# ---------------------------------------------------------------------------
# P = 2 over gloo: the exchange grid on a bf16 stack
# ---------------------------------------------------------------------------

WORKER = Path(__file__).with_name("_torch_exchange_worker.py")
NAME = "smoke_bf16"
CACHE_ROWS = (0, 2)


@pytest.fixture(scope="module")
def two_members(tmp_path_factory):
    """One run of the exchange worker's grid on 2 members for the bf16
    smoke config -> (the reference's logits, host live counts, outputs)."""
    p = 2
    cfg = jkaggle.smoke().replace(dtype=BF16)
    params = jdlrm.init_dlrm(jax.random.PRNGKey(0), cfg, n_shards=p)
    t_pad = jdlrm.padded_tables(cfg, p)
    b = jsyn.make_batch(cfg, 32, mode="powerlaw_hetero", seed=1,
                        t_pad=t_pad)
    inputs = {"configs": np.array([NAME])}
    flatten(NAME, jax.tree.map(bits, params), inputs)
    inputs.update({f"{NAME}/dense": b.dense, f"{NAME}/idx": b.idx,
                   f"{NAME}/mask": b.mask,
                   f"{NAME}/cache_rows": np.array(CACHE_ROWS),
                   f"{NAME}/tight_cap": np.array(2)})
    want = np.asarray(jdlrm.forward_local(params, cfg, b.dense, b.idx,
                                          b.mask))
    outs = run_members(WORKER, p, inputs, tmp_path_factory.mktemp("bf16"))
    return want, outs


@pytest.mark.parametrize("wire", CODECS)
def test_two_members_match_reference(two_members, wire):
    """Every exchange, pipeline and schedule, with and without a cache, on
    each codec: logits within 1e-2 of the reference's ``forward_local``
    (the wire's own rounding inside: f32 and bf16 carry a bf16 row
    exactly, int8 quantizes it), every member the same, zero drops."""
    want, outs = two_members
    tol = LOGIT_TOL if wire != "int8" else {"rtol": 1e-1, "atol": 1e-1}
    for rows, ex, pipe, (bound, mb) in itertools.product(
            CACHE_ROWS, EXCHANGES, PIPES, SCHEDULES):
        k = key(NAME, rows, wire, ex, pipe, bound, mb)
        got = outs[0][f"{k}/logits"]
        np.testing.assert_allclose(got, want, err_msg=k, **tol)
        for o in outs[1:]:
            np.testing.assert_array_equal(o[f"{k}/logits"], got)
        assert int(outs[0][f"{k}/diag"][1]) == 0, k


@pytest.mark.parametrize("wire", CODECS)
def test_two_members_ring_and_bound_are_bit_exact(two_members, wire):
    """ring == mono and bound 2 == bound 0 at 4 microbatches, bit for
    bit, on each codec, exchange and cache size."""
    _, outs = two_members
    o = outs[0]
    for rows, ex in itertools.product(CACHE_ROWS, EXCHANGES):
        base = o[f"{key(NAME, rows, wire, ex, 'mono', 0, 4)}/logits"]
        for pipe, bound in (("ring", 0), ("mono", 2), ("ring", 2)):
            k = key(NAME, rows, wire, ex, pipe, bound, 4)
            np.testing.assert_array_equal(o[f"{k}/logits"], base, err_msg=k)
