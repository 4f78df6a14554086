"""The port's stream plans and its plan pipeline against the JAX reference,
on the CPU.

- ``build_stream_plan``, ``stacked_stream_plan`` and ``_check_plan`` bit
  for bit against the reference's jnp builders (which run here; only its
  Pallas executors need the missing ``pl.load``): every leaf, its dtype
  and ``rb``/``total_rows``, by 'sort', 'count' and 'auto', on geometries
  whose tiles pad, whose row count is not a multiple of the block height,
  and on skewed, repeated and out-of-range ids;
- the 'auto' method and the cases without a plan equal to the reference's;
- a port plan consumed by the reference's own plan executor
  (``_stream_rows_jnp``) and by the port: the same bags at 1e-6, and the
  port's bags with a plan bit-identical to those without one;
- the ``plan_pipeline`` engine against the inline one on one member;
- on P gloo members (``_torch_chaos_worker.py``, one run per P for the
  whole grid): ``forward_distributed(plan=build_forward_plans(...))``
  bit-identical to inline planning at (bound, microbatches) (0, 1) and
  (2, 4) with and without a cache, each member's plans equal to the
  reference's for its table slice, a plan with the ragged exchange
  raising, and the pipelined engine's CTR stream equal to the inline
  one's.
"""
import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import flatten, run_members
from _torch_chaos_worker import PLAN_SCHEDULES
from repro.configs.base import DLRMConfig as JConfig
from repro.data import synthetic as jsyn
from repro.kernels import embedding_bag as jeb
from repro.models import dlrm as jdlrm
from repro_torch.configs import dlrm_kaggle as tkaggle
from repro_torch.kernels import embedding_bag as teb
from repro_torch.models import dlrm as tdlrm
from repro_torch.serving.engine import DLRMEngine

# the reference's builders, jitted: one compile per geometry instead of
# one per operation
JAX_BUILD = jax.jit(jeb.build_stream_plan, static_argnums=(0, 1),
                    static_argnames=("row_tile", "rb", "plan_method"))
JAX_STACKED = jax.jit(jeb.stacked_stream_plan, static_argnums=(0, 1, 2, 3),
                      static_argnames=("batch_tile", "row_block",
                                       "plan_method"))
LEAVES = ("sid", "pos", "inv", "off", "seg0", "seg1", "nblk", "cum")
METHODS = ("sort", "count", "auto")
# (total_rows, s, n, hot, row_tile, rb): a tile that divides n, rows not a
# multiple of rb (the last block's start clamps back), a tile that does
# not divide n (padded tail), hot 100 at s 64, one block per tile
GEOMETRIES = [(1024, 16, 64, 4, 16, 64), (1000, 8, 37, 5, 16, 96),
              (203, 16, 50, 3, 64, 40), (4096, 64, 30, 100, 64, 256),
              (60, 8, 7, 2, 4, 60)]
TOL = {"rtol": 1e-6, "atol": 1e-6}


def _ids(total, n, hot, dist, seed):
    """Row ids: 'uniform', 'skewed' (Zipf: a few hot blocks, many
    repeats, most blocks untouched) or 'ragged' (runs of one id, then
    scattered singletons)."""
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        return rng.integers(0, total, (n, hot), dtype=np.int32)
    if dist == "skewed":
        return np.minimum(rng.zipf(1.3, (n, hot)) - 1,
                          total - 1).astype(np.int32)
    ids = rng.integers(0, total, (n, hot), dtype=np.int32)
    ids[: n // 2] = ids[0, 0]
    return ids


def _same_plan(tp, jp):
    assert (tp.rb, tp.total_rows) == (jp.rb, jp.total_rows)
    for k in LEAVES:
        a, b = getattr(tp, k), np.asarray(getattr(jp, k))
        assert a.dtype == torch.int32, (k, a.dtype)
        assert tuple(a.shape) == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


def _jax_plan(tp):
    return jeb.StreamPlan(*(jnp.asarray(getattr(tp, k).numpy())
                            for k in LEAVES), rb=tp.rb,
                          total_rows=tp.total_rows)


@pytest.mark.parametrize("dist", ["uniform", "skewed", "ragged"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
def test_build_stream_plan_matches_jax(geom, method, dist):
    total, s, n, hot, tile, rb = geom
    gid = _ids(total, n, hot, dist, seed=total + n)
    tp = teb.build_stream_plan(total, s, torch.from_numpy(gid),
                               row_tile=tile, rb=rb, plan_method=method)
    jp = JAX_BUILD(total, s, jnp.asarray(gid), row_tile=tile,
                               rb=rb, plan_method=method)
    _same_plan(tp, jp)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("row_block", [8, 64, 600])
def test_stacked_stream_plan_matches_jax_per_microbatch(method, row_block):
    """Four microbatches stacked on a leading axis, with ids below 0 and
    past the table (the builder clips them, as the kernel does): each
    slice is the reference's plan of that microbatch."""
    t, r, s, b, hot = 3, 150, 8, 12, 5
    rng = np.random.default_rng(row_block)
    idx = rng.integers(-20, r + 20, (4, b, t, hot), dtype=np.int32)
    tp = teb.stacked_stream_plan(t, r, s, 4, torch.from_numpy(idx),
                                 batch_tile=8, row_block=row_block,
                                 plan_method=method)
    for j in range(4):
        jp = JAX_STACKED(t, r, s, 4, jnp.asarray(idx[j]),
                                     batch_tile=8, row_block=row_block,
                                     plan_method=method)
        _same_plan(tp.map(lambda a: a[j]), jp)


def test_resolvers_and_none_cases_match_jax():
    for rows, s, item, rb in itertools.product(
            (10, 1000, 16_384, 16_385, 1 << 20), (8, 64), (2, 4),
            (-1, 0, 7, 64, 4096)):
        try:
            want = jeb.resolve_row_block(rows, s, item, rb)
        except ValueError:
            with pytest.raises(ValueError):
                teb.resolve_row_block(rows, s, item, rb)
            continue
        assert teb.resolve_row_block(rows, s, item, rb) == want
        assert teb.fits_resident(rows, s, item) == \
            jeb.fits_resident(rows, s, item)
        assert teb.auto_row_block(rows, s, item) == \
            jeb.auto_row_block(rows, s, item)
    idx = np.zeros((4, 3, 2), np.int32)
    # resident, forced streaming, streamed by size, resident at the edge
    for r, s, rb in ((40, 8, 0), (40, 8, 16), (20_000, 64, 0),
                     (16_384, 64, 0)):
        want = JAX_STACKED(3, r, s, 4, jnp.asarray(idx),
                                       row_block=rb)
        got = teb.stacked_stream_plan(3, r, s, 4, torch.from_numpy(idx),
                                      row_block=rb)
        assert (got is None) == (want is None), (r, s, rb)
    for method, L, nb, tiles in itertools.product(
            ("auto", "sort", "count"), (1, 128, 6400), (1, 64, 3496),
            (1, 52)):
        assert teb._resolve_plan_method(method, L, nb, tiles) == \
            jeb._resolve_plan_method(method, L, nb, tiles)
    with pytest.raises(ValueError):
        teb._resolve_plan_method("radix", 8, 8)


def test_full_width_kaggle_plans_by_sort():
    """At the served microbatch of full-width dlrm-kaggle (128 samples x 26
    tables, hot 100, s 64, the whole stack streamed) 'auto' must resolve
    to 'sort', as in the reference: 52 tiles x L 6400 x 3496 blocks is far
    over PLAN_COUNT_WORK."""
    cfg = tkaggle.CONFIG
    t, r, s = cfg.n_tables, max(cfg.table_sizes), cfg.embed_dim
    rb = teb._stream_rb(t, r, s, 4, 0)
    _, tiles, _, L, _, _ = teb._stream_geometry(t * r, s, 128 * t, 100, 64,
                                                rb)
    nb = -(-t * r // rb)
    assert (tiles, L, nb) == (52, 6400, 3496)
    assert teb._resolve_plan_method("auto", L, nb, tiles) == "sort" == \
        jeb._resolve_plan_method("auto", L, nb, tiles)


def _stack(seed, t=3, r=150, s=8, b=12, hot=5):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((t, r, s)).astype(np.float32)
    idx = rng.integers(-5, r + 5, (b, t, hot), dtype=np.int32)
    mask = (rng.random((b, t, hot)) < 0.7).astype(np.float32)
    return tables, idx, mask


@pytest.mark.parametrize("method", ["sort", "count"])
@pytest.mark.parametrize("row_block", [16, 64])
def test_plan_consumed_by_jax_executor_and_port(method, row_block):
    tables, idx, mask = _stack(row_block)
    t, r, s = tables.shape
    b, _, hot = idx.shape
    args = tuple(map(torch.from_numpy, (tables, idx, mask)))
    plan = teb.stacked_stream_plan(t, r, s, 4, args[1], batch_tile=8,
                                   row_block=row_block, plan_method=method)
    port = teb.embedding_bag_stacked(*args, batch_tile=8,
                                     row_block=row_block, plan=plan)
    assert torch.equal(port, teb.embedding_bag_stacked(*args))
    nt, tiles, n_pad, L, _, _ = teb._stream_geometry(t * r, s, b * t, hot,
                                                     8, plan.rb)
    w = np.zeros((n_pad, hot), np.float32)
    w[:b * t] = mask.reshape(b * t, hot)
    sw = jnp.take_along_axis(jnp.asarray(w.reshape(tiles, L)),
                             jnp.asarray(plan.pos.numpy()), axis=-1)
    want = jeb._stream_rows_jnp(jnp.asarray(tables.reshape(t * r, s)),
                                _jax_plan(plan), sw, nt=nt, hot=hot,
                                rb=plan.rb, out_dtype=jnp.float32)
    np.testing.assert_allclose(port.reshape(b * t, s).numpy(),
                               np.asarray(want)[:b * t], **TOL)


def test_single_table_plan_is_checked_and_changes_nothing():
    tables, idx, mask = _stack(5)
    tab, ix, mk = (torch.from_numpy(a) for a in
                   (tables[1], idx[:, 1], mask[:, 1]))
    gid = ix.clamp(0, tab.shape[0] - 1)
    plan = teb.build_stream_plan(tab.shape[0], 8, gid, row_tile=4, rb=32)
    assert torch.equal(teb.embedding_bag(tab, ix, mk, batch_tile=4,
                                         row_block=32, plan=plan),
                       teb.embedding_bag(tab, ix, mk))
    with pytest.raises(ValueError, match="geometry"):
        teb.embedding_bag(tab, ix, mk, batch_tile=8, row_block=32,
                          plan=plan)


def test_check_plan_refuses_what_jax_refuses():
    """A plan meets only its own call: another block height, batch or
    tile raises ValueError, as does a plan on a call that resolves
    resident or on the 'ref' backend, and anything not a StreamPlan."""
    tables, idx, mask = _stack(6)
    t, r, s = tables.shape
    args = tuple(map(torch.from_numpy, (tables, idx, mask)))
    plan = teb.stacked_stream_plan(t, r, s, 4, args[1], row_block=64)
    jplan = JAX_STACKED(t, r, s, 4, jnp.asarray(idx),
                                    row_block=64)
    bad = {"rb": plan._replace(rb=plan.rb // 2),
           "batch": teb.stacked_stream_plan(t, r, s, 4, args[1][:8],
                                            row_block=64)}
    for name, p in bad.items():
        with pytest.raises(ValueError, match="geometry"):
            teb.embedding_bag_stacked(*args, row_block=64, plan=p)
    with pytest.raises(ValueError, match="geometry"):
        teb.embedding_bag_stacked(*args, row_block=64, batch_tile=4,
                                  plan=plan)
    with pytest.raises(ValueError):
        jeb.embedding_bag_stacked(*map(jnp.asarray, (tables, idx, mask)),
                                  row_block=64, interpret=True,
                                  plan=jplan._replace(rb=jplan.rb // 2))
    with pytest.raises(ValueError, match="resident"):
        teb.embedding_bag_stacked(*args, row_block=0, plan=plan)
    with pytest.raises(ValueError, match="StreamPlan"):
        teb.embedding_bag_stacked(*args, row_block=64, plan=object())
    with pytest.raises(ValueError, match="'ref'"):
        tdlrm.apply_emb(args[0], args[1], args[2], backend="ref",
                        row_block=64, plan=plan)
    got = tdlrm.apply_emb(args[0], args[1], args[2], backend="interpret",
                          row_block=64, plan=plan)
    assert torch.equal(got, teb.embedding_bag_stacked(*args))


def _six(**kw):
    return dict(name="t", table_sizes=(100, 50, 80, 60, 90, 40),
                embed_dim=16, bottom_mlp=(32, 16), top_mlp=(32, 1),
                max_hot=4, **kw)


def test_pipelined_engine_matches_inline_on_one_member(tmp_path):
    """On a one-member gloo group (real plans, built per flush and once
    staged ahead), the pipelined engine returns each batch one flush late,
    and its CTR stream is the inline engine's bit for bit and within f32
    tolerance of the reference's."""
    from repro_torch.configs.base import DLRMConfig
    from repro_torch.launch import mesh

    jcfg = JConfig(**_six())
    cfg = DLRMConfig(**_six(sparse_backend="interpret", row_block=32))
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=1)
    params = tdlrm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batches = [jsyn.make_batch(jcfg, 16, mode="hetero", seed=7, step=s)
               for s in range(3)]
    mesh.init_model_group("gloo", 1, 0, f"file://{tmp_path / 'store'}")
    try:
        assert tdlrm.build_forward_plans(
            params, cfg, torch.from_numpy(batches[0].idx),
            microbatches=4) is not None
        outs, returned = {}, {}
        for pp in (False, True):
            eng = DLRMEngine(params, cfg, batch_size=16, bound=2,
                             microbatches=4, plan_pipeline=pp, device="cpu")
            got, firsts = [], []
            for j, b in enumerate(batches):
                if pp and j == 1:
                    assert eng.stage_plan(list(b.idx))
                for i in range(16):
                    o = eng.submit(b.dense[i], b.idx[i], b.mask[i])
                    if o is not None:
                        got.append(o)
                firsts.append(len(got))
            tail = eng.drain()
            assert eng.drain() is None
            # the pipeline holds the last batch until drained
            assert (tail is not None) == pp
            if pp:
                got.append(tail)
            outs[pp], returned[pp] = np.concatenate(got), firsts
            assert eng.stats.batches == 3
            assert eng.plan_stage_hits == (1 if pp else 0)
    finally:
        mesh.destroy_model_group()
    assert returned == {False: [1, 2, 3], True: [0, 1, 2]}
    np.testing.assert_array_equal(outs[True], outs[False])
    want = np.concatenate([
        np.asarray(jax.nn.sigmoid(jdlrm.forward_local(
            jp, jcfg, b.dense, b.idx, b.mask))) for b in batches])
    np.testing.assert_allclose(outs[True], want, rtol=1e-5, atol=1e-5)


def test_stage_plan_only_under_the_pipeline():
    jcfg = JConfig(**_six())
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=1)
    params = tdlrm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    from repro_torch.configs.base import DLRMConfig
    eng = DLRMEngine(params, DLRMConfig(**_six()), batch_size=8,
                     device="cpu")
    b = jsyn.make_batch(jcfg, 8, mode="hetero", seed=1)
    assert not eng.stage_plan(list(b.idx))
    assert eng.flush() is None and eng.drain() is None


def test_error_in_flight_surfaces_at_the_next_harvest():
    """An error the watcher saw while a pipelined batch was in flight is
    raised at the next harvest, with the batch's context, and the engine
    serves on afterwards."""
    jcfg = JConfig(**_six())
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=1)
    params = tdlrm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    from repro_torch.configs.base import DLRMConfig
    eng = DLRMEngine(params, DLRMConfig(**_six()), batch_size=8,
                     plan_pipeline=True, device="cpu")
    b = jsyn.make_batch(jcfg, 16, mode="hetero", seed=2)
    for i in range(8):
        assert eng.submit(b.dense[i], b.idx[i], b.mask[i]) is None
    out, diag, n, t0, watcher, done, step = eng._inflight
    done["err"] = RuntimeError("illegal memory access")
    with pytest.raises(RuntimeError, match="flush #0"):
        eng.drain()
    assert eng._inflight is None and eng.drain() is None
    for i in range(8, 16):
        eng.submit(b.dense[i], b.idx[i], b.mask[i])
    assert eng.drain().shape == (8,)


# ---------------------------------------------------------------------------
# P gloo members
# ---------------------------------------------------------------------------

_RUNS: dict = {}


def _launch(p, d):
    jcfg = JConfig(**_six(sparse_backend="interpret", row_block=32,
                          exchange="dense"))
    t_pad = jdlrm.padded_tables(jcfg, p)
    params = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=p)
    b = jsyn.make_batch(jcfg, 64, mode="hetero", t_pad=t_pad, seed=1)
    inputs = {"task": np.array("plans"), "fwd/dense": b.dense,
              "fwd/idx": b.idx, "fwd/mask": b.mask}
    flatten("plans", params, inputs)
    steps = [jsyn.make_batch(jcfg, 32, mode="hetero", seed=7, step=s,
                             t_pad=t_pad) for s in range(4)]
    for s, bb in enumerate(steps):
        for k in ("dense", "idx", "mask"):
            inputs[f"step{s}/{k}"] = getattr(bb, k)
    want = {
        "logits": np.asarray(jdlrm.forward_local(params, jcfg, b.dense,
                                                 b.idx, b.mask)),
        "ctr": np.concatenate([np.asarray(jax.nn.sigmoid(
            jdlrm.forward_local(params, jcfg, bb.dense, bb.idx, bb.mask)))
            for bb in steps]),
        "idx": b.idx, "tables": np.asarray(params["tables"])}
    worker = Path(__file__).with_name("_torch_chaos_worker.py")
    return p, want, run_members(worker, p, inputs, d)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def members(request, tmp_path_factory):
    p = request.param
    if p not in _RUNS:
        _RUNS[p] = _launch(p, tmp_path_factory.mktemp(f"plans{p}"))
    return _RUNS[p]


def _grid():
    return [(b, mb, c) for (b, mb) in PLAN_SCHEDULES
            for c in ("nocache", "cache")]


@pytest.mark.parametrize("bound,mb,cache", _grid())
def test_planned_forward_is_bit_identical_to_inline(members, bound, mb,
                                                    cache):
    p, want, outs = members
    k = f"b{bound}m{mb}/{cache}"
    for out in outs:
        np.testing.assert_array_equal(out[f"{k}/planned"],
                                      out[f"{k}/inline"])
        np.testing.assert_array_equal(out[f"{k}/planned"],
                                      outs[0][f"{k}/planned"])
        np.testing.assert_allclose(out[f"{k}/planned"], want["logits"],
                                   rtol=1e-5, atol=1e-5)


_JAX_PLANS: dict = {}


def _jax_member_plan(p, want, mb, m, j):
    """The reference's plan of member m's table slice of microbatch j."""
    key = (p, mb, m, j)
    if key not in _JAX_PLANS:
        idx = want["idx"]
        t_pad, r, s = want["tables"].shape
        t_loc, b_mb = t_pad // p, idx.shape[0] // mb
        _JAX_PLANS[key] = JAX_STACKED(
            t_loc, r, s, 4, jnp.asarray(idx[j * b_mb:(j + 1) * b_mb,
                                            m * t_loc:(m + 1) * t_loc]),
            row_block=32)
    return _JAX_PLANS[key]


@pytest.mark.parametrize("bound,mb,cache", _grid())
def test_member_plans_match_jax(members, bound, mb, cache):
    """Member m's plans are the reference's plans of its table slice, one
    per microbatch (what the reference's shard_map hands member m)."""
    p, want, outs = members
    k = f"b{bound}m{mb}/{cache}"
    for m, out in enumerate(outs):
        for j in range(mb):
            jp = _jax_member_plan(p, want, mb, m, j)
            assert out[f"{k}/plan/geometry"].tolist() == \
                [jp.rb, jp.total_rows]
            for leaf in LEAVES:
                np.testing.assert_array_equal(
                    out[f"{k}/plan/{leaf}"][j], np.asarray(getattr(jp, leaf)),
                    err_msg=f"{m} {j} {leaf}")


def test_plan_with_ragged_raises_and_builders_return_none(members):
    _, _, outs = members
    for out in outs:
        assert bool(out["ragged_raised"])
        # ragged exchange, 'ref' backend, resident regime
        assert out["none_builds"].tolist() == [True, True, True]


def test_pipelined_engine_stream_equals_inline(members):
    _, want, outs = members
    for out in outs:
        np.testing.assert_array_equal(out["engine/pipelined"],
                                      out["engine/inline"])
        assert out["engine/inline"].shape == (4 * 32,)
        assert out["engine/inline/stats"].tolist() == [4, 0]
        assert out["engine/pipelined/stats"].tolist() == [4, 1]
        np.testing.assert_allclose(out["engine/inline"], want["ctr"],
                                   rtol=1e-5, atol=1e-5)
