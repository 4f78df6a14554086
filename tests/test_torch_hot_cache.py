"""The port's hot-row cache (``repro_torch/serving/hot_cache.py``) against
the JAX reference, function by function, on the CPU.  Inputs come from the
reference's ``init_dlrm`` and ``make_batch``.  Cached ids, slot maps and
masks are held exactly (the ranking keeps the reference's own unstable
``np.argsort``, ties included); pooled sums at rtol = atol = 1e-6; the
scatters' out-of-range entries (-1 rows, out-of-range-high sentinels) must
be dropped, never wrapped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_kaggle as jkaggle
from repro.data import synthetic as jsyn
from repro.kernels.ref import embedding_bag_stacked_ref as jbag
from repro.models import dlrm as jdlrm
from repro.serving import hot_cache as jhc
from repro_torch.kernels import ref as tref
from repro_torch.serving import hot_cache as thc

SUM_TOL = {"rtol": 1e-6, "atol": 1e-6}


def _setup(seed, rows, mode="powerlaw_hetero", n_shards=4):
    cfg = jkaggle.smoke()
    params = jdlrm.init_dlrm(jax.random.PRNGKey(seed), cfg,
                             n_shards=n_shards)
    t_pad = jdlrm.padded_tables(cfg, n_shards)
    b = jsyn.make_batch(cfg, 24, mode=mode, seed=seed, t_pad=t_pad)
    tables = np.array(params["tables"])
    jc = jhc.build_from_batch(params["tables"], b.idx, b.mask, rows)
    tc = thc.build_from_batch(torch.from_numpy(tables), b.idx, b.mask, rows)
    return tables, b, jc, tc


def _same_cache(tc, jc):
    for k in ("hot_ids", "hot_rows", "slot_of"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    assert tc.cache_rows == jc.cache_rows


@pytest.mark.parametrize("rows", [0, 1, 5, 60, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_picks_the_reference_rows(seed, rows):
    # 60 rows of tables holding 30-100 rows, on 24 powerlaw samples: most
    # cached rows have count 0, so the tie order decides them
    _, _, jc, tc = _setup(seed, rows)
    _same_cache(tc, jc)
    assert tc.hot_ids.dtype == tc.slot_of.dtype == torch.int32


@pytest.mark.parametrize("mode", ["uniform", "hetero", "powerlaw_hetero"])
def test_observe_counts_match_over_a_padded_stack(mode):
    cfg = jkaggle.smoke()
    b = jsyn.make_batch(cfg, 40, mode=mode, seed=3)
    # counts cover 12 tables, the batch 8: padding tables stay cold
    jc = jhc.observe(np.zeros((12, 100)), b.idx, b.mask)
    tc = thc.observe(np.zeros((12, 100)), b.idx, b.mask)
    np.testing.assert_array_equal(tc, jc)
    assert tc[8:].sum() == 0 and tc.sum() == (b.mask > 0).sum()


@pytest.mark.parametrize("rows", [0, 3, 100])
@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_hits_plus_misses_is_the_full_bag(seed, rows):
    tables, b, jc, tc = _setup(seed, rows)
    idx, mask = torch.from_numpy(b.idx), torch.from_numpy(b.mask)
    jhits, jmiss = jhc.lookup(jc, jnp.asarray(b.idx), jnp.asarray(b.mask))
    thits, tmiss = thc.lookup(tc, idx, mask)
    np.testing.assert_array_equal(tmiss.numpy(), np.asarray(jmiss))
    np.testing.assert_array_equal(
        thc.miss_mask_of(tc.slot_of, idx, mask).numpy(),
        np.asarray(jhc.miss_mask_of(jc.slot_of, b.idx, b.mask)))
    np.testing.assert_allclose(thits.numpy(), np.asarray(jhits), **SUM_TOL)
    np.testing.assert_allclose(
        thc.pooled_hits_of(tc.hot_rows, tc.slot_of, idx, mask).numpy(),
        np.asarray(jhc.pooled_hits_of(jc.hot_rows, jc.slot_of, b.idx,
                                      b.mask)), **SUM_TOL)
    full = np.asarray(jbag(jnp.asarray(tables), b.idx, b.mask))
    miss_bag = tref.embedding_bag_stacked_ref(torch.from_numpy(tables), idx,
                                              tmiss)
    np.testing.assert_allclose((thits + miss_bag).numpy(), full, **SUM_TOL)
    assert thc.hit_rate(tc, b.idx, b.mask) == \
        pytest.approx(jhc.hit_rate(jc, b.idx, b.mask), abs=1e-7)
    if rows == 0:
        assert not thits.any() and torch.equal(tmiss, mask)


def test_pooled_hits_weigh_each_hit_once():
    """A hit counts 1 whatever its mask value (as in the reference)."""
    tables, b, jc, tc = _setup(0, 100)
    mask = b.mask * 0.25
    np.testing.assert_allclose(
        thc.pooled_hits_of(tc.hot_rows, tc.slot_of, torch.from_numpy(b.idx),
                           torch.from_numpy(mask)).numpy(),
        np.asarray(jhc.pooled_hits_of(jc.hot_rows, jc.slot_of, b.idx, mask)),
        **SUM_TOL)


def test_pooled_hits_refuse_the_kernel_on_the_cpu():
    _, b, _, tc = _setup(0, 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        thc.pooled_hits_of(tc.hot_rows, tc.slot_of, torch.from_numpy(b.idx),
                           torch.from_numpy(b.mask), impl="pallas")


def _updates(tc, rng):
    """Rows to refresh or invalidate: cached ones, uncached ones, -1
    rows and tables, and out-of-range-high sentinels."""
    t_all, r_all = tc.slot_of.shape
    slot = tc.slot_of.numpy()
    cached = np.argwhere(slot >= 0)
    pick = cached[rng.choice(len(cached), 6, replace=False)]
    uncached = np.argwhere(slot < 0)[:3]
    tab = np.concatenate([pick[:, 0], uncached[:, 0],
                          [-1, 0, t_all, t_all + 5, 2, t_all]])
    row = np.concatenate([pick[:, 1], uncached[:, 1],
                          [0, -1, 0, r_all + 9, r_all, r_all + 1]])
    vec = rng.standard_normal((len(tab), tc.hot_rows.shape[2])) \
        .astype(np.float32)
    return tab.astype(np.int32), row.astype(np.int32), vec


@pytest.mark.parametrize("seed", [0, 1])
def test_refresh_rows_drops_out_of_range_entries(seed):
    _, _, jc, tc = _setup(seed, 10)
    tab, row, vec = _updates(tc, np.random.default_rng(seed))
    before = tc.hot_rows.clone()
    jnew, jn = jhc.refresh_rows(jc, tab, row, vec)
    tnew, tn = thc.refresh_rows(tc, tab, row, vec)
    assert tn == jn == 6
    _same_cache(tnew, jnew)
    assert torch.equal(tc.hot_rows, before)          # input untouched
    assert thc.refresh_rows(tc, tab[:0], row[:0], vec[:0]) == (tc, 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_invalidate_drops_out_of_range_entries(seed):
    _, b, jc, tc = _setup(seed, 10)
    tab, row, _ = _updates(tc, np.random.default_rng(seed + 7))
    slot_before = tc.slot_of.clone()
    jnew, jn = jhc.invalidate(jc, tab, row)
    tnew, tn = thc.invalidate(tc, tab, row)
    assert tn == jn == 6
    _same_cache(tnew, jnew)
    assert torch.equal(tc.slot_of, slot_before)      # input untouched
    np.testing.assert_array_equal(
        thc.miss_mask_of(tnew.slot_of, torch.from_numpy(b.idx),
                         torch.from_numpy(b.mask)).numpy(),
        np.asarray(jhc.miss_mask_of(jnew.slot_of, b.idx, b.mask)))


def test_empty_cache_updates_are_no_ops():
    _, _, _, tc = _setup(0, 0)
    assert thc.refresh_rows(tc, [1], [2], np.zeros((1, 16))) == (tc, 0)
    assert thc.invalidate(tc, [1], [2]) == (tc, 0)


def test_permute_tables_and_cold_match():
    _, _, jc, tc = _setup(1, 7)
    order = np.random.default_rng(4).permutation(tc.slot_of.shape[0])
    _same_cache(thc.permute_tables(tc, order),
                jhc.permute_tables(jc, jnp.asarray(order)))
    _same_cache(thc.cold(tc), jhc.cold(jc))
    assert thc.hit_rate(thc.cold(tc), tc.slot_of.new_zeros((2, 8, 4)),
                        torch.ones((2, 8, 4))) == 0.0
