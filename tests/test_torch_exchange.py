"""The port's full distributed forward (hot cache, dense and ragged
exchanges, mono and ring pipelines, f32/bf16/int8 wires) and the cap
autotuner against the JAX reference, on the CPU.

P gloo members run in subprocesses (``_torch_exchange_worker.py``), once
per P for the whole grid (module-scoped fixture), and meet through a
``file://`` store under a temporary directory.  Inputs are made from seeds
with the reference's own ``init_dlrm`` and ``make_batch``.  Held:

- logits within the reference's own tolerances of JAX ``forward_local``
  (max abs error: f32 1e-4, bf16 5e-2, int8 1e-1, as
  ``tests/test_ragged_exchange.py``), within rtol = atol = 1e-5 on a
  float32 wire without a cache, and within 1e-4 with a full-hit cache;
- ring == mono and bound 2 == bound 0 bit for bit, every member the same;
- zero drops, and ``live_max`` (and the drops of a tight cap) equal to the
  counts numpy takes on the host from the masks and the reference cache;
- an ``exchange='auto'`` engine retuning onto the ragged exchange.
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
from repro.configs.base import DLRMConfig
from repro.data import synthetic as jsyn
from repro.models import dlrm as jdlrm
from repro.serving import hot_cache as jhc
from repro_torch.models import dlrm as tdlrm

BATCH = 32
# the reference's tolerances (tests/test_ragged_exchange.py)
MAX_ERR = {"float32": 1e-4, "bfloat16": 5e-2, "int8": 1e-1}
F32_TOL = {"rtol": 1e-5, "atol": 1e-5}
# config -> (traffic, cache rows: none, part, all)
CONFIGS = {"smoke": ("powerlaw_hetero", (0, 2, 100)),
           "six": ("hetero", (0, 40, 100))}


def _jax_config(name):
    if name == "six":
        return DLRMConfig(name="t", table_sizes=(100, 50, 80, 60, 90, 40),
                          embed_dim=16, bottom_mlp=(32, 16),
                          top_mlp=(32, 1), max_hot=4)
    return getattr(jkaggle, name)()


def host_live(slot_of, idx, mask, p, mb):
    """Live (>= 1 miss) rows per (microbatch, destination, member), counted
    with numpy from the reference cache's slot map."""
    b, t_pad, _ = idx.shape
    r = slot_of.shape[1]
    slots = slot_of[np.arange(t_pad)[None, :, None], np.clip(idx, 0, r - 1)]
    live = ((mask > 0) & (slots < 0)).any(-1)
    return live.reshape(mb, p, b // (mb * p), p, t_pad // p).sum((2, 4))


def _run(world, inputs, d):
    return run_members(Path(__file__).with_name("_torch_exchange_worker.py"),
                       world, inputs, d)


_RUNS: dict = {}


def _members(p, tmp_path_factory):
    """Run the whole grid on P members once per module; returns (P, the
    reference's logits, hit rates and host live counts per config, each
    member's outputs)."""
    if p not in _RUNS:
        _RUNS[p] = _launch(p, tmp_path_factory.mktemp(f"gloo{p}"))
    return _RUNS[p]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def members(request, tmp_path_factory):
    return _members(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def four_members(tmp_path_factory):
    return _members(4, tmp_path_factory)


def _launch(p, d):
    inputs, want = {"configs": np.array(list(CONFIGS))}, {}
    for name, (mode, rows) in CONFIGS.items():
        cfg = _jax_config(name)
        params = jdlrm.init_dlrm(jax.random.PRNGKey(0), cfg, n_shards=p)
        b = jsyn.make_batch(cfg, BATCH, mode=mode, seed=1,
                            t_pad=jdlrm.padded_tables(cfg, p))
        caches = {c: jhc.build_from_batch(params["tables"], b.idx, b.mask, c)
                  for c in rows}
        live = {(c, mb): host_live(np.asarray(caches[c].slot_of), b.idx,
                                   b.mask, p, mb)
                for c in rows for mb in (1, 4)}
        tight = max(1, int(live[rows[1], 4].max()) // 2)
        want[name] = {
            "logits": np.asarray(jdlrm.forward_local(params, cfg, b.dense,
                                                     b.idx, b.mask)),
            "hit": {c: jhc.hit_rate(caches[c], b.idx, b.mask) for c in rows},
            "live": live, "tight": tight}
        flatten(name, params, inputs)
        inputs.update({f"{name}/dense": b.dense, f"{name}/idx": b.idx,
                       f"{name}/mask": b.mask,
                       f"{name}/cache_rows": np.array(rows),
                       f"{name}/tight_cap": np.array(tight)})
    if p == 4:
        cfg = jkaggle.smoke()
        t_pad = jdlrm.padded_tables(cfg, p)
        calib = jsyn.make_batch(cfg, 128, mode="powerlaw_hetero", seed=7,
                                t_pad=t_pad)
        steps = [jsyn.make_batch(cfg, 128, mode="powerlaw_hetero", seed=7,
                                 step=s, t_pad=t_pad) for s in range(6)]
        inputs.update({"engine/calib_idx": calib.idx,
                       "engine/calib_mask": calib.mask})
        for k in ("dense", "idx", "mask"):
            inputs[f"engine/{k}"] = np.stack([getattr(s, k) for s in steps])
    return p, want, _run(p, inputs, d)


def _grid(name):
    rows = CONFIGS[name][1]
    return itertools.product(rows, EXCHANGES, PIPES, SCHEDULES)


@pytest.mark.parametrize("wire", CODECS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_jax_forward_local(members, name, wire):
    p, want, outs = members
    ref = want[name]["logits"]
    rows = CONFIGS[name][1]
    hit = want[name]["hit"]
    assert hit[rows[0]] == 0.0 and 0.0 < hit[rows[1]] < 1.0 \
        and hit[rows[2]] == 1.0, hit
    for c, ex, pipe, (bound, mb) in _grid(name):
        got = outs[0][f"{key(name, c, wire, ex, pipe, bound, mb)}/logits"]
        assert got.shape == ref.shape
        err = float(np.abs(got - ref).max())
        assert err < MAX_ERR[wire], (c, ex, pipe, bound, mb, err)
        if c == rows[2]:
            # a full-hit cache: nothing rides the wire
            assert err < 1e-4, (c, ex, pipe, bound, mb, err)
        if wire == "float32" and c == 0:
            np.testing.assert_allclose(got, ref, **F32_TOL)


@pytest.mark.parametrize("wire", CODECS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ring_mono_and_bounds_give_the_same_bits(members, name, wire):
    _, _, outs = members
    for c, ex, pipe, (bound, mb) in _grid(name):
        k = key(name, c, wire, ex, pipe, bound, mb)
        base = outs[0][f"{key(name, c, wire, ex, 'mono', 0, mb)}/logits"]
        for out in outs:
            np.testing.assert_array_equal(out[f"{k}/logits"], base,
                                          err_msg=k)


@pytest.mark.parametrize("wire", CODECS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_diagnostics_match_the_host_counts(members, name, wire):
    _, want, outs = members
    for c, ex, pipe, (bound, mb) in _grid(name):
        k = key(name, c, wire, ex, pipe, bound, mb)
        live = want[name]["live"][c, mb]
        for out in outs:
            assert out[f"{k}/diag"].tolist() == [int(live.max()), 0], k
            assert str(out[f"{k}/exchange"]) == ex
        if c == CONFIGS[name][1][2]:
            assert live.max() == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tight_cap_counts_its_drops(members, name):
    _, want, outs = members
    live = want[name]["live"][CONFIGS[name][1][1], 4]
    cap = want[name]["tight"]
    drops = int(np.maximum(live - cap, 0).sum())
    assert drops > 0
    for out in outs:
        assert out[f"{name}/tight"].tolist() == [int(live.max()), drops, cap]


def test_auto_engine_retunes_onto_the_ragged_exchange(four_members):
    _, _, outs = four_members
    for out in outs:
        retunes, cap, dense_rows, drops, auto_slot = out["engine/auto/state"]
        assert retunes >= 1
        assert 0 < cap < dense_rows
        assert drops == 0
        # the ragged slot undercuts the dense one
        assert auto_slot < out["engine/dense/state"][4]
        assert out["engine/dense/state"][0] == 0
        diff = np.abs(out["engine/dense/ctr"] - out["engine/auto/ctr"]).max()
        assert diff < 3e-2, diff
        assert out["engine/auto/ctr"].shape == (6 * 128,)


@pytest.mark.parametrize("pipeline", ["mono", "ring", "auto"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_resolve_pipeline_matches_jax(pipeline, p):
    assert tdlrm.resolve_pipeline(pipeline, p) == \
        jdlrm.resolve_pipeline(pipeline, p)


@pytest.mark.parametrize("exchange", ["dense", "ragged", "auto"])
def test_resolve_exchange_matches_jax(exchange):
    for use_cache, cap, dense_rows in itertools.product(
            (False, True), (0, 1, 7, 8, 63, 64, 65, 999), (1, 8, 64)):
        kw = {"use_cache": use_cache, "cap": cap, "dense_rows": dense_rows}
        assert tdlrm.resolve_exchange(exchange, **kw) == \
            jdlrm.resolve_exchange(exchange, **kw), kw


def test_unknown_exchange_and_pipeline_raise():
    with pytest.raises(ValueError):
        tdlrm.resolve_exchange("sparse", use_cache=True, cap=8,
                               dense_rows=64)
    with pytest.raises(ValueError):
        tdlrm.resolve_pipeline("tree", 4)


def _packed_inputs(seed=2, n_dest=2):
    cfg = _jax_config("six")
    params = jdlrm.init_dlrm(jax.random.PRNGKey(seed), cfg,
                             n_shards=n_dest)
    b = jsyn.make_batch(cfg, 8 * n_dest, mode="hetero", seed=seed,
                        t_pad=jdlrm.padded_tables(cfg, n_dest))
    cache = jhc.build_from_batch(params["tables"], b.idx, b.mask, 30)
    t_loc = b.idx.shape[1] // n_dest
    miss = np.array(jhc.miss_mask_of(cache.slot_of[:t_loc],
                                     b.idx[:, :t_loc], b.mask[:, :t_loc]))
    return np.array(params["tables"][:t_loc]), b.idx[:, :t_loc], miss


@pytest.mark.parametrize("wire", CODECS)
@pytest.mark.parametrize("cap", [3, 12, 24])
def test_ragged_pack_and_unpack_match_jax(wire, cap):
    """Member 0's ragged pack on a 2-member split: ids, counts and drops
    exact, pooled rows at f32 rtol = atol = 1e-6 after the codec (the sum
    order may move a bf16 or int8 rounding by one step), and the unpack of
    the reference's own payload bit for bit."""
    tables, idx, miss = _packed_inputs()
    jp, jdrops = jdlrm.ragged_exchange_pack(
        jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(miss), n_dest=2,
        cap=cap, wire=wire)
    tp, tdrops = tdlrm.ragged_exchange_pack(
        torch.from_numpy(tables), torch.from_numpy(idx),
        torch.from_numpy(miss), n_dest=2, cap=cap, wire=wire)
    assert int(tdrops) == int(jdrops)
    assert sorted(tp) == sorted(jp)
    for k in ("ids", "counts"):
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype))
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    step = {"float32": 1e-6, "bfloat16": 2 ** -8, "int8": 1 / 127}[wire]
    got = tdlrm.a2a_mod.decode_wire(tp).numpy()
    want = np.asarray(jdlrm.a2a_mod.decode_wire(jp))
    bound = np.abs(want).max(-1, keepdims=True) * step + 1e-6
    assert (np.abs(got - want) <= bound).all()
    recv = {k: _torch_of(v) for k, v in jp.items()}
    np.testing.assert_array_equal(
        tdlrm.ragged_exchange_unpack(recv, t_loc=idx.shape[1], bs=8)
        .numpy(),
        np.asarray(jdlrm.ragged_exchange_unpack(jp, t_loc=idx.shape[1],
                                                bs=8)))


def _torch_of(a):
    """A JAX array as a torch tensor, bf16 included (through its bits)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def test_apply_emb_rows_matches_jax():
    tables, idx, miss = _packed_inputs()
    n = idx.shape[0] * idx.shape[1]
    rng = np.random.default_rng(4)
    tid = rng.integers(-1, tables.shape[0] + 1, n).astype(np.int32)
    rows = (idx.reshape(n, -1), miss.reshape(n, -1))
    np.testing.assert_allclose(
        tdlrm.apply_emb_rows(torch.from_numpy(tables), torch.from_numpy(tid),
                             *map(torch.from_numpy, rows)).numpy(),
        np.asarray(jdlrm.apply_emb_rows(jnp.asarray(tables),
                                        jnp.asarray(tid),
                                        *map(jnp.asarray, rows))),
        rtol=1e-6, atol=1e-6)

