"""The port's chaos path against the JAX reference, on the CPU.

- ``runtime/faults.py``: every ``FaultPlan`` builder and query,
  ``predict_absorption`` and the ``FaultInjector`` host hooks equal to the
  reference's on the same seeds; the ``core/schedule_sim.py`` copy and
  ``detect_stragglers`` likewise;
- the engine's chaos options and their ``ValueError``s;
- on 4 gloo members (``_torch_chaos_worker.py``, one run for the whole
  grid), the reference's ``tests/test_faults.py`` gates: the degraded
  forward against the host oracle with ``approx_rows`` exact; transient
  faults leaving the CTRs bit-identical across dense/ragged x mono/ring
  (gate a); an explicit degrade ledgered exactly (gate b); the deadline
  policy degrading a sustained straggler; and a crash that evicts and
  replays with zero requests lost, P' = 3, the table padding refit and
  the CTRs within 2e-5 of JAX ``forward_local`` (gate c).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist_worker import flatten, run_members
from _torch_chaos_worker import EXCHANGES, FALLBACKS, PIPES
from repro.configs.base import DLRMConfig as JConfig
from repro.core import schedule_sim as jsim
from repro.data import synthetic as jsyn
from repro.models import dlrm as jdlrm
from repro.runtime import elastic as jelastic
from repro.runtime import faults as jfaults
from repro.runtime import straggler as jstrag
from repro.serving import hot_cache as jhc
from repro_torch.configs import dlrm_kaggle as tkaggle
from repro_torch.core import schedule_sim as tsim
from repro_torch.models import dlrm as tdlrm
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import straggler as tstrag
from repro_torch.serving.engine import DLRMEngine

P = 4


def _plan(mod, seed=3):
    """One plan through every builder of ``mod``'s FaultPlan."""
    return (mod.FaultPlan.none(4, 12, seed=seed)
            .with_jitter(0.004)
            .with_jitter(0.001, members=(1, 3), seed=seed + 1)
            .with_spike(2, 3, 0.002)
            .with_straggler(1, 0.003, from_step=5)
            .with_crash(3, at_step=9)
            .with_arrival_burst(2, 3, 1.5)
            .with_arrival_burst(3, 4, 2.0)
            .with_queue_delay(1, 2, 0.01)
            .with_delta_corruption(0, 4, n_rows=2)
            .with_update_burst(0, 5, 3.0)
            .with_updater_straggler(2, from_step=3, n_steps=4)
            .with_apply_crash(1, at_step=7)
            .with_mig_crash(2, "verify", at_step=6)
            .with_bitflip(0, 1, 5, 9, 2)
            .with_bitflip(1, 0, 3, 1, 4, sticky=False, target="cache")
            .with_wire_corruption(0, 2, 3)
            .with_skew_shift(4)
            .with_skew_shift(8))


def _fields(plan):
    return {f.name: getattr(plan, f.name)
            for f in dataclasses.fields(plan)}


def test_fault_plan_builders_match_jax():
    got, want = _fields(_plan(tfaults)), _fields(_plan(jfaults))
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_fault_plan_queries_match_jax():
    tp, jp = _plan(tfaults), _plan(jfaults)
    for step in range(16):
        for m in range(4):
            assert tp.delay_of(m, step) == jp.delay_of(m, step)
            assert tp.apply_stalled(m, step) == jp.apply_stalled(m, step)
        for q in ("crashes_at", "arrival_factor", "queue_delay_of",
                  "update_factor", "delta_corrupt_at", "apply_crashes_at",
                  "skew_phase"):
            assert getattr(tp, q)(step) == getattr(jp, q)(step), (q, step)
        assert tp.sustained_members(at_step=step) == \
            jp.sustained_members(at_step=step)
    assert tp.sustained_members() == jp.sustained_members()
    assert tp.transient_only() == jp.transient_only() is False
    for bad in (lambda m: m.FaultPlan.none(2, 2).with_arrival_burst(0, 1, 0),
                lambda m: m.FaultPlan.none(2, 2).with_update_burst(0, 1, -1),
                lambda m: m.FaultPlan.none(2, 2).with_mig_crash(0, "fly"),
                lambda m: m.FaultPlan.none(2, 2).with_bitflip(0, 0, 0, -1, 0),
                lambda m: m.FaultPlan.none(2, 2).with_bitflip(
                    0, 0, 0, 1, 0, target="disk")):
        for mod in (tfaults, jfaults):
            with pytest.raises(ValueError):
                bad(mod)


@pytest.mark.parametrize("n_iters", [None, 20])
def test_to_workload_matches_jax(n_iters):
    kw = {"t_emb": 0.004, "t_wire": 0.002}
    tp = tfaults.FaultPlan.none(3, 8, seed=2).with_jitter(0.003) \
        .with_straggler(2, 0.001, from_step=4)
    jp = jfaults.FaultPlan.none(3, 8, seed=2).with_jitter(0.003) \
        .with_straggler(2, 0.001, from_step=4)
    tw, jw = tp.to_workload(n_iters, **kw), jp.to_workload(n_iters, **kw)
    assert dataclasses.asdict(tw).keys() == dataclasses.asdict(jw).keys()
    for k, v in dataclasses.asdict(jw).items():
        np.testing.assert_array_equal(getattr(tw, k), v, err_msg=k)
    with pytest.raises(ValueError):
        tp.with_crash(1, 3).to_workload()


@pytest.mark.parametrize("bound", [0, 1, 2, 4])
@pytest.mark.parametrize("backend", ["bls", "mpi"])
@pytest.mark.parametrize("case", ["spike", "straggler", "jitter"])
def test_predict_absorption_matches_jax(case, backend, bound):
    def plan(mod):
        base = mod.FaultPlan.none(4, 16, seed=5)
        return {"spike": base.with_spike(2, 3, 0.002),
                "straggler": base.with_straggler(1, 0.003),
                "jitter": base.with_jitter(0.004)}[case]

    got = tfaults.predict_absorption(plan(tfaults), bound, backend=backend)
    want = jfaults.predict_absorption(plan(jfaults), bound, backend=backend)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.absorbed == want.absorbed


def test_predict_absorption_verdicts():
    """The reference's own verdicts hold in the copy: a 2 ms spike is
    absorbed at bound 2 and not at 0; a sustained straggler at no bound."""
    spike = tfaults.FaultPlan.none(4, 16).with_spike(2, 3, 0.002)
    assert not tfaults.predict_absorption(spike, 0).absorbed
    assert tfaults.predict_absorption(spike, 2).absorbed
    slow = tfaults.FaultPlan.none(4, 32).with_straggler(1, 0.003)
    assert not any(tfaults.predict_absorption(slow, k).absorbed
                   for k in (0, 2, 4, 8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_sim_copy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    kw = {"delay_max": float(rng.uniform(0, 0.005)) * (seed != 2),
          "hetero_wire": 0.5 * (seed == 1), "seed": seed,
          "straggler": 2 if seed == 0 else None}
    tw = tsim.make_workload(4, 24, **kw)
    jw = jsim.make_workload(4, 24, **kw)
    for k, v in dataclasses.asdict(jw).items():
        np.testing.assert_array_equal(getattr(tw, k), v, err_msg=k)
    load = rng.uniform(0.5, 2.0, 4)
    tsk = tsim.make_skew_workload(4, 24, load, seed=seed)
    jsk = jsim.make_skew_workload(4, 24, load, seed=seed)
    for k, v in dataclasses.asdict(jsk).items():
        np.testing.assert_array_equal(getattr(tsk, k), v, err_msg=k)
    for backend in ("bls", "mpi"):
        got = tsim.sweep_bounds(tw, (0, 1, 2, 4), backend)
        want = jsim.sweep_bounds(jw, (0, 1, 2, 4), backend)
        assert got == want
        for k in (0, 2):
            r, q = tsim.simulate(tsk, k, backend=backend), \
                jsim.simulate(jsk, k, backend=backend)
            assert r.summary() == q.summary()
            np.testing.assert_array_equal(r.consume, q.consume)
            np.testing.assert_array_equal(r.blocked, q.blocked)


def test_detect_stragglers_matches_jax():
    rng = np.random.default_rng(0)
    cases = [{}, {0: 0.1}, {0: 0.1, 1: 0.5}, {0: 0.1, 1: 0.1, 2: 0.1}]
    cases += [{h: float(x) for h, x in enumerate(
        rng.gamma(2.0, 0.01, size=n))} for n in (2, 3, 4, 7, 8)]
    for lat in cases:
        for thr in (1.2, 1.5, 3.0):
            assert tstrag.detect_stragglers(lat, thr) == \
                jstrag.detect_stragglers(lat, thr)


def test_pick_mesh_shape_matches_jax():
    for n in range(1, 33):
        for model in (0, 1, 2, 3, 4, 8):
            assert telastic.pick_mesh_shape(n, model) == \
                jelastic.pick_mesh_shape(n, model)


def test_injector_hooks_match_jax():
    """Without a group both injectors name no survivors; every other hook
    (delays, exclusion, telemetry, crash renumbering, the freshness,
    bit-flip and wire-corruption schedules) agrees step by step."""
    ti = tfaults.FaultInjector(_plan(tfaults), time_scale=0.0)
    ji = jfaults.FaultInjector(_plan(jfaults), time_scale=0.0)
    for step in range(12):
        assert ti.host_delay(step) == ji.host_delay(step)
        assert ti.host_delay(step, exclude=(1,)) == \
            ji.host_delay(step, exclude=(1,))
        assert ti.latencies(step, 0.01) == ji.latencies(step, 0.01)
        assert ti.corrupt_rows(step) == ji.corrupt_rows(step)
        assert ti.bitflips(step) == ji.bitflips(step)
        assert ti.wire_corruptions(step) == ji.wire_corruptions(step)
        assert ti.stalled_positions(step) == ji.stalled_positions(step)
        assert ti.update_factor(step) == ji.update_factor(step)
        assert ti.skew_phase(step) == ji.skew_phase(step)
        assert ti.on_dequeue(step) == ji.on_dequeue(step) == 0.0
        for name in ("on_apply", "on_flush"):
            errs = []
            for inj, mod in ((ti, telastic), (ji, jelastic)):
                try:
                    getattr(inj, name)(step)
                    errs.append(None)
                except mod.NodeFailure as e:
                    errs.append(list(getattr(
                        e, "surviving_ranks", getattr(
                            e, "surviving_devices", None))))
            assert errs[0] == errs[1], (name, step)
        assert ti.live == ji.live and ti.fired == ji.fired
        for m in range(4):
            assert ti.position_of(m) == ji.position_of(m)
    assert ti.live != [0, 1, 2, 3]          # crashes fired


def test_injector_sleeps_the_plan_and_elastic_fault_matches_jax():
    plan = tfaults.FaultPlan.none(2, 4).with_spike(1, 1, 0.002) \
        .with_queue_delay(0, 1, 0.001)
    inj = tfaults.FaultInjector(plan)
    for step in range(4):
        inj.on_flush(step)
    assert inj.injected_delay_s == sum(plan.delay_of(1, s)
                                       for s in range(4))
    assert inj.on_dequeue(0) == inj.injected_queue_delay_s == 0.001
    devices = list(range(8))
    tf = tfaults.FaultInjector(tfaults.FaultPlan.none(4, 8).with_crash(
        1, at_step=2), time_scale=0.0).elastic_fault(devices)
    jf = jfaults.FaultInjector(jfaults.FaultPlan.none(4, 8).with_crash(
        1, at_step=2), time_scale=0.0).elastic_fault(devices)
    for step in range(4):
        got = []
        for f, mod in ((tf, telastic), (jf, jelastic)):
            try:
                f(step)
                got.append(None)
            except mod.NodeFailure as e:
                got.append([int(d) for d in getattr(
                    e, "surviving_ranks", getattr(e, "surviving_devices",
                                                  None))])
        assert got[0] == got[1], step


def _smoke_engine(**kw):
    cfg = tkaggle.smoke()
    params = tdlrm.init_dlrm(0, cfg, n_shards=1, device="cpu")
    return DLRMEngine(params, cfg, batch_size=8, device="cpu", **kw)


@pytest.mark.parametrize("kw", [{"on_deadline": "retry"},
                                {"degraded_fallback": "median"}])
def test_engine_chaos_options_raise_value_errors(kw):
    with pytest.raises(ValueError):
        _smoke_engine(**kw)


def test_engine_takes_the_chaos_options():
    inj = tfaults.FaultInjector(tfaults.FaultPlan.none(1, 4))
    eng = _smoke_engine(deadline_s=1.0, on_deadline="degrade", faults=inj,
                        degraded_fallback="mean", confirm_after=3,
                        max_retries=1, retry_backoff_s=0.01)
    assert (eng.confirm_after, eng.max_retries, eng.retry_backoff_s) == \
        (3, 1, 0.01)
    eng.degrade([2, 0, 2])
    assert eng.degraded_members == (0, 2)
    eng.degrade(())
    assert eng.degraded_members == ()
    with pytest.raises(ValueError, match="model group"):
        eng.evict_member(0)
    st = eng.stats.to_dict()
    for k in ("deadline_breaches", "degraded_batches", "approx_rows",
              "evictions", "replays", "recovery_s"):
        assert st[k] == 0, k


# ---------------------------------------------------------------------------
# 4 gloo members
# ---------------------------------------------------------------------------

CFG = JConfig("t", table_sizes=(40, 60, 30, 50, 20, 70), embed_dim=8,
              n_dense_features=4, bottom_mlp=(16, 8), top_mlp=(16, 1),
              sparse_backend="ref")


def _tail(params, dense, emb):
    z0 = jdlrm.apply_mlp(params["bot"], dense)
    z = jnp.concatenate([z0[:, None, :], emb[:, :CFG.n_tables]], axis=1)
    inter = jdlrm.dot_interaction(z)
    top_in = jnp.concatenate([z0, inter.astype(z0.dtype)], axis=-1)
    return np.asarray(jdlrm.apply_mlp(params["top"], top_in)[..., 0])


def _degraded_oracle(params, b, t_pad):
    """The host oracle of the reference's test: cache hits land as usual,
    degraded tables' residuals are replaced by the fallback, everything
    else pools normally; ``approx`` counts the live residual bags of the
    degraded member's tables."""
    dense, idx, mask = map(jnp.asarray, (b.dense, b.idx, b.mask))
    cache = jhc.build_from_batch(params["tables"], idx, mask, 8)
    t_loc = t_pad // P

    def cols(d):
        return jnp.repeat(jnp.asarray([1.0 if i == d else 0.0
                                       for i in range(P)]), t_loc)

    d1 = cols(1)
    hits = jhc.pooled_hits_of(cache.hot_rows, cache.slot_of, idx, mask)
    miss = jhc.miss_mask_of(cache.slot_of, idx, mask)
    res = jdlrm.apply_emb(params["tables"], idx,
                          miss * (1 - d1)[None, :, None])
    mean_rows = params["tables"].astype(jnp.float32).mean(axis=1)
    w = miss.sum(-1) * d1[None]
    d2 = cols(2)
    return {
        "zero": _tail(params, dense, hits + res),
        "mean": _tail(params, dense,
                      hits + res + w[..., None] * mean_rows[None]),
        "approx": int((((miss > 0).any(-1)) * d1[None]).sum()),
        "nocache": _tail(params, dense, jdlrm.apply_emb(
            params["tables"], idx, mask * (1 - d2)[None, :, None])),
        "nocache_approx": int(((mask > 0).any(-1) * d2[None]).sum())}


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    t_pad = jdlrm.padded_tables(CFG, P)
    params = jdlrm.init_dlrm(jax.random.PRNGKey(0), CFG, n_shards=P)
    inputs = {"task": np.array("faults"), "world": np.array(P)}
    flatten("faults", params, inputs)
    deg = jsyn.make_batch(CFG, 16, t_pad=t_pad, seed=3)
    runs = {"deg": [deg]}
    for tag, seed, bsz, n in (("transient", 11, 32, 3),
                              ("explicit", 13, 32, 3),
                              ("straggler", 17, 32, 10),
                              ("crash", 7, 48, 4)):
        runs[tag] = [jsyn.make_batch(CFG, bsz, t_pad=t_pad, seed=seed,
                                     step=s) for s in range(n)]
    for tag, batches in runs.items():
        for s, b in enumerate(batches):
            prefix = tag if tag == "deg" else f"{tag}/step{s}"
            for k in ("dense", "idx", "mask"):
                inputs[f"{prefix}/{k}"] = getattr(b, k)
    cal = runs["explicit"][0]
    cache = jhc.build_from_batch(params["tables"], jnp.asarray(cal.idx),
                                 jnp.asarray(cal.mask), 8)
    dcol = np.repeat(np.asarray([1 if i == 1 else 0 for i in range(P)]),
                     t_pad // P)
    explicit = sum(
        int(((np.asarray(jhc.miss_mask_of(
            cache.slot_of, jnp.asarray(b.idx), jnp.asarray(b.mask))) > 0)
            .any(-1) * dcol[None]).sum()) for b in runs["explicit"])
    want = {"deg": _degraded_oracle(params, deg, t_pad),
            "explicit": explicit,
            "crash": np.concatenate([np.asarray(jax.nn.sigmoid(
                jdlrm.forward_local(params, CFG, *map(
                    jnp.asarray, (b.dense, b.idx, b.mask)))))
                for b in runs["crash"]])}
    worker = Path(__file__).with_name("_torch_chaos_worker.py")
    return want, run_members(worker, P, inputs,
                             tmp_path_factory.mktemp("faults4"))


@pytest.mark.parametrize("fb", FALLBACKS)
@pytest.mark.parametrize("pipe", PIPES)
@pytest.mark.parametrize("ex", EXCHANGES)
def test_degraded_forward_matches_oracle_and_counts_exactly(members, ex,
                                                            pipe, fb):
    want, outs = members
    assert want["deg"]["approx"] > 0
    for out in outs:
        k = f"deg/{ex}/{pipe}/{fb}"
        assert int(out[f"{k}/approx"]) == want["deg"]["approx"], k
        err = float(np.abs(out[k] - want["deg"][fb]).max())
        assert err < 1e-4, (k, err)


@pytest.mark.parametrize("pipe", PIPES)
def test_degraded_forward_without_a_cache(members, pipe):
    """The zero fallback without a cache drops the degraded member's whole
    bags, and the mean fallback without one raises."""
    want, outs = members
    for out in outs:
        k = f"deg/nocache/{pipe}"
        assert int(out[f"{k}/approx"]) == want["deg"]["nocache_approx"]
        assert float(np.abs(out[k] - want["deg"]["nocache"]).max()) < 1e-4
        assert bool(out["deg/mean_nocache_raised"])


def test_transient_faults_leave_ctrs_bit_identical(members):
    """Gate (a): a 2 ms spike that the simulator says bound 2 absorbs
    leaves every engine's CTRs bit-identical, dense/ragged x mono/ring."""
    _, outs = members
    plan = tfaults.FaultPlan.none(P, 8).with_spike(2, 1, 0.002)
    pred = tfaults.predict_absorption(plan, 2)
    assert pred.absorbed and pred.blocked_s == 0.0
    assert not tfaults.predict_absorption(plan, 0).absorbed
    for out in outs:
        clean, chaos = out["transient/clean"], out["transient/chaos"]
        assert clean.shape == chaos.shape == (2 * 2 * 3 * 32,)
        np.testing.assert_array_equal(chaos, clean)
        np.testing.assert_array_equal(clean, outs[0]["transient/clean"])


def test_explicit_degrade_ledgers_exactly(members):
    """Gate (b): ``approx_rows`` is the host count of live residual bags on
    the degraded member's tables, batch for batch."""
    want, outs = members
    for out in outs:
        assert out["explicit/stats"].tolist() == [3, want["explicit"]]


def test_deadline_policy_degrades_a_sustained_straggler(members):
    _, outs = members
    for out in outs:
        breaches, degraded, approx = out["straggler/stats"].tolist()
        assert breaches > 0 and degraded >= 1 and approx > 0
        assert out["straggler/degraded"].tolist() == [1]
        # once degraded, the straggler's 0.5 s stops gating the flush
        assert float(out["straggler/host_delay"]) == 0.0
    # every member took the same decisions
    for out in outs[1:]:
        np.testing.assert_array_equal(out["straggler/stats"],
                                      outs[0]["straggler/stats"])


def test_crash_evicts_and_replays_losing_nothing(members):
    """Gate (c): member 1 crashes at flush 2; the survivors evict it,
    rebuild the group on 3 members, refit the stack to padded_tables(cfg,
    3) and serve the same batch again: every request answered, within
    2e-5 of JAX forward_local.  Member 1 leaves serving."""
    want, outs = members
    for m, out in enumerate(outs):
        if m == 1:
            assert bool(out["crash/evicted"])
            assert out["crash/ctr"].shape == (2 * 48,)
            continue
        assert not bool(out["crash/evicted"])
        assert out["crash/state"].tolist() == [
            1, 1, 1, 3, jdlrm.padded_tables(CFG, 3)]
        ctr = out["crash/ctr"]
        assert ctr.shape == (4 * 48,)
        err = float(np.abs(ctr - want["crash"]).max())
        assert err < 2e-5, (m, err)
