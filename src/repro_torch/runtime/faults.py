"""Deterministic fault injection for the BLS serving path (the port's own
copy of ``repro/runtime/faults.py``, numpy and ``time`` only; member
indices are ranks of the model group where the reference's are positions
on its mesh's model axis).

The paper's bound-k claim is conditional: a bound of k masks *transient*
per-member delays up to k iterations of slack (§IV), while *consistent*
stragglers cannot be masked by any bound and a crashed member cannot be
masked at all.  This module makes those three regimes injectable from ONE
seeded description so every layer consumes the same trace:

  * ``FaultPlan`` — a per-(member, step) delay table (seconds) plus crash
    steps, built from composable, deterministic events: seeded transient
    jitter, a single delay spike, a sustained straggler (constant extra
    seconds per step from a given step — the paper's unmaskable case), and
    a crash at step n.
  * ``core/schedule_sim`` integration — ``plan.to_workload`` injects the
    identical trace into the discrete-event simulator, and
    ``predict_absorption`` answers *in advance* whether bound k absorbs it
    (zero cross-member blocking beyond the fault-free schedule).
  * ``FaultInjector`` — the host-level runtime hook ``DLRMEngine.flush``
    drives: it sleeps the plan's delay before each dispatch (the slowest
    member gates the lockstep step), synthesizes the per-member latency
    telemetry a real deployment would collect (``latencies`` feeds
    ``straggler.detect_stragglers``), and raises ``NodeFailure`` with the
    surviving ranks at crash steps.  ``elastic_fault`` adapts the same
    plan to the reference's ``ElasticRunner.fault`` interface.

Everything is seeded and replayable: the same plan produces the same
delays, the same telemetry, and the same crash — so chaos tests assert
exact accounting (``ServeStats.approx_rows`` matches the plan) instead of
flaky timing behavior.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core import schedule_sim as sim
from repro_torch.runtime.elastic import NodeFailure, group_ranks

# the named steps of an online reshard (``runtime/reshard.py``), which a
# migration crash is scheduled at
MIG_STAGES = ("ship", "bank", "verify", "install", "commit")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded per-member fault trace over ``n_steps`` serving steps.

    ``delay[m, t]`` is the extra seconds member m needs at step t (both
    transient jitter and sustained-straggler excess live here — a
    consistent straggler IS a constant per-step delay, which is exactly
    why no bound masks it).  ``crash_step`` maps member -> the step at
    which it dies.  Plans are immutable; the ``with_*`` builders return
    extended copies so traces compose.
    """

    delay: np.ndarray                       # (n_members, n_steps) seconds
    crash_step: tuple = ()                  # ((member, step), ...)
    sustained_from: tuple = ()              # ((member, from_step, extra_s),)
    # traffic-side faults (the serving FRONTEND's chaos surface, not the
    # pod's): arrival-rate bursts the open-loop generator multiplies in,
    # and dequeue stalls the frontend pays before dispatching a batch
    arrival_burst: tuple = ()               # ((from_step, n_steps, factor),)
    queue_delay: tuple = ()                 # ((from_step, n_steps, seconds),)
    # freshness-side faults (the delta-update chaos surface, DESIGN.md
    # §10): payload corruption on the wire, update-rate bursts from the
    # trainer, an updater straggler (a member whose APPLY stalls while
    # serving continues from its last-good version), and a crash in the
    # middle of the atomic apply window
    delta_corrupt: tuple = ()               # ((member, step, n_rows),)
    update_burst: tuple = ()                # ((from_step, n_steps, factor),)
    apply_stall: tuple = ()                 # ((member, from_step, n_steps),)
    apply_crash: tuple = ()                 # ((member, step),)
    # placement-side faults (DESIGN.md §11): a crash at a named step of
    # an online reshard, and traffic-skew phase shifts that move the
    # hot-table set mid-stream (the load drift a rebalance answers)
    mig_crash: tuple = ()                   # ((member, stage, step),)
    skew_shift: tuple = ()                  # (at_step, ...)
    # integrity-side faults (DESIGN.md §12): single-bit flips in device-
    # resident state (a table row or its hot-cache copy) and serving-
    # payload corruption on a directed wire link — the silent-data-
    # corruption surface the scrub/quarantine/repair loop exists for
    bitflip: tuple = ()                     # ((member, table, row, bit,
    #                                          step, sticky, target),)
    wire_corrupt: tuple = ()                # ((src, dst, step),)
    seed: int = 0

    @classmethod
    def none(cls, n_members: int, n_steps: int, seed: int = 0) -> "FaultPlan":
        return cls(delay=np.zeros((n_members, n_steps)), seed=seed)

    @property
    def n_members(self) -> int:
        return self.delay.shape[0]

    @property
    def n_steps(self) -> int:
        return self.delay.shape[1]

    # -- builders (all deterministic) -------------------------------------

    def with_jitter(self, delay_max: float, *, members=None,
                    seed: Optional[int] = None) -> "FaultPlan":
        """Transient uniform U[0, delay_max] jitter per (member, step) —
        the paper's Setting 2, the case bound k is designed to mask."""
        rng = np.random.default_rng(self.seed if seed is None else seed)
        d = self.delay.copy()
        rows = range(self.n_members) if members is None else members
        for m in rows:
            d[m] += rng.uniform(0.0, delay_max, self.n_steps)
        return dataclasses.replace(self, delay=d)

    def with_spike(self, member: int, step: int, seconds: float
                   ) -> "FaultPlan":
        """One deterministic transient delay event."""
        d = self.delay.copy()
        d[member, step] += seconds
        return dataclasses.replace(self, delay=d)

    def with_straggler(self, member: int, extra_s: float, *,
                       from_step: int = 0) -> "FaultPlan":
        """A CONSISTENT straggler: constant extra seconds every step from
        ``from_step`` on — the §IV negative case no bound absorbs."""
        d = self.delay.copy()
        d[member, from_step:] += extra_s
        return dataclasses.replace(
            self, delay=d,
            sustained_from=self.sustained_from
            + ((int(member), int(from_step), float(extra_s)),))

    def with_crash(self, member: int, at_step: int) -> "FaultPlan":
        return dataclasses.replace(
            self, crash_step=self.crash_step + ((int(member), int(at_step)),))

    def with_arrival_burst(self, from_step: int, n_steps: int,
                           factor: float) -> "FaultPlan":
        """An arrival-rate burst: the open-loop request generator
        multiplies its rate by ``factor`` for arrivals whose step index
        falls in [from_step, from_step + n_steps) — the power-law traffic
        spike the frontend's admission control must survive.  Overlapping
        bursts compose multiplicatively (``arrival_factor``)."""
        if factor <= 0:
            raise ValueError(f"burst factor must be > 0, got {factor}")
        return dataclasses.replace(
            self, arrival_burst=self.arrival_burst
            + ((int(from_step), int(n_steps), float(factor)),))

    def with_queue_delay(self, from_step: int, n_steps: int,
                         seconds: float) -> "FaultPlan":
        """A dequeue stall: the frontend sleeps ``seconds`` extra before
        dispatching each batch in [from_step, from_step + n_steps) —
        modeling a slow upstream feature fetch or queue-lock contention.
        Overlapping windows add (``queue_delay_of``)."""
        return dataclasses.replace(
            self, queue_delay=self.queue_delay
            + ((int(from_step), int(n_steps), float(seconds)),))

    def with_delta_corruption(self, member: int, step: int, *,
                              n_rows: int = 1) -> "FaultPlan":
        """Corrupt ``n_rows`` delta rows of ``member``'s outbound slice at
        flush ``step`` (byte flips AFTER the source stamped its per-row
        checksums, so the receiver's verify must reject them and the
        source must re-ship — the lost-update case the checksum protocol
        exists for)."""
        return dataclasses.replace(
            self, delta_corrupt=self.delta_corrupt
            + ((int(member), int(step), int(n_rows)),))

    def with_update_burst(self, from_step: int, n_steps: int,
                          factor: float) -> "FaultPlan":
        """An update-rate burst from the trainer: the freshness manager
        pulls ``factor``× more versions per flush for steps in
        [from_step, from_step + n_steps) — the fastest-updater case the
        bounded-staleness gate must clamp (fast updaters BLOCK; they never
        widen the version spread past k_fresh).  Overlapping bursts
        compose multiplicatively (``update_factor``)."""
        if factor <= 0:
            raise ValueError(f"update factor must be > 0, got {factor}")
        return dataclasses.replace(
            self, update_burst=self.update_burst
            + ((int(from_step), int(n_steps), float(factor)),))

    def with_updater_straggler(self, member: int, *, from_step: int,
                               n_steps: int) -> "FaultPlan":
        """An updater straggler: ``member``'s delta APPLY stalls for steps
        in [from_step, from_step + n_steps) while its serving continues
        from the last-good version — the member everyone else's shipping
        gate ends up waiting on once it is k_fresh behind."""
        return dataclasses.replace(
            self, apply_stall=self.apply_stall
            + ((int(member), int(from_step), int(n_steps)),))

    def with_apply_crash(self, member: int, at_step: int) -> "FaultPlan":
        """A crash in the middle of ``member``'s atomic apply at flush
        ``at_step`` — AFTER the staged scatter, BEFORE the commit.  The
        double-buffered swap means the previous version stays intact and
        the engine's evict → replay path recovers from it."""
        return dataclasses.replace(
            self, apply_crash=self.apply_crash
            + ((int(member), int(at_step)),))

    def with_mig_crash(self, member: int, stage: str, *,
                       at_step: int = 0) -> "FaultPlan":
        """A crash at a named step of an online reshard (DESIGN.md §11):
        ``stage`` is one of ``ship`` (filling wire installments),
        ``bank`` (holding the harvest), ``verify`` (checksum pass),
        ``install`` (building the staged stack) or ``commit`` (between
        the cutover's two reference swaps).  Sticky at ``>= at_step``,
        like :meth:`with_apply_crash` — migrations pause under ladder
        pressure, so the first time the named stage RUNS at-or-after the
        step discovers the crash."""
        if stage not in MIG_STAGES:
            raise ValueError(
                f"unknown migration stage {stage!r}: one of {MIG_STAGES}")
        return dataclasses.replace(
            self, mig_crash=self.mig_crash
            + ((int(member), str(stage), int(at_step)),))

    def with_bitflip(self, member: int, table: int, row: int, bit: int,
                     when: int, sticky: bool = True, *,
                     target: str = "table") -> "FaultPlan":
        """Flip ONE bit of a device-resident embedding row — the silent
        corruption the background scrubber must detect, quarantine, and
        repair (DESIGN.md §12).  ``table``/``row`` are ORIGINAL-space;
        ``bit`` indexes into the row's wire bytes; ``target`` picks the
        resident table row (``"table"``) or its hot-cache copy
        (``"cache"``).  ``sticky`` triggers at the first flush >= when
        (the default — a flip does not miss its window because a replay
        renumbered the schedule); non-sticky fires only at exactly
        ``when``.  Each entry fires ONCE."""
        if target not in ("table", "cache"):
            raise ValueError(
                f"bitflip target must be 'table' or 'cache', got {target!r}")
        if bit < 0:
            raise ValueError(f"bit must be >= 0, got {bit}")
        return dataclasses.replace(
            self, bitflip=self.bitflip
            + ((int(member), int(table), int(row), int(bit), int(when),
                bool(sticky), str(target)),))

    def with_wire_corruption(self, src: int, dst: int, when: int
                             ) -> "FaultPlan":
        """Corrupt the fused serving payload on the directed link
        ``src → dst`` at flush ``when``: one byte of the slot's first
        non-checksum field XORs AFTER the source stamped its segment
        checksum, so the destination's end-to-end verify must reject the
        segment (zeroing its contribution) and the riders re-ship.
        Repeated entries on the same link model a persistently corrupt
        path — the case that escalates confirm → degrade → evict."""
        return dataclasses.replace(
            self, wire_corrupt=self.wire_corrupt
            + ((int(src), int(dst), int(when)),))

    def with_skew_shift(self, at_step: int) -> "FaultPlan":
        """A traffic-skew phase shift: from ``at_step`` on, the drifting
        hot-set generator (``data.synthetic.make_batch(mode='drift')``)
        draws its hot-TABLE permutation from the next phase — the
        mid-stream load drift that turns a once-balanced placement
        skewed.  Shifts compose; ``skew_phase`` counts them."""
        return dataclasses.replace(
            self, skew_shift=self.skew_shift + (int(at_step),))

    # -- queries -----------------------------------------------------------

    def delay_of(self, member: int, step: int) -> float:
        """Injected delay of ``member`` at ``step`` (steps past the plan
        horizon repeat the last column, so sustained stragglers stay
        sustained on long runs)."""
        return float(self.delay[member, min(step, self.n_steps - 1)])

    def crashes_at(self, step: int) -> list:
        return [m for m, s in self.crash_step if s == step]

    def sustained_members(self, *, at_step: Optional[int] = None) -> list:
        """Members under a sustained slowdown (at ``at_step``, or ever)."""
        return sorted({m for m, s, _ in self.sustained_from
                       if at_step is None or at_step >= s})

    def arrival_factor(self, step: int) -> float:
        """Arrival-rate multiplier at ``step`` (1.0 outside every burst;
        overlapping bursts multiply)."""
        f = 1.0
        for s0, n, factor in self.arrival_burst:
            if s0 <= step < s0 + n:
                f *= factor
        return f

    def queue_delay_of(self, step: int) -> float:
        """Extra dequeue stall (seconds) the frontend pays at ``step``
        (overlapping windows add)."""
        return sum(sec for s0, n, sec in self.queue_delay
                   if s0 <= step < s0 + n)

    def update_factor(self, step: int) -> float:
        """Trainer update-rate multiplier at ``step`` (1.0 outside every
        burst; overlapping bursts multiply)."""
        f = 1.0
        for s0, n, factor in self.update_burst:
            if s0 <= step < s0 + n:
                f *= factor
        return f

    def delta_corrupt_at(self, step: int) -> list:
        """[(member, n_rows)] of outbound delta slices corrupted at
        ``step`` (member indices are ORIGINAL ranks)."""
        return [(m, n) for m, s, n in self.delta_corrupt if s == step]

    def apply_stalled(self, member: int, step: int) -> bool:
        """True when ``member``'s delta apply is stalled at ``step``."""
        return any(m == member and s0 <= step < s0 + n
                   for m, s0, n in self.apply_stall)

    def apply_crashes_at(self, step: int) -> list:
        return [m for m, s in self.apply_crash if s == step]

    def skew_phase(self, step: int) -> int:
        """Traffic-skew phase at ``step``: the number of shifts already
        past — the ``phase`` argument the drift traffic generator
        consumes."""
        return sum(1 for s in self.skew_shift if step >= s)

    def transient_only(self) -> bool:
        return not self.crash_step and not self.sustained_from

    # -- simulator integration (core/schedule_sim) -------------------------

    def to_workload(self, n_iters: Optional[int] = None, **stage_times
                    ) -> sim.Workload:
        """The SAME trace as a simulator workload: base stage times from
        ``make_workload`` (t_emb/t_bot/t_top/t_wire), plan delays injected
        verbatim into ``Workload.delay``.  Crashes are outside the
        simulator's timing model (recovery is the engine's domain) and
        raise here rather than silently predicting nonsense."""
        if self.crash_step:
            raise ValueError(
                "to_workload: the schedule simulator models timing, not "
                "recovery — predict absorption on the pre-crash plan and "
                "drive the crash through FaultInjector/DLRMEngine")
        n = self.n_steps if n_iters is None else int(n_iters)
        w = sim.make_workload(self.n_members, n, **stage_times)
        cols = np.minimum(np.arange(n), self.n_steps - 1)
        w.delay = w.delay + self.delay[:, cols]
        return w


@dataclasses.dataclass(frozen=True)
class AbsorptionPrediction:
    """``predict_absorption``'s verdict for one (plan, bound) pair."""
    bound: int
    blocked_s: float            # cross-member stall under the fault plan
    baseline_blocked_s: float   # stall of the fault-free schedule
    makespan_s: float
    baseline_makespan_s: float

    @property
    def absorbed(self) -> bool:
        """True when bound k masks the plan completely: no member ever
        waits on exchange data beyond what the fault-free schedule
        already waits (paper §IV's definition of masking)."""
        return self.blocked_s <= self.baseline_blocked_s + 1e-12


def predict_absorption(plan: FaultPlan, bound: int, *,
                       n_iters: Optional[int] = None,
                       backend: str = "bls", **stage_times
                       ) -> AbsorptionPrediction:
    """Feed the plan to ``schedule_sim.simulate`` and report whether bound
    k absorbs it.  ``stage_times`` are ``make_workload`` kwargs (t_emb,
    t_bot, t_top, t_wire); the fault-free baseline uses the same ones."""
    w = plan.to_workload(n_iters, **stage_times)
    base = FaultPlan.none(plan.n_members, plan.n_steps, plan.seed) \
        .to_workload(n_iters, **stage_times)
    r = sim.simulate(w, bound, backend=backend)
    r0 = sim.simulate(base, bound, backend=backend)
    return AbsorptionPrediction(
        bound=int(bound), blocked_s=r.blocked_s,
        baseline_blocked_s=r0.blocked_s, makespan_s=r.makespan,
        baseline_makespan_s=r0.makespan)


class FaultInjector:
    """Runtime half of a :class:`FaultPlan`: the host-level hook the
    serving engine (and ``ElasticRunner``) drive.

    One injector simulates the whole pod's fault behavior from inside a
    single process (each member process runs its own copy of the same
    plan): ``on_flush`` sleeps the slowest live member's delay before
    each lockstep dispatch and raises :class:`NodeFailure` (with the
    surviving global ranks of the model group) at crash steps;
    ``latencies`` synthesizes the per-member step-latency telemetry a
    real deployment's monitoring would feed ``detect_stragglers``.

    Member indices in the plan are ORIGINAL ranks; after a crash the
    survivors renumber to group ranks 0..P-2 and the injector keeps the
    mapping (``live``), so telemetry keys always match the current
    group's ranks.
    """

    def __init__(self, plan: FaultPlan, *, time_scale: float = 1.0):
        self.plan = plan
        self.time_scale = float(time_scale)
        self.live = list(range(plan.n_members))
        self.fired: set = set()
        self.injected_delay_s = 0.0
        self.injected_queue_delay_s = 0.0

    def host_delay(self, step: int, exclude=()) -> float:
        """The delay the lockstep step pays: max over live members.
        ``exclude`` lists CURRENT group ranks the step no longer waits
        on (degraded serving) — their delays stop gating the flush."""
        mems = [m for pos, m in enumerate(self.live) if pos not in exclude]
        if not mems:
            return 0.0
        return max(self.plan.delay_of(m, step) for m in mems)

    def on_flush(self, step: int, group=None, *, exclude=()) -> None:
        """Called by the engine before dispatching flush ``step``.  May
        sleep (scaled by ``time_scale``) and may raise NodeFailure.
        ``exclude`` as in :meth:`host_delay` (a degraded member still
        crashes on schedule — it is served around, not forgotten)."""
        for m in list(self.live):
            if m in self.fired:
                continue
            if any(cm == m and cs == step for cm, cs in self.plan.crash_step):
                pos = self.live.index(m)
                self.fired.add(m)
                self.live.remove(m)
                raise NodeFailure(self._survivors(group, pos))
        d = self.host_delay(step, exclude) * self.time_scale
        if d > 0:
            time.sleep(d)
            self.injected_delay_s += d

    def on_apply(self, step: int, group=None) -> None:
        """Called by the freshness manager INSIDE the atomic apply window
        (after the staged scatter, before the commit): raises NodeFailure
        for ``apply_crash`` entries — the crash-mid-apply case whose
        recovery must find the previous version intact.  Crash bookkeeping
        is shared with :meth:`on_flush` (``fired``/``live``), so a member
        crashes exactly once however it dies.  The trigger is STICKY
        (``>= at_step``): an apply window may not open at the scheduled
        flush (nothing ready — e.g. every buffered row is held for a
        stalled member), and a dead member does not come back because its
        crash missed the window — the first apply at-or-after the step
        discovers it."""
        for m in list(self.live):
            if m in self.fired:
                continue
            if any(cm == m and step >= cs
                   for cm, cs in self.plan.apply_crash):
                pos = self.live.index(m)
                self.fired.add(m)
                self.live.remove(m)
                raise NodeFailure(self._survivors(group, pos))

    def on_migrate(self, step: int, stage: str, *, group=None) -> None:
        """Called by the reshard executor at each named migration step
        (``ship``/``bank``/``verify``/``install``/``commit``): raises
        NodeFailure for matching ``mig_crash`` entries.  Sticky
        (``>= at_step``) and sharing crash bookkeeping with
        :meth:`on_flush`/:meth:`on_apply` — a member dies exactly once
        however it dies, and the evict→replay path that catches this is
        the same one that aborts the reshard."""
        for m in list(self.live):
            if m in self.fired:
                continue
            if any(cm == m and cstage == stage and step >= cs
                   for cm, cstage, cs in self.plan.mig_crash):
                pos = self.live.index(m)
                self.fired.add(m)
                self.live.remove(m)
                raise NodeFailure(self._survivors(group, pos))

    def skew_phase(self, step: int) -> int:
        return self.plan.skew_phase(step)

    def corrupt_rows(self, step: int) -> list:
        """[(current_pos, n_rows)] outbound delta slices to corrupt at
        ``step`` — plan members mapped to CURRENT group ranks; crashed
        members drop out (nothing of theirs is on the wire)."""
        out = []
        for m, n in self.plan.delta_corrupt_at(step):
            if m in self.live:
                out.append((self.live.index(m), n))
        return out

    def bitflips(self, step: int) -> list:
        """[(current_pos, table, row, bit, target)] bit flips due at
        flush ``step``.  Fire-once per plan entry (a sticky flip lands at
        the first flush >= its step and never again — re-flipping would
        UN-corrupt); crashed members' entries drop out with them."""
        out = []
        for i, (m, t, r, b, w, sticky, tgt) in \
                enumerate(self.plan.bitflip):
            key = ("bf", i)
            if key in self.fired or m not in self.live:
                continue
            due = step >= w if sticky else step == w
            if due:
                self.fired.add(key)
                out.append((self.live.index(m), t, r, b, tgt))
        return out

    def wire_corruptions(self, step: int) -> set:
        """{(src_pos, dst_pos)} directed links whose serving payload is
        corrupted at flush ``step`` (plan ranks mapped to CURRENT group
        ranks; links touching crashed members drop out)."""
        out = set()
        for s, d, w in self.plan.wire_corrupt:
            if w == step and s in self.live and d in self.live:
                out.add((self.live.index(s), self.live.index(d)))
        return out

    def stalled_positions(self, step: int) -> set:
        """CURRENT group ranks whose delta apply is stalled at
        ``step`` (the updater-straggler fault)."""
        return {pos for pos, m in enumerate(self.live)
                if self.plan.apply_stalled(m, step)}

    def update_factor(self, step: int) -> float:
        return self.plan.update_factor(step)

    def on_dequeue(self, step: int) -> float:
        """Called by the serving FRONTEND before dispatching batch
        ``step``: sleeps the plan's queue-delay stall (scaled by
        ``time_scale``) and returns the seconds injected — the knob chaos
        runs use to blow up queue-drain predictions and exercise the
        shed/degrade ladder."""
        d = self.plan.queue_delay_of(step) * self.time_scale
        if d > 0:
            time.sleep(d)
            self.injected_queue_delay_s += d
        return d

    def _survivors(self, group, pos: int) -> list:
        """Global ranks left after dropping the crashed member, group rank
        ``pos`` among the pre-crash live set, from ``group``."""
        if group is None:
            return []
        return [r for j, r in enumerate(group_ranks(group)) if j != pos]

    def latencies(self, step: int, base_s: float) -> dict:
        """Synthesized per-member step latencies at ``step``, keyed by
        CURRENT group rank: base latency + that member's injected
        delay.  This is the dict ``detect_stragglers`` consumes."""
        return {pos: base_s + self.plan.delay_of(orig, step)
                for pos, orig in enumerate(self.live)}

    def position_of(self, member: int) -> Optional[int]:
        """Current group rank of an original member rank (None once
        crashed)."""
        return self.live.index(member) if member in self.live else None

    def elastic_fault(self, devices):
        """Adapt the plan to the ``ElasticRunner.run(fault=...)``
        interface: ``devices`` are split contiguously among the plan's
        members; the returned callable sleeps the per-step delay and
        raises NodeFailure with the live members' devices at crash
        steps."""
        chunks = np.array_split(np.asarray(list(devices), dtype=object),
                                self.plan.n_members)

        def fault(step: int) -> None:
            for m in list(self.live):
                if m in self.fired:
                    continue
                if any(cm == m and cs == step
                       for cm, cs in self.plan.crash_step):
                    self.fired.add(m)
                    self.live.remove(m)
                    surv = [d for i in self.live for d in chunks[i]]
                    raise NodeFailure(surv)
            d = self.host_delay(step) * self.time_scale
            if d > 0:
                time.sleep(d)
                self.injected_delay_s += d

        return fault
