"""Overload-robust continuous-batching front end over ``DLRMEngine`` (the
port of ``repro/serving/frontend.py``).

It turns the engine's fixed-size batches into a service for open-loop,
bursty, multi-tenant traffic, where the tail latency decides:

  * **Bounded multi-tenant request queue**: every request carries its
    arrival time and an absolute deadline; the queue depth is capped.
  * **SLO-aware admission**: ``try_submit`` REJECTS at enqueue when the
    queue's predicted drain time (batches ahead × a rolling flush-time
    EWMA) already breaches the request's deadline.
  * **Caller-visible backpressure**: a rejection returns ``RETRY_AFTER``
    with a jittered exponential-backoff hint per tenant.
  * **Dynamic microbatch shaping**: a batch fills until the tightest
    queued deadline can no longer afford to wait (the same EWMA), not to a
    fixed B; the engine pads the rest.
  * **Deadline-aware shedding at dequeue**, monotone in the deadline.
  * **Per-tenant weighted-fair dequeue**: with ``tenant_weights`` set,
    batches form by integer-weight deficit round-robin over per-tenant
    FIFO queues, ahead of the shed pass.
  * **Graceful-degradation ladder**: sustained overload escalates FULL ->
    DEGRADED (the engine's ``degrade``, the quality loss ledgered) -> SHED;
    recovery de-escalates.
  * **Lookahead**: requests peeked before their batch forms warm the hot
    cache's access counts (rebuilding it through ``adopt_cache``) and
    stage the next batch's stream plans through ``stage_plan``.

Every transition is ledgered in :class:`FrontendStats` (a ``ServeStats``
the engine SHARES), and the conservation invariant

    admitted == served + degraded_served + shed        (after ``drain``)

holds exactly.  Single-threaded: one pump loop owns the queue, so every
decision is deterministic under an injected clock.  The logic is host
numpy; the only device work it starts is the engine's, and the lookahead's
hit-rate probe on the cache's device.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np

import torch

from repro_torch.serving import hot_cache as HC
from repro_torch.serving.engine import ServeStats

ADMITTED = "admitted"
RETRY_AFTER = "retry_after"


@dataclasses.dataclass(frozen=True)
class SubmitResult:
    """``try_submit``'s verdict.  ``RETRY_AFTER`` carries the backoff
    hint: the earliest time (seconds from now) a well-behaved client
    should retry — exponential in the tenant's consecutive rejections,
    jittered so synchronized clients desynchronize."""
    status: str
    request_id: int = -1
    retry_after_s: float = 0.0
    reason: str = ""

    @property
    def admitted(self) -> bool:
        return self.status == ADMITTED


@dataclasses.dataclass(frozen=True)
class ServedRequest:
    """One completed request with its full latency decomposition."""
    request_id: int
    tenant: str
    ctr: float
    t_arrive: float
    t_dispatch: float
    t_done: float
    deadline: float
    degraded: bool

    @property
    def queue_delay_s(self) -> float:
        return self.t_dispatch - self.t_arrive

    @property
    def e2e_s(self) -> float:
        return self.t_done - self.t_arrive

    @property
    def in_slo(self) -> bool:
        return self.t_done <= self.deadline


@dataclasses.dataclass(frozen=True)
class _Request:
    rid: int
    tenant: str
    dense: np.ndarray
    idx: np.ndarray
    mask: np.ndarray
    t_arrive: float
    deadline: float              # absolute, on the frontend's clock


class LatencyHistogram:
    """Log₂-bucketed latency histogram with exact percentiles.

    Buckets are powers of two from 0.1 ms up (JSON-stable edges for the
    BENCH trajectory); the raw samples are kept too, so ``percentile`` is
    exact rather than bucket-quantized — at serving-bench scale (10³–10⁴
    samples) exactness is worth the few kilobytes."""

    EDGE0_S = 1e-4
    N_BUCKETS = 24               # 0.1 ms .. ~840 s

    def __init__(self):
        self.samples: list = []
        self.buckets = [0] * self.N_BUCKETS

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        self.samples.append(s)
        b = 0 if s < self.EDGE0_S else \
            min(self.N_BUCKETS - 1, 1 + int(math.log2(s / self.EDGE0_S)))
        self.buckets[b] += 1

    def __len__(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def to_dict(self) -> dict:
        edges_ms = [0.0] + [self.EDGE0_S * (2 ** k) * 1e3
                            for k in range(self.N_BUCKETS - 1)]
        return {
            "count": len(self.samples),
            "mean_ms": (sum(self.samples) / len(self.samples) * 1e3
                        if self.samples else 0.0),
            "p50_ms": self.percentile(0.50) * 1e3,
            "p99_ms": self.percentile(0.99) * 1e3,
            "max_ms": max(self.samples) * 1e3 if self.samples else 0.0,
            "bucket_edges_ms": edges_ms,
            "bucket_counts": list(self.buckets),
        }


@dataclasses.dataclass
class FrontendStats(ServeStats):
    """``ServeStats`` extended with the frontend's request-level ledger.
    The frontend installs ONE instance as the engine's ``stats`` too, so
    batch-level accounting (batches/requests/deadline breaches/approx
    rows) and request-level accounting share an object and
    ``to_dict`` is the single machine-readable surface."""
    offered: int = 0             # try_submit calls
    admitted: int = 0            # accepted into the queue
    rejected: int = 0            # RETRY_AFTER responses issued
    retried: int = 0             # admissions that followed >= 1 rejection
    shed: int = 0                # admitted, dropped at dequeue (deadline)
    served: int = 0              # completed at ladder level FULL
    degraded_served: int = 0     # completed at ladder level >= DEGRADED
    served_late: int = 0         # completed past their own deadline
    escalations: int = 0         # ladder level increments
    deescalations: int = 0       # ladder level decrements
    level: int = 0               # current ladder level (0/1/2)
    plans_staged: int = 0        # lookahead stream-plan prefetches
    cache_warms: int = 0         # lookahead-triggered cache rebuilds
    queue_delay: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    e2e: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    # live state mirrored by the owning frontend so ``accounted`` holds
    # at EVERY instant, not just after drain
    queued: int = 0              # in the request queue
    inflight: int = 0            # dispatched, result not yet harvested

    @property
    def completed(self) -> int:
        return self.served + self.degraded_served

    @property
    def accounted(self) -> bool:
        """The conservation invariant (exact, not approximate): every
        admitted request is queued, in flight, completed, or shed."""
        return self.admitted == (self.completed + self.shed
                                 + self.queued + self.inflight)

    def to_dict(self) -> dict:
        d = super().to_dict()
        for f in dataclasses.fields(FrontendStats):
            if f.name in d:
                continue
            v = getattr(self, f.name)
            d[f.name] = v.to_dict() if isinstance(v, LatencyHistogram) \
                else v
        d["completed"] = self.completed
        d["accounted"] = self.accounted
        return d


LEVEL_FULL, LEVEL_DEGRADED, LEVEL_SHED = 0, 1, 2


class ServingFrontend:
    """Continuous-batching, SLO-defending front end over a ``DLRMEngine``.

    Parameters (the serving-policy surface):
      slo_s             default deadline budget per request (a request may
                        carry its own ``deadline_s``).
      max_queue         queue bound; ``admission='none'`` ignores it.
      admission         'slo' (bound + predicted-drain deadline check),
                        'queue' (bound only), 'none' (accept everything —
                        the breaching baseline).
      shed              deadline-aware shedding at dequeue (disable to
                        model the naive baseline).
      ewma_alpha        rolling flush-time EWMA weight (the drain/shed
                        predictor).
      dispatch_headroom batch shaping: dispatch once
                        now + EWMA·headroom reaches the tightest queued
                        deadline.
      linger_s          max time the oldest request waits for batch-mates
                        (default slo_s / 4).
      retry_base_s / retry_cap_s / seed   backoff-hint shape.
      degrade_members   model-axis members the DEGRADED ladder level
                        serves around (engine ``degrade``); empty () keeps
                        the level a shaping-only state.
      escalate_after / deescalate_after   consecutive overloaded / clean
                        pumps before a ladder transition.
      lookahead         stage next-batch stream plans + warm cache counts
                        from peeked requests (default: on when the engine
                        pipelines plans or has a cache).
      warm_every / warm_threshold   rebuild the hot cache from observed
                        counts when the peeked hit rate sinks below the
                        threshold (0 disables).
      tenant_weights    dict tenant -> integer weight enabling the
                        weighted-fair (deficit round-robin) dequeue;
                        None (default) keeps the single global FIFO.
                        Unlisted tenants get ``default_weight``.
      faults            a ``runtime.faults.FaultInjector`` whose
                        ``on_dequeue`` stalls batch dispatch (chaos).
      clock             injectable monotonic clock (tests use a virtual
                        one; every decision is deterministic under it).
    """

    def __init__(self, engine, *, slo_s: float, max_queue: int = 1024,
                 admission: str = "slo", shed: bool = True,
                 ewma_alpha: float = 0.25, init_flush_s: float = 0.0,
                 dispatch_headroom: float = 1.25,
                 linger_s: Optional[float] = None,
                 shed_margin: float = 0.5,
                 retry_base_s: float = 0.002, retry_cap_s: float = 0.5,
                 seed: int = 0,
                 degrade_members: tuple = (),
                 escalate_after: int = 3, deescalate_after: int = 8,
                 window: int = 128,
                 lookahead: Optional[bool] = None,
                 warm_every: int = 0, warm_threshold: float = 0.5,
                 tenant_weights: Optional[dict] = None,
                 default_weight: int = 1,
                 faults=None,
                 clock: Callable[[], float] = time.perf_counter):
        if admission not in ("slo", "queue", "none"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.engine = engine
        self.slo_s = float(slo_s)
        self.max_queue = int(max_queue)
        self.admission = admission
        self.shed = bool(shed)
        self.ewma_alpha = float(ewma_alpha)
        self.dispatch_headroom = float(dispatch_headroom)
        self.linger_s = float(linger_s) if linger_s is not None \
            else self.slo_s / 4.0
        self.shed_margin = float(shed_margin)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        self.degrade_members = tuple(degrade_members)
        self.escalate_after = max(1, int(escalate_after))
        self.deescalate_after = max(1, int(deescalate_after))
        if tenant_weights is not None:
            tenant_weights = {str(t): int(w)
                              for t, w in dict(tenant_weights).items()}
            bad = {t: w for t, w in tenant_weights.items() if w < 1}
            if bad:
                raise ValueError(f"tenant weights must be >= 1: {bad}")
        if int(default_weight) < 1:
            raise ValueError("default_weight must be >= 1")
        self.tenant_weights = tenant_weights
        self.default_weight = int(default_weight)
        self.faults = faults
        self._clock = clock
        self._rng = np.random.default_rng(seed)
        if lookahead is None:
            lookahead = bool(getattr(engine, "plan_pipeline", False)
                             or getattr(engine, "cache", None) is not None)
        self.lookahead = bool(lookahead)
        self.warm_every = int(warm_every)
        self.warm_threshold = float(warm_threshold)

        # ONE ledger: the engine's batch-level counters land in the same
        # extended object as the frontend's request-level ones
        self.stats = FrontendStats(**{
            f.name: getattr(engine.stats, f.name)
            for f in dataclasses.fields(ServeStats)})
        engine.stats = self.stats

        self._queue: collections.deque = collections.deque()
        # weighted-fair mode: per-tenant FIFO queues + DRR bookkeeping
        # (registration order is the round-robin order; deficits are
        # integers, so selection is exactly reproducible)
        self._tq: dict = {}                  # tenant -> deque[_Request]
        self._deficit: dict = {}             # tenant -> int DRR deficit
        self._rr: list = []                  # tenant registration order
        self._rr_pos = 0                     # next tenant to visit
        self._rid = 0
        self._ewma_flush: Optional[float] = \
            float(init_flush_s) if init_flush_s > 0 else None
        # flush-time EWMA is layout-conditioned: a placement cutover or an
        # eviction changes per-member work, so the predictor recalibrates
        # whenever the engine's layout_version moves
        self._layout_seen = getattr(engine, "layout_version", 0)
        self._reject_streak: dict = {}       # tenant -> consecutive rejects
        self._dispatched: collections.deque = collections.deque()
        self._n_dispatched = 0
        self._recent_e2e: collections.deque = collections.deque(
            maxlen=max(8, int(window)))
        self._hot_streak = 0
        self._ok_streak = 0
        self._staged_rids: tuple = ()
        self._counts = None                  # lookahead access frequencies
        if self.lookahead and getattr(engine, "cache", None) is not None:
            t, r = engine.params["tables"].shape[:2]
            self._counts = np.zeros((t, r))

    # -- the queue surface (single FIFO, or per-tenant DRR) ----------------
    # Every queue touch goes through these helpers.  With tenant_weights
    # None they delegate straight to the one global deque — behavior
    # identical to the pre-DRR frontend; with weights set, requests live
    # in per-tenant FIFOs and BATCH FORMATION order comes from integer
    # deficit round-robin.

    @property
    def weighted(self) -> bool:
        return self.tenant_weights is not None

    def _weight(self, tenant: str) -> int:
        return max(1, self.tenant_weights.get(tenant, self.default_weight))

    def _qlen(self) -> int:
        if not self.weighted:
            return len(self._queue)
        return sum(len(q) for q in self._tq.values())

    def _qappend(self, r: "_Request") -> None:
        if not self.weighted:
            self._queue.append(r)
            return
        q = self._tq.get(r.tenant)
        if q is None:
            q = self._tq[r.tenant] = collections.deque()
            self._deficit[r.tenant] = 0
            self._rr.append(r.tenant)
        q.append(r)

    def _drr_select(self, n: int, commit: bool) -> list:
        """Up to ``n`` requests in deficit-round-robin order.  Each visit
        to a non-empty tenant queue adds the tenant's weight to its
        deficit and takes that many of its oldest requests (FIFO within
        tenant), so over sustained contention tenant slot shares converge
        to the weight ratios while an idle tenant costs nothing (its
        deficit resets when its queue empties — no banked credit).
        ``commit=False`` is the non-destructive peek the batch-shaping
        and lookahead paths use: identical order, no state touched."""
        sel: list = []
        if not self._rr:
            return sel
        taken = {t: 0 for t in self._rr}
        deficit = dict(self._deficit)
        pos = self._rr_pos % len(self._rr)
        last = pos
        while len(sel) < n:
            if not any(len(self._tq[t]) - taken[t] > 0 for t in self._rr):
                break
            t = self._rr[pos]
            last = pos
            pos = (pos + 1) % len(self._rr)
            avail = len(self._tq[t]) - taken[t]
            if avail <= 0:
                continue
            deficit[t] += self._weight(t)
            k = min(deficit[t], avail, n - len(sel))
            q = self._tq[t]
            sel.extend(q[taken[t] + j] for j in range(k))
            taken[t] += k
            deficit[t] -= k
            if len(q) - taken[t] == 0:
                deficit[t] = 0
        if commit:
            for t, k in taken.items():
                for _ in range(k):
                    self._tq[t].popleft()
            self._deficit = deficit
            self._rr_pos = (last + 1) % len(self._rr)
        return sel

    def _qpeek(self, n: int) -> list:
        if not self.weighted:
            return list(self._queue)[:n]
        return self._drr_select(n, commit=False)

    def _qtake(self, n: int) -> list:
        if not self.weighted:
            return [self._queue.popleft()
                    for _ in range(min(n, len(self._queue)))]
        return self._drr_select(n, commit=True)

    def _oldest_arrival(self) -> float:
        if not self.weighted:
            return self._queue[0].t_arrive
        return min(q[0].t_arrive for q in self._tq.values() if q)

    def _qshed(self, cutoff: float) -> None:
        """Deadline-monotone shed over every queue (one cutoff per pass,
        applied uniformly — fairness weights never shield expired
        work)."""
        queues = [self._queue] if not self.weighted \
            else list(self._tq.values())
        for q in queues:
            for _ in range(len(q)):
                r = q.popleft()
                if r.deadline < cutoff:
                    self.stats.shed += 1
                else:
                    q.append(r)

    # -- prediction --------------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def predicted_flush_s(self) -> float:
        """Rolling EWMA of the measured batch flush time — the one number
        admission, shaping and shedding all key off."""
        return self._ewma_flush if self._ewma_flush is not None else 0.0

    def _observe_flush(self, seconds: float) -> None:
        lv = getattr(self.engine, "layout_version", 0)
        if lv != self._layout_seen:
            # the layout changed under this flush (cutover / eviction):
            # forget the old layout's EWMA AND skip this observation —
            # the flush that spans the swap carries one-off re-jit cost
            # that would poison the fresh estimate
            self._layout_seen = lv
            self._ewma_flush = None
            return
        s = max(float(seconds), 0.0)
        self._ewma_flush = s if self._ewma_flush is None else \
            (1 - self.ewma_alpha) * self._ewma_flush + self.ewma_alpha * s

    def predicted_wait_s(self, n_ahead: int) -> float:
        """Predicted time until a request with ``n_ahead - 1`` requests in
        front of it COMPLETES: whole batches ahead of it, plus its own
        flush, each at the EWMA estimate."""
        b = self.engine.batch_size
        return math.ceil(max(n_ahead, 1) / b) * self.predicted_flush_s()

    def shed_cutoff(self, now: float) -> float:
        """Deadline threshold of the dequeue shed pass: a queued request
        whose deadline is BEFORE this cannot complete in time even if
        dispatched immediately.  Monotone in the deadline by construction
        (one cutoff per pass); the SHED ladder level adds margin so the
        frontend stops gambling on the EWMA's optimism."""
        margin = self.shed_margin if self.stats.level >= LEVEL_SHED else 0.0
        return now + self.predicted_flush_s() * (1.0 + margin)

    # -- admission + backpressure -----------------------------------------

    def try_submit(self, dense, idx, mask, *, deadline_s: Optional[float]
                   = None, tenant: str = "default",
                   now: Optional[float] = None) -> SubmitResult:
        """Admit one request or refuse it with a backoff hint.  Admission
        never blocks and never silently drops: every call is ledgered as
        admitted or rejected."""
        now = self.now() if now is None else now
        self.stats.offered += 1
        deadline = now + (self.slo_s if deadline_s is None
                          else float(deadline_s))
        if self.admission != "none" and self._qlen() >= self.max_queue:
            return self._reject(tenant, "queue_full")
        if self.admission == "slo" and \
                now + self.predicted_wait_s(self._qlen() + 1) > deadline:
            return self._reject(tenant, "predicted_slo_breach")
        rid = self._rid
        self._rid += 1
        self._qappend(_Request(rid, tenant, np.asarray(dense),
                               np.asarray(idx), np.asarray(mask),
                               now, deadline))
        self.stats.admitted += 1
        self.stats.queued = self._qlen()
        if self._reject_streak.pop(tenant, 0):
            self.stats.retried += 1      # backpressure worked: retry landed
        if self._counts is not None:
            # lookahead cache warming: observe the access stream AT
            # ADMISSION (each request exactly once, before its batch forms)
            HC.observe(self._counts, np.asarray(idx)[None],
                       np.asarray(mask)[None])
        return SubmitResult(ADMITTED, request_id=rid)

    def _reject(self, tenant: str, reason: str) -> SubmitResult:
        n = self._reject_streak.get(tenant, 0)
        self._reject_streak[tenant] = n + 1
        # 2 ** n stops converting to a float at n = 1024 (the reference
        # raises OverflowError there); capping the exponent below that
        # changes no hint the reference returns
        hint = min(self.retry_cap_s, self.retry_base_s * (2 ** min(n, 1023)))
        hint *= 1.0 + 0.5 * float(self._rng.random())   # jitter: desync
        self.stats.rejected += 1
        return SubmitResult(RETRY_AFTER, retry_after_s=hint, reason=reason)

    # -- batch shaping + dispatch -----------------------------------------

    def _dispatch_due(self, now: float) -> bool:
        """Fill-to-a-latency-budget shaping: dispatch when the batch is
        full, when the tightest queued deadline can no longer afford
        waiting (EWMA·headroom), when the oldest request has lingered its
        budget, or unconditionally at the SHED ladder level (drain
        fast)."""
        if self._qlen() == 0:
            return False
        b = self.engine.batch_size
        if self._qlen() >= b or self.stats.level >= LEVEL_SHED:
            return True
        head = self._qpeek(b)
        tightest = min(r.deadline for r in head)
        if now + self.predicted_flush_s() * self.dispatch_headroom \
                >= tightest:
            return True
        return now - self._oldest_arrival() >= self.linger_s

    def pump(self, now: Optional[float] = None) -> list:
        """One scheduling round: shed expired work, dispatch a batch if
        shaping says so (else harvest any deferred pipeline result), run
        the lookahead, update the ladder.  Returns the requests COMPLETED
        this round (list of :class:`ServedRequest`)."""
        now = self.now() if now is None else now
        completed: list = []
        if self._dispatch_due(now):
            completed = self._dispatch(now)
        elif self._dispatched and self._qlen() == 0:
            # pipeline tail: nothing to send, but a deferred batch may be
            # ready — an empty flush harvests without dispatching
            out = self.engine.flush()
            if out is not None:
                completed = self._complete(out, self.now())
        self._maybe_prefetch()
        self._update_ladder(self.now() if completed else now)
        self.stats.queued = self._qlen()
        return completed

    def _shed_pass(self, now: float) -> None:
        if not self.shed:
            return
        self._qshed(self.shed_cutoff(now))

    def _dispatch(self, now: float) -> list:
        self._shed_pass(now)
        if self._qlen() == 0:
            self.stats.queued = 0
            return []
        b = self.engine.batch_size
        batch = self._qtake(b)
        self.stats.queued = self._qlen()
        if self.faults is not None and hasattr(self.faults, "on_dequeue"):
            self.faults.on_dequeue(self._n_dispatched)
        t0 = self.now()
        out = None
        for r in batch:
            ret = self.engine.submit(r.dense, r.idx, r.mask)
            if ret is not None:
                out = ret                    # engine auto-flushed at B
        if len(batch) < b:
            # partial batch: the engine did not auto-flush — do it
            # explicitly (exactly once; a full batch already flushed, and
            # a pipelined first flush legitimately returns None)
            ret = self.engine.flush()
            if ret is not None:
                out = ret
        t1 = self.now()
        self._observe_flush(t1 - t0)
        self._dispatched.append((batch, t0, self.stats.level))
        self.stats.inflight += len(batch)
        self._n_dispatched += 1
        # inline engines return THIS batch; plan-pipelined engines return
        # the PREVIOUS one (or None on the first flush) — FIFO attribution
        # handles both
        return self._complete(out, t1) if out is not None else []

    def _complete(self, out, t_done: float) -> list:
        batch, t_disp, level = self._dispatched.popleft()
        out = np.asarray(out).reshape(-1)
        if len(out) != len(batch):
            raise RuntimeError(
                f"batch attribution drifted: engine returned {len(out)} "
                f"CTRs for a dispatched batch of {len(batch)}")
        self.stats.inflight -= len(batch)
        served = []
        degraded = level >= LEVEL_DEGRADED
        for r, ctr in zip(batch, out):
            sr = ServedRequest(r.rid, r.tenant, float(ctr), r.t_arrive,
                               t_disp, t_done, r.deadline, degraded)
            if degraded:
                self.stats.degraded_served += 1
            else:
                self.stats.served += 1
            if not sr.in_slo:
                self.stats.served_late += 1
            self.stats.queue_delay.record(sr.queue_delay_s)
            self.stats.e2e.record(sr.e2e_s)
            self._recent_e2e.append(sr.e2e_s)
            served.append(sr)
        return served

    # -- graceful-degradation ladder --------------------------------------

    def overloaded(self) -> bool:
        """Sustained-overload signal: served p99 (recent window) over the
        SLO, or the queue within 80% of its bound."""
        if self._qlen() >= 0.8 * self.max_queue:
            return True
        if len(self._recent_e2e) >= 8:
            xs = sorted(self._recent_e2e)
            if xs[min(len(xs) - 1, int(0.99 * len(xs)))] > self.slo_s:
                return True
        return False

    def _update_ladder(self, now: float) -> None:
        if self.overloaded():
            self._hot_streak += 1
            self._ok_streak = 0
            if self._hot_streak >= self.escalate_after and \
                    self.stats.level < LEVEL_SHED:
                self._set_level(self.stats.level + 1)
                self._hot_streak = 0
        else:
            self._ok_streak += 1
            self._hot_streak = 0
            if self._ok_streak >= self.deescalate_after and \
                    self.stats.level > LEVEL_FULL:
                self._set_level(self.stats.level - 1)
                self._ok_streak = 0

    def _set_level(self, level: int) -> None:
        prev = self.stats.level
        if level == prev:
            return
        self.stats.level = level
        if level > prev:
            self.stats.escalations += 1
        else:
            self.stats.deescalations += 1
        # DEGRADED engages the engine's approximate serve
        # when members were designated; the engine keeps ledgering
        # approx_rows in the same shared stats object
        if self.degrade_members and hasattr(self.engine, "degrade"):
            want = self.degrade_members if level >= LEVEL_DEGRADED else ()
            if tuple(self.engine.degraded_members) != tuple(want):
                self.engine.degrade(want)

    # -- lookahead prefetch (BagPipe's warm-before-batch) ------------------

    def _peek_batch(self) -> list:
        return self._qpeek(self.engine.batch_size)

    def _maybe_prefetch(self) -> None:
        if not self.lookahead:
            return
        peek = self._peek_batch()
        if not peek:
            return
        rids = tuple(r.rid for r in peek)
        if getattr(self.engine, "plan_pipeline", False) and \
                rids != self._staged_rids:
            if self.engine.stage_plan([r.idx for r in peek]):
                self.stats.plans_staged += 1
                self._staged_rids = rids
        if self._counts is not None and self.warm_every > 0 and \
                self._n_dispatched > 0 and \
                self._n_dispatched % self.warm_every == 0:
            self._maybe_warm_cache(peek)

    def _maybe_warm_cache(self, peek: list) -> None:
        """Rebuild the hot cache from the observed access counts when the
        peeked (not-yet-batched) requests would mostly miss it — BagPipe's
        warm-before-batch, generalized to a full cache refresh."""
        cache = self.engine.cache
        if cache is None:
            return
        dev = cache.slot_of.device
        idx = torch.from_numpy(np.stack([r.idx for r in peek])).to(dev)
        mask = torch.from_numpy(np.stack([r.mask for r in peek])).to(dev)
        if HC.hit_rate(cache, idx, mask) >= self.warm_threshold:
            return
        new = HC.build(self.engine.params["tables"], self._counts,
                       cache.cache_rows)
        self.engine.adopt_cache(new)
        self.stats.cache_warms += 1
        self._staged_rids = ()           # staged plans were invalidated

    # -- shutdown ----------------------------------------------------------

    def drain(self) -> list:
        """Serve everything still queued (final partial batches included),
        harvest the pipeline tail, restore exact serving (ladder back to
        FULL), and return the completed requests.  After drain the
        conservation invariant is exact: admitted == served +
        degraded_served + shed."""
        completed: list = []
        while self._qlen():
            completed += self._dispatch(self.now())
        out = self.engine.drain()
        t_done = self.now()
        if out is not None:
            out = np.asarray(out).reshape(-1)
            off = 0
            while self._dispatched:
                n = len(self._dispatched[0][0])
                completed += self._complete(out[off:off + n], t_done)
                off += n
            if off != len(out):
                raise RuntimeError(
                    f"drain attribution drifted: {len(out)} CTRs for "
                    f"{off} dispatched requests")
        self._set_level(LEVEL_FULL)
        self.stats.queued = self._qlen()
        return completed
