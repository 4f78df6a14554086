"""Discrete-event simulator of synchronous vs bounded-lag-synchronous DLRM
inference — the apparatus that reproduces the paper's Figs. 1, 4, 7 and 8
(the port's own copy of ``repro/core/schedule_sim.py``, numpy only; the
fault plans of ``runtime/faults.py`` predict absorption with it).

Why a simulator: the paper's gains come from masking *per-process jitter*
(OS noise, skewed table access, NIC contention on an 8-node ARM cluster).
A single CPU container cannot exhibit cross-host jitter and a lock-step TPU
SPMD program cannot either — but multi-host pods do (input pipeline,
preemption, ICI retries).  The simulator implements both schedules exactly as
the paper defines them, so the headline claims are validated quantitatively:

  * Fig. 7 (random delays):  BLS with k>=1 recovers ~the mean injected delay,
    on BOTH backends (the paper: 0.017 s -> 0.012 s = minus the 5 ms mean).
  * Fig. 7 (hetero wire):    only the BLS backend benefits (Table I: it alone
    overlaps collective-with-collective across iterations; the MPI progress
    thread also pays a per-outstanding-request enqueue cost, paper §III-A).
  * Fig. 8 (balanced):       BLS == sync; no benefit, no harm.
  * Fig. 4 semantics:        no two processes are ever > k iterations apart.
  * a consistent straggler cannot be masked by any bound (paper §IV).

Execution model per process (paper Listing 2): every iteration runs
  [delay] -> apply_emb -> issue alltoallv (offloaded) -> bottom MLP
  -> if more than ``bound`` requests outstanding: wait on the TAIL request
     (iteration i-k) -> interaction + top MLP of i-k
with a drain loop at end-of-stream.  Data for iteration j is available at a
consumer once every peer has *sent* its part:
  BLS backend: puts offload immediately and wire concurrently (one-sided).
  MPI backend: the progress thread serialises wire transfers across
  outstanding collectives and charges an enqueue overhead per outstanding
  request.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Workload:
    """Per-(process, iteration) stage durations in seconds."""
    t_emb: np.ndarray        # (P, N) apply_emb time
    t_bot: np.ndarray        # (P, N) bottom-MLP time
    t_top: np.ndarray        # (P, N) interaction + top-MLP time
    t_wire: np.ndarray       # (P, N) wire time of this process's sends
    delay: np.ndarray        # (P, N) injected random delay (paper Setting 2)

    @property
    def n_procs(self) -> int:
        return self.t_emb.shape[0]

    @property
    def n_iters(self) -> int:
        return self.t_emb.shape[1]


def make_workload(n_procs: int, n_iters: int, *,
                  t_emb: float = 2.0e-3, t_bot: float = 1.0e-3,
                  t_top: float = 1.0e-3, t_wire: float = 1.0e-3,
                  delay_max: float = 0.0,
                  hetero_wire: float = 0.0,
                  straggler: Optional[int] = None,
                  straggler_slowdown: float = 2.0,
                  seed: int = 0) -> Workload:
    """Synthetic workloads mirroring the paper's §V-E settings.

    delay_max   > 0 -> Setting 2: uniform random delay U[0, delay_max].
    hetero_wire > 0 -> Setting 1: wire time scaled by U[1/(1+h), 1+h]
                       (variable per-iteration message sizes).
    straggler       -> a *consistent* straggler process (paper's negative
                       case: cannot be masked).
    """
    rng = np.random.default_rng(seed)
    shape = (n_procs, n_iters)
    w = Workload(
        t_emb=np.full(shape, t_emb),
        t_bot=np.full(shape, t_bot),
        t_top=np.full(shape, t_top),
        t_wire=np.full(shape, t_wire),
        delay=rng.uniform(0.0, delay_max, shape) if delay_max else
        np.zeros(shape),
    )
    if hetero_wire:
        w.t_wire = w.t_wire * rng.uniform(1.0 / (1.0 + hetero_wire),
                                          1.0 + hetero_wire, shape)
    if straggler is not None:
        w.t_emb[straggler] *= straggler_slowdown
        w.t_bot[straggler] *= straggler_slowdown
        w.t_top[straggler] *= straggler_slowdown
    return w


def make_skew_workload(n_procs: int, n_iters: int, member_load, *,
                       t_emb: float = 2.0e-3, t_bot: float = 1.0e-3,
                       t_top: float = 1.0e-3, t_wire: float = 1.0e-3,
                       delay_max: float = 0.0, seed: int = 0) -> Workload:
    """A workload whose per-member embedding and wire stage times scale
    with ``member_load`` (relative to its mean) — the cost model behind
    skew-aware placement (DESIGN.md §11): a member owning hot tables
    pools more rows (t_emb) and ships more bytes (t_wire), while the
    MLP stages are load-independent.  A uniform ``member_load``
    reproduces :func:`make_workload` exactly, so placement predictions
    and the paper-figure workloads share one simulator."""
    ml = np.asarray(member_load, np.float64)
    if ml.shape != (n_procs,):
        raise ValueError(
            f"member_load must be ({n_procs},), got {ml.shape}")
    w = make_workload(n_procs, n_iters, t_emb=t_emb, t_bot=t_bot,
                      t_top=t_top, t_wire=t_wire, delay_max=delay_max,
                      seed=seed)
    mean = ml.mean()
    rel = ml / mean if mean > 0 else np.ones(n_procs)
    w.t_emb = w.t_emb * rel[:, None]
    w.t_wire = w.t_wire * rel[:, None]
    return w


@dataclasses.dataclass
class SimResult:
    makespan: float
    consume: np.ndarray          # (P, N) completion time of iteration i at p
    mean_latency: float          # paper's per-batch latency metric
    throughput: float            # paper's batches/s metric (sum over procs)
    max_lag: int                 # max iteration distance between 2 processes
    # cross-member stall: seconds each process spent waiting on exchange
    # data (ready > own clock at the tail wait) — the quantity a bound of
    # k exists to drive to zero, and what runtime/faults.predict_absorption
    # compares against the fault-free schedule to call a plan "masked"
    blocked: Optional[np.ndarray] = None     # (P,) stall seconds
    blocked_s: float = 0.0                   # sum over processes

    def summary(self) -> dict:
        return {"makespan": self.makespan, "mean_latency": self.mean_latency,
                "throughput": self.throughput, "max_lag": self.max_lag,
                "blocked_s": self.blocked_s}


MPI_ENQUEUE_OVERHEAD = 2.0e-4  # s per outstanding request (paper §III-A (a))


def simulate(w: Workload, bound: int, *, backend: str = "bls",
             mpi_enqueue_overhead: float = MPI_ENQUEUE_OVERHEAD) -> SimResult:
    """Simulate one run.  backend in {'bls', 'mpi'}."""
    if backend not in ("bls", "mpi"):
        raise ValueError(backend)
    p_, n_ = w.n_procs, w.n_iters
    k = max(int(bound), 0)

    clock = np.zeros(p_)
    start = np.full((p_, n_), np.inf)      # iteration start times
    send_done = np.full((p_, n_), np.inf)  # all puts of (p, i) on the wire
    consume = np.full((p_, n_), np.inf)    # top-MLP completion of (p, i)
    last_wire_free = np.zeros(p_)          # MPI progress-thread serialisation
    blocked = np.zeros(p_)                 # stall at the tail wait, per proc

    def data_ready(j: int) -> float:
        return float(np.max(send_done[:, j]))

    for i in range(n_):
        for p in range(p_):
            start[p, i] = clock[p]
            clock[p] += w.delay[p, i] + w.t_emb[p, i]
            # issue the exchange for iteration i
            if backend == "mpi":
                outstanding = min(i, k) + 1
                clock[p] += mpi_enqueue_overhead * outstanding
                wire_start = max(clock[p], last_wire_free[p])
                send_done[p, i] = wire_start + w.t_wire[p, i]
                last_wire_free[p] = send_done[p, i]
            else:
                send_done[p, i] = clock[p] + w.t_wire[p, i]
            # bottom MLP overlaps the exchange (all modes, paper Listing 1/2)
            clock[p] += w.t_bot[p, i]
        j = i - k
        if j >= 0:
            ready = data_ready(j)
            for p in range(p_):
                blocked[p] += max(ready - clock[p], 0.0)
                clock[p] = max(clock[p], ready) + w.t_top[p, j]
                consume[p, j] = clock[p]

    for j in range(max(n_ - k, 0), n_):  # drain loop
        ready = data_ready(j)
        for p in range(p_):
            blocked[p] += max(ready - clock[p], 0.0)
            clock[p] = max(clock[p], ready) + w.t_top[p, j]
            consume[p, j] = clock[p]

    # max lag in *loop indices* (paper Fig. 4: any two processes are at most
    # k iterations apart).  A process consuming iteration j is executing loop
    # index j + k, so compare each q's consumption loop index against how far
    # p's loop starts have run at that same wall-clock instant.
    max_lag = 0
    for q in range(p_):
        for p in range(p_):
            if p == q:
                continue
            # for each j: count of loop starts of p at time consume[q, j]
            ahead = np.searchsorted(start[p], consume[q]) - 1 \
                - (np.arange(n_) + k)
            max_lag = max(max_lag, int(ahead.max()))

    makespan = float(clock.max())
    per_proc = consume[:, -1] / n_
    return SimResult(
        makespan=makespan, consume=consume,
        mean_latency=float(np.mean(per_proc)),
        throughput=float(np.sum(n_ / consume[:, -1])),
        max_lag=max_lag,
        blocked=blocked, blocked_s=float(blocked.sum()),
    )


def sweep_bounds(w: Workload, bounds, backend: str = "bls"):
    return {k: simulate(w, k, backend=backend).summary() for k in bounds}
