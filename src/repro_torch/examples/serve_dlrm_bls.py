"""End-to-end example: BLS-enabled DLRM inference serving (the port of
``examples/serve_dlrm_bls.py``).

Streams batched CTR requests through the serving engine with the bounded-lag
pipeline, measures latency and throughput, lets the straggler monitor
recommend a bound, and holds the BLS engine's CTRs against a synchronous
one's.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_dlrm_bls
      [--batches 20] [--batch-size 256] [--bound 4] [--microbatches 8]
      [--wire-dtype float32|bfloat16|int8] [--cache-rows N]
      [--exchange dense|ragged|auto] [--ragged-cap N] [--row-block N]
      [--pool-mode auto|vector|scalar]
      [--exchange-pipeline mono|ring|auto]
      [--frontend [--open-requests N] [--overload X] [--burstiness B]
       [--slo-ms MS] [--max-queue N] [--admission slo|queue|none]
       [--updates N] [--k-fresh K]]
      [--rebalance]
      [--device cuda|cpu]

It serves the ``dlrm-kaggle`` smoke configuration on one member (a
one-rank process group: NCCL on the card, gloo on the CPU).

With --frontend the example serves an open-loop bursty request stream at
--overload times the engine's measured capacity, in real time, through the
serving frontend's SLO-aware admission, deadline shedding and
backpressure; it reports the request-level ledger and asserts the exact
accounting invariant.

With --updates N (frontend mode) a live delta stream of N rows a version
rides the exchange while the frontend admits: the rows are applied
atomically between flushes under the --k-fresh bounded-staleness gate, and
the run reports the freshness ledger and asserts versions_behind <=
k_fresh at every flush.

With --rebalance the example serves a drifting hot-set stream through a
static engine and one with the online rebalance policy, and prints the
placement ledger; the CTRs must agree bit for bit.  On one member no
placement can level anything, so the policy never plans a move.

--device defaults to the card; ``--device cpu`` runs the plain PyTorch
versions of the kernels.
"""
from __future__ import annotations

import argparse
import socket
import time

import numpy as np

from repro_torch.configs import base as cb
from repro_torch.data import synthetic as S
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import dlrm as D
from repro_torch.serving.engine import DLRMEngine

# wire-codec round-trip error bounds on the sigmoid CTR outputs
# (float32 allows the cache path's f32 hits + misses summation order)
WIRE_TOL = {"float32": 1e-4, "bfloat16": 3e-2, "int8": 6e-2}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--bound", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--wire-dtype", default="float32",
                    choices=sorted(WIRE_TOL))
    ap.add_argument("--cache-rows", type=int, default=0,
                    help="hot-row cache rows per table (0 = off)")
    ap.add_argument("--exchange", default="auto",
                    choices=("dense", "ragged", "auto"),
                    help="pooled-exchange collective")
    ap.add_argument("--ragged-cap", type=int, default=0,
                    help="rows per destination bucket (0 = autotuned)")
    ap.add_argument("--row-block", type=int, default=0,
                    help="embedding-bag row streaming: 0 = auto, > 0 = "
                         "forced streamed block height")
    ap.add_argument("--pool-mode", default="auto",
                    choices=("auto", "vector", "scalar"),
                    help="embedding-bag pooling loop of the reference; "
                         "the port's kernel has one")
    ap.add_argument("--exchange-pipeline", default="auto",
                    choices=("mono", "ring", "auto"),
                    help="fused-wire collective: one all_to_all ('mono') "
                         "vs P-1 point-to-point rounds ('ring'); 'auto' = "
                         "ring at P >= 4")
    ap.add_argument("--frontend", action="store_true",
                    help="serve an open-loop bursty request stream through "
                         "the serving frontend instead of closed-loop "
                         "batch replay")
    ap.add_argument("--open-requests", type=int, default=512,
                    help="--frontend: number of open-loop requests")
    ap.add_argument("--overload", type=float, default=1.5,
                    help="--frontend: offered load as a multiple of the "
                         "engine's measured capacity (>1 overloads)")
    ap.add_argument("--burstiness", type=float, default=0.3,
                    help="--frontend: burst-opening probability in [0, 1)")
    ap.add_argument("--slo-ms", type=float, default=100.0,
                    help="--frontend: per-request deadline budget")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="--frontend: queue bound (0 = 4 batches)")
    ap.add_argument("--admission", default="slo",
                    choices=("slo", "queue", "none"),
                    help="--frontend: admission policy ('none' = the "
                         "accept-everything baseline)")
    ap.add_argument("--updates", type=int, default=0,
                    help="--frontend: stream live embedding-row deltas at "
                         "N rows per version over the exchange (0 = off)")
    ap.add_argument("--k-fresh", type=int, default=2,
                    help="--frontend --updates: bounded-staleness gate, "
                         "the most versions any member may lag")
    ap.add_argument("--rebalance", action="store_true",
                    help="skew-aware placement demo: a drifting hot-set "
                         "stream through a static and a rebalancing engine")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = cb.get_arch("dlrm-kaggle").smoke()
    # one member: the model group has one rank, so the exchange, the codec
    # and the cache path run (degenerately, nothing crosses a card)
    params = D.init_dlrm(0, cfg, n_shards=1, device=args.device)
    t_pad = D.padded_tables(cfg, 1)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if params["tables"].device.type == "cuda" else "gloo"
    mesh_mod.init_model_group(backend, 1, 0, f"tcp://localhost:{port}")
    try:
        if args.rebalance:
            return run_rebalance(args, cfg, params, t_pad)
        if args.frontend:
            return run_frontend(args, cfg, params, t_pad)
        return run_closed_loop(args, cfg, params, t_pad)
    finally:
        mesh_mod.destroy_model_group()


def run_closed_loop(args, cfg, params, t_pad):
    """Closed-loop batch replay through a synchronous and a BLS engine."""
    # the paper's protocol: make the dataset before measuring
    data = [S.make_batch(cfg, args.batch_size, mode="hetero", seed=7,
                         step=i, t_pad=t_pad) for i in range(args.batches)]
    dev = params["tables"].device
    engines = {
        "sync(k=0)": DLRMEngine(params, cfg, batch_size=args.batch_size,
                                bound=0, microbatches=1,
                                row_block=args.row_block,
                                pool_mode=args.pool_mode,
                                exchange_pipeline=args.exchange_pipeline,
                                device=dev),
        f"bls(k={args.bound})": DLRMEngine(
            params, cfg, batch_size=args.batch_size, bound=args.bound,
            microbatches=args.microbatches, wire_dtype=args.wire_dtype,
            exchange=args.exchange, ragged_cap=args.ragged_cap,
            exchange_pipeline=args.exchange_pipeline,
            row_block=args.row_block, pool_mode=args.pool_mode, device=dev),
    }
    if args.cache_rows > 0:
        # calibrate the BLS engine's hot cache on the first batch
        from repro_torch.serving import hot_cache as HC
        calib = data[0]
        name = f"bls(k={args.bound})"
        cache = engines[name].calibrate_cache(calib.idx, calib.mask,
                                              args.cache_rows)
        hr = HC.hit_rate(cache, calib.idx, calib.mask)
        print(f"hot cache: {args.cache_rows} rows/table, "
              f"calibration hit rate {hr:.2f}")
    outputs = {}
    for name, eng in engines.items():
        outs = []
        for b in data:
            for i in range(args.batch_size):
                r = eng.submit(b.dense[i], b.idx[i], b.mask[i])
                if r is not None:
                    outs.append(r)
        tail = eng.flush()
        if tail is not None:
            outs.append(tail)
        outputs[name] = np.concatenate(outs)
        p50 = eng.monitor.percentile(0.5) * 1e3
        p99 = eng.monitor.percentile(0.99) * 1e3
        print(f"{name:12s}: {eng.stats.requests} reqs, "
              f"{eng.stats.throughput_rps:,.0f} req/s, "
              f"batch p50={p50:.1f} ms p99={p99:.1f} ms")

    names = list(outputs)
    diff = float(np.max(np.abs(outputs[names[0]] - outputs[names[1]])))
    tol = WIRE_TOL[args.wire_dtype]
    print(f"max |CTR(sync) - CTR(bls)| = {diff:.2e} (tol {tol:.0e}; the "
          f"bound changes the schedule, the wire codec adds bounded noise)")
    assert diff < tol
    eng = engines[names[1]]
    rec = eng.recommend_bound()
    print(f"straggler monitor: {rec.reason} "
          f"(ring slot = {eng.slot_bytes()} B)")
    cap_rec = eng.retune_cap()
    if cap_rec is not None:
        print(f"cap autotuner: {cap_rec.reason} "
              f"({eng.stats.retunes} retunes, cap in service = "
              f"{eng.ragged_cap or 'dense-equivalent'})")


def run_frontend(args, cfg, params, t_pad):
    """Open-loop bursty serving through the serving frontend."""
    from repro_torch.serving.frontend import ServingFrontend

    fm = None
    if args.updates > 0:
        from repro_torch.runtime.freshness import FreshnessManager
        fm = FreshnessManager(
            S.delta_stream(cfg, rows_per_version=args.updates, seed=7),
            k_fresh=args.k_fresh)
        print(f"freshness: streaming {args.updates} rows/version onto "
              f"the wire, k_fresh={args.k_fresh}")
    eng = DLRMEngine(params, cfg, batch_size=args.batch_size,
                     bound=args.bound, microbatches=args.microbatches,
                     wire_dtype=args.wire_dtype, exchange=args.exchange,
                     ragged_cap=args.ragged_cap,
                     exchange_pipeline=args.exchange_pipeline,
                     row_block=args.row_block, pool_mode=args.pool_mode,
                     freshness=fm, device=params["tables"].device)
    # warm up, then measure the steady flush time the offered load and the
    # admission predictor are calibrated against
    warm = S.make_batch(cfg, args.batch_size, mode="hetero", seed=7,
                        step=0, t_pad=t_pad)
    flush_s = []
    for _ in range(max(2, args.batches)):
        t0 = time.perf_counter()
        for i in range(args.batch_size):
            eng.submit(warm.dense[i], warm.idx[i], warm.mask[i])
        eng.drain()
        flush_s.append(time.perf_counter() - t0)
    flush_s = min(flush_s)
    capacity_rps = args.batch_size / flush_s
    rate = args.overload * capacity_rps
    print(f"capacity ~{capacity_rps:,.0f} req/s (flush "
          f"{flush_s * 1e3:.1f} ms); offering {args.overload:.1f}x "
          f"= {rate:,.0f} req/s, burstiness {args.burstiness}")

    reqs = S.request_stream(cfg, args.open_requests, rate_rps=rate,
                            burstiness=args.burstiness, mode="hetero",
                            t_pad=t_pad, seed=7)
    fe = ServingFrontend(
        eng, slo_s=args.slo_ms / 1e3,
        max_queue=args.max_queue or 4 * args.batch_size,
        admission=args.admission, init_flush_s=flush_s)
    completed, nxt = [], 0
    t0 = time.perf_counter()
    while nxt < len(reqs):
        # open-loop drive: everything that has arrived by now enters
        # before the next scheduling round, backdated to its arrival; a
        # flush never throttles the offered load
        now = time.perf_counter()
        while nxt < len(reqs) and t0 + reqs[nxt].t_arrive <= now:
            r = reqs[nxt]
            fe.try_submit(r.dense, r.idx, r.mask, now=t0 + r.t_arrive)
            nxt += 1
        completed += fe.pump()
    completed += fe.drain()

    st = fe.stats
    e2e, qd = st.e2e, st.queue_delay
    print(f"frontend[{args.admission}]: offered {st.offered}, admitted "
          f"{st.admitted}, rejected {st.rejected} (retried {st.retried}), "
          f"shed {st.shed}, served {st.served} (+{st.degraded_served} "
          f"degraded), late {st.served_late}")
    print(f"latency: queue-delay p50={qd.percentile(.5) * 1e3:.1f} "
          f"p99={qd.percentile(.99) * 1e3:.1f} ms, e2e "
          f"p50={e2e.percentile(.5) * 1e3:.1f} "
          f"p99={e2e.percentile(.99) * 1e3:.1f} ms (SLO {args.slo_ms} ms)")
    ok = (st.accounted and st.queued == 0 and st.inflight == 0
          and len(completed) == st.completed)
    print(f"accounting: {'exact' if ok else 'DRIFTED'} "
          f"(admitted {st.admitted} == served {st.served} + degraded "
          f"{st.degraded_served} + shed {st.shed})")
    assert ok, "conservation invariant violated"
    if fm is not None:
        behind = max(fm.behind_trace, default=0)
        print(f"freshness: applied {fm.rows_applied} rows over "
              f"{fm.applies} atomic windows while serving; staleness "
              f"max {behind} <= k_fresh {fm.k_fresh}, "
              f"{eng.stats.rows_stale_served} stale rows served, "
              f"{fm.delta_rejects} rejects, {fm.rollbacks} rollbacks")
        assert all(v <= fm.k_fresh for v in fm.behind_trace), \
            "bounded-staleness invariant violated"



def run_rebalance(args, cfg, params, t_pad):
    """Skew-aware placement demo: serve a drifting hot-set stream through
    two engines, one static and one with the online rebalance policy, and
    show the reshard ledger with bit-exact outputs."""
    eng = DLRMEngine(dict(params), cfg, batch_size=args.batch_size,
                     bound=args.bound, microbatches=args.microbatches,
                     device=args.device, rebalance=True,
                     rebalance_threshold=1.05, rebalance_patience=2,
                     mig_slice_cap=8)
    ref = DLRMEngine(dict(params), cfg, batch_size=args.batch_size,
                     bound=args.bound, microbatches=args.microbatches,
                     device=args.device)
    outs, refs = [], []
    for s in range(args.batches):
        b = S.make_batch(cfg, args.batch_size, mode="drift", t_pad=t_pad,
                         seed=7, step=s)
        for i in range(args.batch_size):
            o = eng.submit(b.dense[i], b.idx[i], b.mask[i])
            ro = ref.submit(b.dense[i], b.idx[i], b.mask[i])
            if o is not None:
                outs.append(o)
            if ro is not None:
                refs.append(ro)
    st = eng.stats
    print(f"placement: reshards={st.reshards} aborts={st.reshard_aborts} "
          f"migrated_rows={st.migrated_rows} "
          f"imbalance={st.imbalance_ratio:.3f} "
          f"layout_version={eng.layout_version}")
    ewma = [] if eng._member_ewma is None else list(eng._member_ewma)
    print(f"placement: member pooled rows (EWMA) = "
          f"{[round(float(x), 1) for x in ewma]}")
    if eng.reshard is not None:
        print(f"placement: reshard in flight: {eng.reshard.summary()}")
    a, b_ = np.concatenate(outs), np.concatenate(refs)
    exact = a.shape == b_.shape and bool((a == b_).all())
    print(f"placement: served CTRs bit-exact vs static placement: "
          f"{exact} ({st.requests} requests, zero lost)")
    assert exact, "rebalanced serving diverged from the static engine"
    assert len(outs) * args.batch_size == st.requests


if __name__ == "__main__":
    main()
