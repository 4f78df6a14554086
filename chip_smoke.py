#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each on lines of its own:
  1. the card's identity and the float32 matmul settings (TF32 off);
  2. the CUDA kernels built from ``src/repro_torch/kernels/csrc`` with nvcc
     into ``build/kernels/``;
  3. every kernel held against its plain PyTorch version at full
     ``dlrm-kaggle`` width (rtol = atol = 1e-5: the summation order
     differs), two runs of it bit-identical, and its time beside the plain
     version's, a library call's and the least time the card could take;
  4. full-width ``dlrm-kaggle`` serving of 4 x 512 hetero requests through
     ``DLRMEngine(bound=2, microbatches=4)`` on a one-rank NCCL group: the
     CTRs finite, in (0, 1), bit-identical to ``bound=0`` and within
     1e-5 of the plain-PyTorch forward, and every kernel launched by it;
  5. one JSON line of kernel numbers, the card's name and power limit, and
     last ``{"ok": true, "device": {...}}``.
Without a CUDA device, or with any phase failing, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = {"rtol": 1e-5, "atol": 1e-5}
# H100 SXM data-sheet peaks (700 W): device memory and f32 outside the
# tensor cores, which is what these kernels use
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BATCH = 512
N_BATCHES = 4
PACKED_ROWS = 4096


def log(*parts) -> None:
    print(*parts, flush=True)


def card_identity() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# card cycles of busy-wait queued ahead of each timed call (~0.5 ms): the
# host enqueues the call while the card spins, so the event window holds
# device time only, not the host's launch dispatch
SPIN_CYCLES = 1_000_000


def time_ms(fn, *, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after warm-up;
    ``flush`` runs before each call, outside the timed window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernel(name, replaces, source, kernel_fn, plain_fn, library_fn,
                 *, n_bytes, flops, flush):
    """Hold one kernel against its plain version and time the three."""
    out = kernel_fn()
    again = kernel_fn()
    plain = plain_fn()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two kernel runs differ")
    torch.testing.assert_close(out, plain, **TOL)
    if library_fn is not None:
        torch.testing.assert_close(library_fn(), plain, **TOL)
    err = (out - plain).abs().max().item()
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": time_ms(kernel_fn, flush=flush),
           "plain_ms": time_ms(plain_fn, flush=flush),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": (time_ms(library_fn, flush=flush)
                          if library_fn is not None else None)}
    log(f"[kernel] {name}: max_abs_err={err:.3e} ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
    return row


def bag_bytes(gid, n_out, s) -> int:
    """Bytes a bag call must move: every distinct row it reads, its ids
    and weights, and its output."""
    rows = torch.unique(gid).numel()
    return rows * s * 4 + 2 * gid.numel() * 4 + n_out * s * 4


def kernel_phase(params, cfg, dev, flush):
    """Phase 3: each kernel against its plain version at the main path's
    shapes.  ``flush`` evicts L2 before each timed bag call (served bags
    read random rows of a 7 GB stack); the interaction is timed warm, as
    its input was written just before it on the serving path."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    bag_src = "src/repro_torch/kernels/csrc/embedding_bag.cu"
    dot_src = "src/repro_torch/kernels/csrc/dot_interaction.cu"
    eb_py = "src/repro/kernels/embedding_bag.py"
    tables = params["tables"][:cfg.n_tables]
    t, r, s = tables.shape
    flat = tables.reshape(t * r, s)
    rows = []
    for mode, replaces, label in (("uniform", f"{eb_py}:867", "hot1"),
                                  ("hetero", f"{eb_py}:619", "hot100")):
        b = make_batch(cfg, BATCH, mode=mode, seed=SEED)
        idx = torch.from_numpy(b.idx).to(dev)
        mask = torch.from_numpy(b.mask).to(dev)
        hot = idx.shape[2]
        gid = (torch.arange(t, device=dev)[None, :, None] * r
               + idx.long().clamp(0, r - 1)).reshape(BATCH * t, hot)
        w = mask.reshape(BATCH * t, hot)
        rows.append(check_kernel(
            f"embedding_bag_pool/stacked_{label}", replaces, bag_src,
            lambda: eb.embedding_bag_stacked(tables, idx, mask),
            lambda: ref.embedding_bag_stacked_ref(tables, idx, mask),
            lambda: F.embedding_bag(gid, flat, mode="sum",
                                    per_sample_weights=w)
            .reshape(BATCH, t, s),
            n_bytes=bag_bytes(gid, BATCH * t, s),
            flops=2 * gid.numel() * s, flush=flush))

    # the rows form on a packed set of (sample, table) rows of the hetero
    # batch, and the single-table form on the largest table
    pick = torch.from_numpy(np.random.default_rng(SEED).choice(
        BATCH * t, PACKED_ROWS, replace=False)).to(dev)
    tid = (pick % t).to(torch.int32)
    idx_r = idx.reshape(BATCH * t, hot)[pick]
    mask_r = mask.reshape(BATCH * t, hot)[pick]
    gid_r = tid.long()[:, None] * r + idx_r.long().clamp(0, r - 1)
    rows.append(check_kernel(
        "embedding_bag_pool/rows", f"{eb_py}:619", bag_src,
        lambda: eb.embedding_bag_rows(tables, tid, idx_r, mask_r),
        lambda: ref.embedding_bag_rows_ref(tables, tid, idx_r, mask_r),
        lambda: F.embedding_bag(gid_r, flat, mode="sum",
                                per_sample_weights=mask_r),
        n_bytes=bag_bytes(gid_r, PACKED_ROWS, s) + PACKED_ROWS * 4,
        flops=2 * gid_r.numel() * s, flush=flush))
    big = int(np.argmax(cfg.table_sizes))
    table = tables[big]
    idx_1 = idx[:, big].contiguous()
    mask_1 = mask[:, big].contiguous()
    gid_1 = idx_1.long().clamp(0, r - 1)
    rows.append(check_kernel(
        "embedding_bag_pool/single", f"{eb_py}:742", bag_src,
        lambda: eb.embedding_bag(table, idx_1, mask_1),
        lambda: ref.embedding_bag_ref(table, idx_1, mask_1),
        lambda: F.embedding_bag(gid_1, table, mode="sum",
                                per_sample_weights=mask_1),
        n_bytes=bag_bytes(gid_1, BATCH, s), flops=2 * gid_1.numel() * s,
        flush=flush))

    f = cfg.n_tables + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    z = torch.randn((BATCH, f, s), generator=gen, device=dev)
    ii, jj = torch.tril_indices(f, f, -1, device=dev)
    n_out = f * (f - 1) // 2
    rows.append(check_kernel(
        "dot_interaction", "src/repro/kernels/dot_interaction.py:52",
        dot_src, lambda: di.dot_interaction(z),
        lambda: ref.dot_interaction_ref(z),
        lambda: torch.bmm(z, z.transpose(1, 2))[:, ii, jj],
        n_bytes=(BATCH * f * s + BATCH * n_out) * 4,
        flops=2 * BATCH * n_out * s, flush=None))
    return rows


def serve(params, cfg, batch, bound, dev):
    from repro_torch.serving.engine import DLRMEngine

    eng = DLRMEngine(params, cfg, batch_size=BATCH, bound=bound,
                     microbatches=4, device=dev)
    outs = []
    for i in range(batch.dense.shape[0]):
        o = eng.submit(batch.dense[i], batch.idx[i], batch.mask[i])
        if o is not None:
            outs.append(o)
    tail = eng.drain()
    if tail is not None:
        outs.append(tail)
    return np.concatenate(outs), eng


def profile_flush(params, cfg, batch, dev):
    """One more served batch under torch.profiler: device time by kernel
    and the kernels' share of the flush's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import DLRMEngine

    eng = DLRMEngine(params, cfg, batch_size=BATCH, bound=2,
                     microbatches=4, device=dev)
    for i in range(BATCH - 1):
        eng.submit(batch.dense[i], batch.idx[i], batch.mask[i])
    last = BATCH - 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.submit(batch.dense[last], batch.idx[last], batch.mask[last])
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not by_name:
        log("[profile] the profiler saw no device activity: device time "
            "not measured")
        return
    log(f"[profile] one flush: wall {wall_us:.0f} us, device activity "
        f"{busy:.0f} us ({100 * busy / wall_us:.1f}% of wall)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   {us:9.1f} us  {name[:90]}")


def serve_phase(params, cfg, dev, backend, card):
    """Phase 4: serve full-width hetero traffic through the BLS engine on a
    one-rank process group; returns each kernel's launches on that run."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.models import dlrm

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh.init_model_group(backend, 1, 0, f"tcp://localhost:{port}")
    try:
        batch = make_batch(cfg, N_BATCHES * BATCH, mode="hetero", seed=SEED)
        # warm-up: the first collective sets up the communicator
        warm = make_batch(cfg, BATCH, mode="hetero", seed=SEED + 1)
        serve(params, cfg, warm, 2, dev)
        ops.reset_launches()
        ctr, eng = serve(params, cfg, batch, 2, dev)
        launches = {k: v.launches for k, v in ops.kernels().items()}
        ctr0, eng0 = serve(params, cfg, batch, 0, dev)
        profile_flush(params, cfg, warm, dev)
    finally:
        mesh.destroy_model_group()
    log(f"[serve] launches on the bound=2 run: {launches}")
    if ctr.shape != (N_BATCHES * BATCH,):
        raise AssertionError(f"CTR shape {ctr.shape}")
    if not (np.isfinite(ctr).all() and (ctr > 0).all() and (ctr < 1).all()):
        raise AssertionError("CTRs not finite or not in (0, 1)")
    if not np.array_equal(ctr, ctr0):
        raise AssertionError("bound=2 CTRs differ from bound=0 CTRs")
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not launch: {launches}")
    plain_cfg = cfg.replace(sparse_backend="ref")
    for j in range(N_BATCHES):
        sl = slice(j * BATCH, (j + 1) * BATCH)
        logits = dlrm.forward_local(
            params, plain_cfg, torch.from_numpy(batch.dense[sl]).to(dev),
            torch.from_numpy(batch.idx[sl]).to(dev),
            torch.from_numpy(batch.mask[sl]).to(dev))
        torch.testing.assert_close(
            torch.from_numpy(ctr[sl]), torch.sigmoid(logits).cpu(), **TOL)
    log(f"[serve] ctr bound=2 == bound=0 bit-identical; within 1e-5 of "
        f"the plain forward; range [{ctr.min():.6f}, {ctr.max():.6f}]")
    for k, e in ((2, eng), (0, eng0)):
        log(f"[serve] bound={k} ServeStats {json.dumps(e.stats.to_dict())} "
            f"flush p50_ms={e.monitor.percentile(0.5) * 1e3:.3f} "
            f"p99_ms={e.monitor.percentile(0.99) * 1e3:.3f} card={card!r}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.dlrm_kaggle import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.models.dlrm import init_dlrm

    t_start = time.perf_counter()
    card = card_identity()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"[card] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} kernels built in "
        f"{time.perf_counter() - t0:.2f} s into {_build.BUILD_DIR}")
    for src, text in logs.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"[build] {src}: {line.strip()}")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = init_dlrm(SEED, CONFIG, n_shards=1, device=dev)
    torch.cuda.synchronize()
    log(f"[init] dlrm-kaggle tables {tuple(params['tables'].shape)} in "
        f"{time.perf_counter() - t0:.2f} s")

    l2 = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        rows = kernel_phase(params, CONFIG, dev, l2.zero_)
        del l2
        launches = serve_phase(params, CONFIG, dev, "nccl", card)
    for row in rows:
        key = row["name"].split("/")[0]
        row["launches"] = launches[key]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
