#!/usr/bin/env python3
"""A/B timing of the DLRM kernels' design variants on one GPU.

Run from the repository root:

    python3 src/repro_torch/tools/ab_dlrm_kernels.py [--parent DIR]

It builds ``src/repro_torch/kernels/csrc/embedding_bag.cu`` as it ships and
once per variant in ``BAG_VARIANTS`` (a copy of the source under
``build/ab/`` with some of its text replaced: a constant, or a code path
the shipped kernel does not have), ``l2_read_probe.cu`` beside this file,
and, with ``--parent``, the bag and interaction sources of another
checkout of the repository (an earlier design).  Every build is one
``nvcc`` into ``build/ab/``, all started together.  Each library's entry
point is called through ctypes on the same inputs:

- the bags of full-width ``dlrm-kaggle`` (7.33 GB of seeded tables) at the
  served microbatch (the first 128 samples of the hetero batch: 3,328 bags,
  hot 100), at 512 samples (13,312 bags, hot 100) and at 512 samples hot 1,
  and the rows form (4,096 packed rows) and single-table form (the largest
  table) on the 512-sample hetero batch;
- the interaction at (128, 27, 64) and (512, 27, 64), beside an empty
  kernel on the same grid (the launch-and-ramp floor);
- probes of what bounds the bag (``[ab-probe]``): the L2 and device-memory
  read rates of a streaming read, and the shipped bag at the served shape
  with its ids remapped so that every slot is a distinct row (all from
  device memory) or every id is taken mod 16 (all rows on chip).

Every variant is held against the plain PyTorch version at rtol = atol =
1e-5, and two of its runs must be bit-identical.  Times are medians of CUDA
event timings (``chip_smoke.time_ms``: the card is kept busy ahead of each
call), taken in turns — every variant, then every variant in reverse order
— so drift shows as a difference between a variant's two readings.  The
interaction is timed warm; the bags after L2 was evicted, once by writing a
256 MB buffer (``write_flush``, as ``chip_smoke.py`` does) and once by
reading one (``read_flush``: L2 is left clean, so the timed call pays no
write-back of dirty lines).  One ``[ab]`` line per (shape, flush, variant)
reading; exits non-zero if a variant fails its check.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.dot_interaction import DOT  # noqa: E402
from repro_torch.kernels.embedding_bag import POOL  # noqa: E402

# the C entry points' argument types (the parent's are the same)
BAG_ARGS, DOT_ARGS = POOL.argtypes, DOT.argtypes

CSRC = Path("src/repro_torch/kernels/csrc")

# the shipped bag kernel's batch loop: the next batch's rows are issued
# before this batch is added
PIPELINED = """\
      // the next batch's rows load while this batch is added
      fetch<V, U>(xa, wa, mine, 0, n_mine, a.groups, base, a.s, c);
      for (int j0 = 0; j0 < n_mine; j0 += U) {
        VT xb[U];
        float wb[U];
        fetch<V, U>(xb, wb, mine, j0 + U, n_mine, a.groups, base, a.s, c);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u < n_mine) add_scaled(acc, wa[u], xa[u]);
          xa[u] = xb[u];
          wa[u] = wb[u];
        }
      }
"""
UNPIPELINED = """\
      for (int j0 = 0; j0 < n_mine; j0 += U) {
        fetch<V, U>(xa, wa, mine, j0, n_mine, a.groups, base, a.s, c);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (j0 + u < n_mine) add_scaled(acc, wa[u], xa[u]);
      }
"""
# a table-major block first reduces the max id over its slots, then copies
# rows [0, max clamped id] of its table into 32 KB of shared memory when
# they fit and reads them there (every row load becomes a generic load)
STAGE = """\
  if (a.table_major) {
    float* stage = reinterpret_cast<float*>(
        (reinterpret_cast<uintptr_t>(slots + per_block * id_ld) + 15) &
        ~(uintptr_t)15);
    __shared__ int warp_max[kThreads / 32];
    int m = 0;
    for (int64_t e = threadIdx.x; e < count * a.hot; e += kThreads) {
      const int64_t n = first + (e / a.hot) * stride;
      m = max(m, __ldg(a.idx + n * a.hot + e % a.hot));
    }
    for (int off = 16; off; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    m = 0;
    for (int i = 0; i < kThreads / 32; ++i) m = max(m, warp_max[i]);
    const int64_t n_rows = min(max((int64_t)m, (int64_t)0), a.rows - 1) + 1;
    if (n_rows * a.s * 4 <= 32768) {
      for (int64_t e = threadIdx.x; e < n_rows * a.s / V; e += kThreads)
        reinterpret_cast<VT*>(stage)[e] =
            __ldg(reinterpret_cast<const VT*>(base) + e);
      base = stage;
    }
  }
  const int2* mine = slots + slot * id_ld + k;
"""
# the bag kernel's variants: (old text, new text) replacements of the
# shipped source (128 threads, 8 rows a batch, next batch issued before the
# adds, 4 resident blocks' worth of registers, one group a bag up to 128
# slots, table-major, no row staging)
BAG_VARIANTS = {
    "new": [],
    "threads256_min_blocks2": [
        ("kThreads = 128;", "kThreads = 256;"),
        ("kMinBlocks = 4;", "kMinBlocks = 2;")],
    "min_blocks3": [("kMinBlocks = 4;", "kMinBlocks = 3;")],
    "unroll4": [("kUnroll = 8;", "kUnroll = 4;")],
    "no_pipeline": [(PIPELINED, UNPIPELINED)],
    "split_slots64": [("kGroupSlots = 128;", "kGroupSlots = 64;")],
    "split_slots32": [("kGroupSlots = 128;", "kGroupSlots = 32;")],
    "bag_order": [("a->table_major = a->tid == nullptr && a->n_tables > 1;",
                   "a->table_major = 0;")],
    "stage_smem": [
        ("  const int2* mine = slots + slot * id_ld + k;\n", STAGE),
        ("x[u] = __ldg(reinterpret_cast<const VT*>(p));",
         "x[u] = *reinterpret_cast<const VT*>(p);"),
        ("(int64_t)per_block * (chunk + 1) * 8);",
         "(int64_t)per_block * (chunk + 1) * 8 +\n"
         "                     (a->table_major ? 32768 + 16 : 0));")],
}


def variant_source(name: str, edits: list) -> Path:
    """The shipped bag source with ``edits`` applied, written under
    build/ab/; each old text must occur exactly once."""
    text = (ROOT / CSRC / "embedding_bag.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old[:50]!r} occurs "
                               f"{text.count(old)} times in the source")
        text = text.replace(old, new)
    out = ROOT / "build" / "ab" / f"bag_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def build_all(jobs: dict) -> dict:
    """jobs: name -> source path; one nvcc each, in parallel.
    Returns name -> loaded library."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cc = _build.nvcc()
    procs = {}
    for name, src in jobs.items():
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [cc, *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        for kname, arg, used, stack, spill in cs.ptxas_report(log):
            cs.log(f"[ab-build] {name} {kname}{f'<{arg}>' if arg else ''}: "
                   f"{used}; stack {stack}, spill stores {spill}")
        libs[name] = ctypes.CDLL(str(so))
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def entry(lib, symbol, argtypes, name=""):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def call(*args):
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} {symbol}: CUDA error {err}")
    return call


def in_turns(fns: dict, **kw) -> dict:
    """Each callable timed twice, in order then in reverse order."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            times[name].append(cs.time_ms(fns[name], **kw))
    return times


def bag_phase(libs, dev) -> None:
    from repro_torch.configs.dlrm_kaggle import CONFIG
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ref
    from repro_torch.models.dlrm import init_dlrm

    params = init_dlrm(cs.SEED, CONFIG, n_shards=1, device=dev)
    tables = params["tables"][:CONFIG.n_tables]
    t, r, s = tables.shape
    flat = tables.reshape(t * r, s)
    l2 = torch.ones(64 << 20, dtype=torch.float32, device=dev)
    flushes = {"write_flush": l2.zero_, "read_flush": lambda: l2.sum()}
    stream = torch.cuda.current_stream().cuda_stream
    # (label, table, n_tables, ids, weights, tid, plain, global row ids):
    # the stacked form at three shapes, then the rows form on 4,096 packed
    # (sample, table) rows and the single-table form on the largest table,
    # both of the 512-sample hetero batch, as chip_smoke.py times them
    cases = []
    for label, mode, b in (("served_mb128_hot100", "hetero", 128),
                           ("b512_hot100", "hetero", 512),
                           ("b512_hot1", "uniform", 512)):
        batch = make_batch(CONFIG, cs.BATCH, mode=mode, seed=cs.SEED)
        idx = torch.from_numpy(batch.idx[:b]).to(dev).contiguous()
        mask = torch.from_numpy(batch.mask[:b]).to(dev).contiguous()
        hot = idx.shape[2]
        gid = (torch.arange(t, device=dev)[None, :, None] * r
               + idx.long().clamp(0, r - 1)).reshape(b * t, hot)
        cases.append((label, flat, t, idx.reshape(b * t, hot),
                      mask.reshape(b * t, hot), None,
                      ref.embedding_bag_stacked_ref(tables, idx, mask)
                      .reshape(b * t, s), gid))
        if label == "b512_hot100":
            hetero_ids, hetero_w = idx.reshape(b * t, hot), \
                mask.reshape(b * t, hot)
    hot = hetero_ids.shape[1]
    pick = torch.from_numpy(np.random.default_rng(cs.SEED).choice(
        cs.BATCH * t, cs.PACKED_ROWS, replace=False)).to(dev)
    tid = (pick % t).to(torch.int32)
    ids_r, w_r = hetero_ids[pick].contiguous(), hetero_w[pick].contiguous()
    cases.append(("rows_4096_hot100", flat, t, ids_r, w_r, tid,
                  ref.embedding_bag_rows_ref(tables, tid, ids_r, w_r),
                  tid.long()[:, None] * r + ids_r.long().clamp(0, r - 1)))
    big = int(np.argmax(CONFIG.table_sizes))
    ids_1 = hetero_ids.reshape(cs.BATCH, t, hot)[:, big].contiguous()
    w_1 = hetero_w.reshape(cs.BATCH, t, hot)[:, big].contiguous()
    cases.append(("single_b512_hot100", tables[big], 1, ids_1, w_1, None,
                  ref.embedding_bag_ref(tables[big], ids_1, w_1),
                  ids_1.long().clamp(0, r - 1)))
    for label, table, n_tables, ids, w, tid, plain, gid in cases:
        n, hot = ids.shape
        n_bytes = cs.bag_bytes(gid, n, s)
        fns = {}
        for name, lib in libs.items():
            if "bag" not in name:
                continue
            call = entry(lib, "embedding_bag_pool_f32", BAG_ARGS, name)
            out = torch.empty((n, s), device=dev)

            def run(call=call, out=out, table=table, n_tables=n_tables,
                    ids=ids, w=w, tid=tid, n=n, hot=hot):
                call(table.data_ptr(), ids.data_ptr(), w.data_ptr(),
                     None if tid is None else tid.data_ptr(),
                     out.data_ptr(), n, hot, s, r, n_tables, stream)
                return out
            first = run().clone()
            again = run().clone()
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                raise AssertionError(f"{name} {label}: two runs differ")
            torch.testing.assert_close(first, plain, **cs.TOL)
            fns[name] = run
        for kind, flush in flushes.items():
            for name, ts in in_turns(fns, flush=flush).items():
                cs.log(f"[ab] bag {label} {kind} {name}: ms {ts[0]:.4f} "
                       f"{ts[1]:.4f} (median {statistics.median(ts):.4f}); "
                       f"bound {n_bytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms; "
                       f"all-slot bytes {gid.numel() * s * 4 / 1e6:.1f} MB")
    served = make_batch(CONFIG, cs.BATCH, mode="hetero", seed=cs.SEED)
    probe_phase(libs, tables,
                torch.from_numpy(served.idx[:cs.SERVED_MB]).to(dev),
                torch.from_numpy(served.mask[:cs.SERVED_MB]).to(dev), l2,
                dev)
    del params, tables, flat, l2
    torch.cuda.empty_cache()


def l2_rates(lib, dev, l2) -> None:
    """The card's L2 read rate (a 16 MB buffer read 32 times through L2
    alone) and its device-memory streaming read rate (1 GB once, L2
    evicted first by reading ``l2``, so no dirty line is written back in
    the timed window), from ``l2_read_probe.cu``."""
    probe = entry(lib, "l2_read_probe",
                  [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], "probe")
    sink = torch.zeros(1, device=dev)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 16
    stream = torch.cuda.current_stream().cuda_stream
    for label, n_bytes, passes in (("L2 read rate (16 MB x 32)", 16 << 20,
                                    32),
                                   ("device-memory read rate (1 GB x 1)",
                                    1 << 30, 1)):
        buf = torch.zeros(n_bytes // 4, device=dev)
        ms = cs.time_ms(lambda buf=buf, n_bytes=n_bytes, passes=passes:
                        probe(buf.data_ptr(), n_bytes // 16, passes,
                              sink.data_ptr(), blocks, stream),
                        flush=None if passes > 1 else lambda: l2.sum())
        cs.log(f"[ab-probe] {label}: {n_bytes * passes / ms / 1e9:.3f} TB/s "
               f"({ms:.4f} ms)")
        del buf


def probe_phase(libs, tables, idx, mask, l2, dev) -> None:
    """What bounds the bag on this card: the L2 and device-memory read
    rates of a plain streaming read (``l2_rates``), and the shipped kernel
    at the served shape, timed after the write flush, on two remappings of
    its ids: every slot a distinct random row of a 1.1M-row table (all from
    device memory), and every id taken mod 16 (all rows cached on chip)."""
    l2_rates(libs["probe"], dev, l2)
    lib = libs["bag_new"]
    stream = torch.cuda.current_stream().cuda_stream
    label, b = "served_mb128_hot100", idx.shape[0]
    t, r, s = tables.shape
    flat = tables.reshape(t * r, s)
    n, hot = b * t, idx.shape[2]
    call = entry(lib, "embedding_bag_pool_f32", BAG_ARGS, "bag_new")
    out = torch.empty((n, s), device=dev)
    rng = torch.Generator(device=dev)
    rng.manual_seed(cs.SEED)
    remaps = {
        "distinct_rows": torch.randperm(1_000_000, generator=rng,
                                        device=dev)[:n * hot]
        .to(torch.int32).reshape(n, hot),
        "ids_mod16": (idx.reshape(n, hot) % 16).contiguous(),
    }
    w = mask.reshape(n, hot)
    for kind, ids in remaps.items():
        ms = cs.time_ms(lambda: call(flat.data_ptr(), ids.data_ptr(),
                                     w.data_ptr(), None, out.data_ptr(), n,
                                     hot, s, r, t, stream),
                        flush=l2.zero_)
        cs.log(f"[ab-probe] bag {label} {kind}: {ms:.4f} ms, slot rows "
               f"{n * hot * s * 4 / ms / 1e9:.3f} TB/s")


def dot_phase(libs, dev) -> None:
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for b in (128, 512):
        f, s = 27, 64
        z = torch.randn((b, f, s), generator=gen, device=dev)
        plain = ref.dot_interaction_ref(z)
        n_out = f * (f - 1) // 2
        fns = {}
        for name, lib in libs.items():
            if "dot" not in name:
                continue
            call = entry(lib, "dot_interaction_f32_launch", DOT_ARGS, name)
            out = torch.empty((b, n_out), device=dev)

            def run(call=call, out=out):
                call(z.data_ptr(), out.data_ptr(), b, f, s, stream)
                return out
            first = run().clone()
            again = run().clone()
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                raise AssertionError(f"{name} b{b}: two runs differ")
            torch.testing.assert_close(first, plain, **cs.TOL)
            fns[name] = run
        empty = entry(libs["dot_new"], "dot_interaction_empty",
                      [ctypes.c_int, ctypes.c_void_p], "dot_new")
        fns["empty_kernel"] = lambda: empty(b, stream)
        for name, ts in in_turns(fns).items():
            cs.log(f"[ab] dot b{b}_f27_s64 {name}: ms {ts[0]:.4f} {ts[1]:.4f} "
                   f"(median {statistics.median(ts):.4f}); bound "
                   f"{(b * f * s + b * n_out) * 4 / cs.HBM_BYTES_PER_S * 1e3:.4f}"
                   f" ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_dlrm_kernels: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose bag and interaction "
                    "sources are timed beside this one's")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"[card] {cs.card_identity()} | torch {torch.__version__}")
    jobs = {f"bag_{k}": variant_source(k, v) for k, v in BAG_VARIANTS.items()}
    jobs["dot_new"] = ROOT / CSRC / "dot_interaction.cu"
    jobs["probe"] = HERE / "l2_read_probe.cu"
    if args.parent is not None:
        jobs["bag_parent"] = args.parent / CSRC / "embedding_bag.cu"
        jobs["dot_parent"] = args.parent / CSRC / "dot_interaction.cu"
    t0 = time.perf_counter()
    libs = build_all(jobs)
    cs.log(f"[ab-build] {len(libs)} libraries in "
           f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    with torch.no_grad():
        dot_phase(libs, dev)
        bag_phase(libs, dev)
    cs.log("[ab] done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
