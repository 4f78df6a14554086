#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each on lines of its own:
  1. the card's identity and the float32 matmul settings (TF32 off);
  2. the CUDA kernels built from ``src/repro_torch/kernels/csrc`` with nvcc
     into ``build/kernels/`` (one nvcc per source, all at once), and one
     line per kernel of registers and stack/spill bytes from ptxas, with
     the dynamic shared memory of the wgmma flash body (and its key tile
     and K/V stages) and of the two WKV passes; the wgmma body must not
     spill;
  3. the DLRM kernels held against their plain PyTorch versions at full
     ``dlrm-kaggle`` width (rtol = atol = 1e-5: the summation order
     differs), two runs of each bit-identical and each bit-identical to
     the CPU model of its summation order, at the served microbatch (128
     samples a launch: ``stacked_hot100_mb128``, ``dot_interaction/mb128``)
     and at 512 samples a call; each one's time beside the plain version's,
     a library call's and the least time the card could take, each bag's
     all-slot read rate and the interaction's launch floor (an empty kernel
     on its grid);
  4. the bag and interaction kernels on their edge cases (ids and table ids
     out of range, all-masked bags, a NaN row under weight 0, every vector
     width and lane count, bags split over groups, F 2 and 27, S 4, 6, 64,
     small-integer inputs bit-exact);
  5. full-width ``dlrm-kaggle`` serving of 4 x 512 hetero requests through
     ``DLRMEngine(bound=2, microbatches=4)`` on a one-rank NCCL group: the
     CTRs finite, in (0, 1), bit-identical to ``bound=0`` and within
     1e-5 of the plain-PyTorch forward, and both DLRM kernels launched at
     the served microbatch shape once per microbatch;
 5b. on the same group, a 4096-row hot cache calibrated on powerlaw_hetero
     traffic and 8 x 512 powerlaw_hetero requests served (1) by an
     ``exchange='auto'`` engine retuning every 2 flushes, which must move
     onto the ragged exchange, (2) ragged at the cap it settled on, on the
     float32, bf16 and int8 wires, mono and ring, (3) f32 ragged at bound
     0: CTRs finite in (0, 1), ring == mono and bound 2 == bound 0 bit for
     bit, f32 within 1e-5 of the plain forward, bf16 and int8 logits within
     5e-2 and 1e-1 of it, zero drops, the engine's live_max equal to the
     host's count, and the rows kernel, the pooled hits and the
     interaction launched once per microbatch on every ragged run; the
     exchanged bytes per codec, ServeStats and flush p50/p99 per run, one
     profiled ragged flush, and the rows kernel held and timed at the
     served shape (the packed residual of one microbatch at the cap);
 5c. on the same group, at full width with 4 x 512 hetero requests over 4
     microbatches: ``build_forward_plans`` gives plans (the whole stack
     streams, the reference's geometry picks 'sort'), their build time on
     a side stream; ``forward_distributed(plan=...)`` bit-identical to
     inline planning at bound 0 / 1 microbatch and bound 2 / 4, a plan of
     another ``row_block`` refused; an inline and a ``plan_pipeline``
     engine serving the same requests to bit-identical CTRs (the pipeline
     one flush late, ``drain`` returning the last batch, a ``stage_plan``
     adopted) with each one's flush p50; then chaos at P = 1: a seeded
     jitter-and-spike ``FaultPlan`` through ``FaultInjector`` leaving the
     CTRs bit-identical with the injected delay equal to the plan's, and a
     bound-0 engine under a deadline below every flush
     (``on_deadline='degrade'``) counting the breaches and raising its
     bound (one member flags no straggler), CTRs bit-identical;
     ``predict_absorption`` at bounds 0 and 2; on every engine run the bag
     and interaction kernels launched once per microbatch at the served
     shape and at no other;
 5d. on the same group, the serving frontend and online embedding
     freshness at full width: (1) the engine's capacity (the fastest of 4
     warm flushes of 512 hetero requests), then 8192 hetero requests
     offered open loop in real time at 1.5x that capacity (burstiness
     0.3) to a ``ServingFrontend`` (SLO 100 ms, queue bound 2048, SLO
     admission): the accounting exact, every served CTR finite in (0, 1)
     and within 1e-5 of the plain forward; the ledger, queue delay and e2e
     p50/p99 and the frontend's host time a request printed; (2) 1024
     hetero requests on a virtual clock through admission 'none': the
     first 32 flushed alone bit-identical to their batched CTRs, and a
     ``plan_pipeline`` engine under a lookahead frontend bit-identical with
     a staged plan adopted; (3) a ``FreshnessManager`` (16 powerlaw
     versions of 32 rows, k_fresh 2, slices of 8, 4 rows of member 0
     corrupted at flush 2) on a copy of the stack with phase 5b's cache,
     512 powerlaw_hetero requests a flush until committed (at most 32):
     versions_behind <= k_fresh throughout, every row applied, the
     corrupted ones rejected and applied again, no rollback, ServeStats
     equal to the manager's counters, the stack bit-identical to
     ``oracle_tables`` and the cache's rows to the oracle's, a fresh batch
     bit-identical to a new engine on the oracle stack, the same
     collective calls a flush with and without deltas, flush 4's stale
     bags equal to a host recount; the apply window's device time (from
     the profiler trace), its wall time on the stream and its host time,
     flush p50/p99 with and without freshness, ``slot_bytes`` with and
     without the delta field, and the host cost of
     ``count_stale_served`` printed.  Every engine run launches the bag
     and the interaction once per microbatch at the served shape and at no
     other (the bag twice with the cache: pooled hits and residual);
  5e. on the same group, skew-aware placement, online resharding and
     integrity scrubbing at full width: (a) phase 5's 4 x 512 hetero
     requests through ``forward_distributed`` on the stack in the reversed
     slot order with ``table_inv``: CTRs bit-identical to phase 5's; (b) a
     hand-built ``MigrationPlan`` rotating the slots of the 8 smallest
     tables (206 rows), started with ``start_reshard`` on a
     ``DLRMEngine(rebalance=True, mig_slice_cap=8)``, 12 flushes of 512
     drift requests beside a static engine: every CTR bit-identical,
     ``reshards`` 1, ``migrated_rows`` 206, ``layout_version`` one higher,
     the same collective calls a flush with the ``xmig`` rider as without;
     the cutover's wall and device time (profiler trace) against its byte
     bound and the card's peak memory; (c) ``DLRMEngine(scrub_budget=
     65536, scrub_block_rows=32, quarantine_cap=64)`` with phase 5b's
     cache on a copy of the stack, flips in real rows of tables 0, 2 and
     3 and in a cached copy, and one corrupted segment, 8 flushes of 512
     powerlaw_hetero requests beside a clean engine: each flip detected
     within its predicted lag, quarantined and repaired from the mirror
     through ``xrep``, ``quarantined_served`` equal to a host recount
     (``np.isin``), the repaired rows equal to the mirror and a full sweep
     equal to the boot ledger, the flushes after the repair bit-identical
     to the clean engine's, ``wire_rejects`` one a microbatch of the
     corrupted flush, the same collective calls as without scrub; the
     ledger's boot time, the mirror copy, the sweep's and the audit's
     device times against their bounds, the ``wcs`` stamp and verify, and
     flush p50 with and without scrub;
  6. the flash-attention kernel held against its plain version in bf16
     (rtol 1e-2, atol 5e-3, and the relative Frobenius error under 5e-3:
     the plain version computes in f32 on the same bf16 inputs) at the
     served gemma2-9b local and global layers, at qwen3-14b's heads and at
     qwen2-moe-a2.7b's (H = Kh = 16, hd 128) (B 2, S 4608, q drawn at 4x unit scale so each softmax is peaked and
     the softcap bends the largest scores), two runs bit-identical, timed
     as in 3, the qwen3 and qwen2-moe rows beside
     scaled_dot_product_attention; the plain
     version without the softcap, and without the window, must fail the
     same check;
  7. gemma2-9b at full width in f32, depth cut to 4 layers: prefill of
     2 x 4608 tokens through the kernel held against the plain attention,
     and one decode step from each prefill's cache (rtol = atol = 1e-4);
  8. full gemma2-9b (42 layers, bf16) served by ``LMEngine``: first the
     kernel held against its plain version, as in 6, on the q, k and v the
     served model gives its first local and first global layer for the
     prompts; then 2 prompts of 4608 tokens, 16 greedy tokens, twice;
     tokens in range and identical across the runs, the prefill's logits
     finite, the flash kernel launched 42 times per prefill (21 local,
     21 global); prefill and decode times;
  9. after freeing gemma2-9b, the RWKV-6 WKV kernel held against its plain
     (chunked) version in f32 at the served rwkv6-1.6b prefill (B 1,
     S 32768, H 32, K = V = 64) and at B 8 x S 4096, with a nonzero
     state0, plus a long-memory and an extreme (logw = -50) decay: out and
     the final state within rtol 1e-4, atol 2e-3 and a relative Frobenius
     error of 1e-5; two runs bit-identical; the plain version without the
     u bonus, and with state0 ignored, must fail that check; timed as in 3,
     and its state pass and output pass timed alone, with the bytes of the
     chunk-start-state scratch;
 10. full-width rwkv6-1.6b in f32 on 4096 tokens, first at 4 layers: the
     forward's logits and every layer's state through the kernel held
     against the plain WKV (rtol = atol = 1e-4), and 128 tokens decoded one
     at a time held against the forward's logits (atol 2e-3, the
     reference's own); then at all 24 layers, through which f32 rounding
     differences grow layer by layer in the random model: the kernel
     path's logits and states within a relative Frobenius error of 1e-3 of
     the plain path's, and its logits within a quarter of the plain
     forward's own distance from decode;
 11. full rwkv6-1.6b in bf16: ``make_prefill_step`` on a 32768-token
     prompt (finite logits, the WKV kernel launched 24 times), a profile of
     one prefill, and ``LMEngine`` on 2 prompts of 64 tokens, 16 greedy
     tokens, twice, identical;
 12. after freeing rwkv6-1.6b, full-width qwen2-moe-a2.7b in f32 at 2 of
     its 24 layers: prefill of 2 x 4608 tokens through the flash kernel
     against the plain attention and one decode step from each cache
     (rtol = atol = 1e-4); layer 0's MoE FFN on the prompts' hidden states
     through the local ``moe_gather`` at capacity factor 8 (no slot
     dropped) against ``moe_ref_dense`` (1e-4); the slots the config's
     capacity factor 1.25 drops, layer by layer (counted here from
     ``route`` and ``dispatch_indices``);
 13. full qwen2-moe-a2.7b (24 layers, bf16, 64 padded routed experts,
     ~30.3 GB) served by ``LMEngine``: the flash kernel held against its
     plain version on the served layer-0 q, k and v (as in 8); then on a
     one-rank NCCL group the served layer-0 FFN input (9,216 tokens)
     through ``moe_gather(group)`` and ``moe_a2a(group)`` against the
     local gather (rtol = atol = 1e-2), the collective calls of each
     forward counted (1 all_reduce; 3 all_to_all_single), and the a2a
     stages over 4 microbatches under ``bls_pipeline`` at bounds 0, 1, 2
     bit-identical to ``reference_loop``; 3 prefills of 2 x 4608 tokens,
     24 flash launches each; one prefill and one decode step profiled
     (``[moe-profile]``: flash, expert GEMMs, dispatch, the rest, the
     card's active share); 2 prompts, 16 greedy tokens, twice, identical;
     prefill and decode times beside their bounds;
 14. one JSON line of kernel numbers, the card's name and power limit, and
     last ``{"ok": true, "device": {...}}``.
Without a CUDA device, or with any phase failing, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import re
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
# H100 SXM data-sheet peaks (700 W): device memory, f32 outside the tensor
# cores (the DLRM kernels) and bf16 on the tensor cores (flash attention)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
BATCH = 512
N_BATCHES = 4
# DLRMEngine(batch_size=512, microbatches=4) pools and interacts 128 samples
# a launch: the served shape of both DLRM kernels
SERVED_MB = BATCH // 4
# the kernel rows at that shape: each must count one launch per microbatch
SERVED_ROWS = ("embedding_bag_pool/stacked_hot100_mb128",
               "dot_interaction/mb128")
PACKED_ROWS = 4096
# phase 5b: a 4096-row hot cache per table and 8 served batches of 512
CACHE_ROWS = 4096
RAGGED_BATCHES = 8
CODECS = ("float32", "bfloat16", "int8")
# the reference's logit tolerances of the lossy wires
# (tests/test_ragged_exchange.py)
RAGGED_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "int8": 1e-1}
# the kernels of the DLRM serving path (flash attention is the LM path's)
DLRM_KERNELS = ("embedding_bag_pool", "dot_interaction")
# the LM phases: 2 prompts of 4608 tokens (512 past gemma2's 4096 window),
# a cache of 4864 positions, 16 greedy tokens
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_NEW = 2, 4608, 4864, 16
# the bf16 kernel feeds the probabilities to the tensor cores in bf16, as
# flash attention does, so each p_j carries up to 2^-8 of relative rounding
# that the plain version (f32 throughout) does not: a few 1e-3 on outputs
# of order 1, beside the 2^-8 relative rounding of the output itself.  The
# relative Frobenius error of the whole output is held as well.
FLASH_TOL = {"rtol": 1e-2, "atol": 5e-3}
FLASH_REL = 5e-3
# q drawn at 4x unit scale: each row's softmax is peaked (typical |out|
# ~0.25, not ~0.02 as over thousands of near-equal scores) and the softcap
# of 50 bends the largest scores by several percent
FLASH_Q_SCALE = 4.0
LM_TOL = {"rtol": 1e-4, "atol": 1e-4}
PARITY_LAYERS = 4
# the rwkv6 phases: the kernel at the served prefill (the prefill_32k
# cell's length, one sequence) and at the train_4k length over 8 sequences;
# f32 parity on 4096 tokens, 128 of them decoded; bf16 serving of one
# 32768-token prompt, then 2 x 64-token prompts and 16 greedy tokens
WKV_SHAPES = (("prefill_32k", 1, 32_768), ("b8_s4096", 8, 4_096))
WKV_HEADS = 32
# kernel and plain version both compute the chunked form in f32, in other
# orders and with other exponentials (ex2.approx in the kernel): on the CPU
# each f32 chunked form lies ~1.3e-6 (relative Frobenius) from a float64
# recurrence, up to 2e-4 in single elements of |out| up to ~90
WKV_TOL = {"rtol": 1e-4, "atol": 2e-3}
WKV_REL = 1e-5
RWKV_PARITY_LEN, RWKV_DECODE_CHECK = 4_096, 128
RWKV_DECODE_TOL = {"rtol": 0.0, "atol": 2e-3}
# the 1e-4 and decode checks hold on 4 layers (kernel vs plain 4.0e-5);
# at 24 layers the plain forward and decode differ by 0.145 (relative
# Frobenius 3.4e-3), kernel and plain forward by 4.5e-3 (9.3e-5)
RWKV_PARITY_LAYERS = 4
RWKV_DEPTH_REL = 1e-3
RWKV_DEPTH_SHARE = 0.25
RWKV_PROMPT = 32_768
RWKV_GEN_BATCH, RWKV_GEN_PROMPT, RWKV_NEW = 2, 64, 16
# the qwen2-moe phases: f32 parity at 2 of 24 layers on the LM prompts
# (layer 0's FFN at capacity factor 8, where nothing drops, against the
# dense oracle); the expert-parallel forms on the served model's layer-0
# FFN input in bf16, the BLS stages over 4 microbatches at bounds 0-2; the
# group forms compute the same slots' products in other buffers, held at
# a few bf16 steps (2^-8 relative); bf16 serving as the gemma2 phase
MOE_PARITY_LAYERS = 2
MOE_DENSE_CF = 8.0
MOE_EP_TOL = {"rtol": 1e-2, "atol": 1e-2}
MOE_MICROBATCHES = 4
MOE_BOUNDS = (0, 1, 2)


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


def errors(out, plain, rtol: float):
    """(max abs error, relative Frobenius error, the least atol that
    passes at ``rtol``) of ``out`` against ``plain``."""
    d = (out.float() - plain.float()).abs()
    p = plain.float()
    return (d.max().item(), (d.norm() / p.norm()).item(),
            (d - rtol * p.abs()).max().item())


def hold(name, out, plain, tol, rel=None):
    """Fail unless ``out`` is within ``tol`` of ``plain`` elementwise and,
    with ``rel``, its relative Frobenius error is at most ``rel``; returns
    :func:`errors`."""
    torch.testing.assert_close(out, plain, **tol)
    err = errors(out, plain, tol["rtol"])
    if rel is not None and err[1] > rel:
        raise AssertionError(f"{name}: relative Frobenius error {err[1]:.3e} "
                             f"> {rel}")
    return err


def check_kernel(name, replaces, source, kernel_fn, plain_fn, library_fn,
                 *, n_bytes, flops, flush, tol=TOL, rel=None,
                 peak_flops=F32_FLOPS):
    """Hold one kernel against its plain version and time the three."""
    out = kernel_fn()
    again = kernel_fn()
    plain = plain_fn()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two kernel runs differ")
    err, fro, need = hold(name, out, plain, tol, rel)
    if library_fn is not None:
        hold(f"{name} library", library_fn(), plain, tol, rel)
    log(f"[kernel] {name}: relative Frobenius error {fro:.3e}, least atol "
        f"passing at rtol {tol['rtol']}: {need:.3e}, median |plain| "
        f"{plain.float().abs().median().item():.3e}")
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak_flops
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


KERNEL_NAMES = re.compile(r"(flash_wgmma|flash_bf16|flash_f32|"
                          r"wkv_state_pass|wkv_output_pass|bag_pool_f32|"
                          r"dot_interaction_f32|"
                          r"dot_interaction_empty_kernel)((?:I?Li\d+E)*)")
# the wgmma flash body keeps its 128 (hd 256) accumulator registers only
# if nothing spills, and the bag keeps two batches of rows in flight in
# registers: their reports must show no stack and no spill stores
NO_SPILL = ("flash_wgmma", "bag_pool_f32")


def ptxas_report(text: str) -> list:
    """(kernel, template arguments ("4,8") or None, ptxas "Used ..." line,
    stack bytes, spill-store bytes) for every function in an nvcc -Xptxas
    -v log."""
    out, name, arg, spill = [], None, None, 0
    for line in text.splitlines():
        if "Function properties for" in line:
            m = KERNEL_NAMES.search(line.split("Function properties for")[1])
            name, arg = ((m.group(1), ",".join(re.findall(r"Li(\d+)E",
                                                         m.group(2)))
                          or None) if m else ("?", None))
            spill = 0
        elif "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif "Used" in line and name is not None:
            stack = re.search(r"(\d+) bytes (?:cumulative )?stack", line)
            out.append((name, arg, line.split("info    :")[-1].strip(),
                        int(stack.group(1)) if stack else 0, spill))
            name = None
    return out


def build_report(logs: dict) -> None:
    """One [build] line per kernel built: registers and stack/spill bytes
    from ptxas, the dynamic shared memory of the wgmma flash body and the
    two WKV passes, and the flash tiling; fails if the wgmma body or the
    bag spills."""
    from repro_torch.kernels import _build

    for src, text in logs.items():
        lib = _build.library(src)
        for name, arg, used, stack, spill in ptxas_report(text):
            extra = ""
            if name == "flash_wgmma":
                bk, st, sm = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int())
                lib.flash_attention_tiling(int(arg), ctypes.byref(bk),
                                           ctypes.byref(st), ctypes.byref(sm))
                extra = (f"; BK {bk.value} keys, {st.value} K/V stages, "
                         f"{sm.value} bytes of dynamic shared memory")
            elif name in ("wkv_state_pass", "wkv_output_pass"):
                extra = (f"; {lib.rwkv6_wkv_smem(1 if 'state' in name else 2)}"
                         f" bytes of dynamic shared memory")
            log(f"[build] {src} {name}{f'<{arg}>' if arg else ''}: {used}; "
                f"stack {stack} bytes, spill stores {spill} bytes{extra}")
            if name in NO_SPILL and (stack or spill):
                raise AssertionError(f"{name}<{arg}> spills: stack {stack} "
                                     f"bytes, spill stores {spill} bytes")


def bag_bytes(gid, n_out, s) -> int:
    """Bytes a bag call must move: every distinct row it reads, its ids
    and weights, and its output."""
    rows = torch.unique(gid).numel()
    return rows * s * 4 + 2 * gid.numel() * 4 + n_out * s * 4


def hold_bag_model(name, out, table_flat, ids, w, *, rows, n_tables,
                   tid=None, rows_form=False):
    """Fail unless the kernel's output equals, bit for bit, the CPU model
    of its summation order (``ref.embedding_bag_split_ref``) run on the
    card with the groups per bag the launcher planned; returns the plan."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    n, hot = ids.shape
    plan = eb.launch_plan(n, hot, table_flat.shape[1], n_tables,
                          rows_form=rows_form)
    model = ref.embedding_bag_split_ref(table_flat, ids, w, rows=rows,
                                        n_tables=n_tables, tid=tid,
                                        groups=plan["groups"])
    if not torch.equal(torch.isnan(out), torch.isnan(model)) or not \
            torch.equal(out.nan_to_num(), model.nan_to_num()):
        raise AssertionError(f"{name}: kernel differs from its summation "
                             f"model (plan {plan})")
    return plan


def hold_dot_model(name, out, z):
    """Fail unless the interaction equals, bit for bit, the CPU model of
    its summation order (``ref.dot_interaction_split_ref``, fused
    multiply-adds included) run on the card with the launcher's KP; returns
    KP."""
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import ref

    _, f, s = z.shape
    kp = di.kparts(f, s)
    if not torch.equal(out, ref.dot_interaction_split_ref(z, kp)):
        raise AssertionError(f"{name}: kernel differs from its summation "
                             f"model (KP {kp})")
    return kp


BAG_SRC = "src/repro_torch/kernels/csrc/embedding_bag.cu"
DOT_SRC = "src/repro_torch/kernels/csrc/dot_interaction.cu"
EB_PY = "src/repro/kernels/embedding_bag.py"


def bag_kernel_row(name, replaces, kernel_fn, plain_fn, library_fn, gid,
                   ids, w, n_out, *, table, rows, n_tables, flush, tid=None,
                   extra_bytes=0):
    """One bag row: the kernel held against its plain version and timed
    (:func:`check_kernel`), then bit for bit against its summation model
    with the launcher's plan; returns the row."""
    s = table.shape[1]
    row = check_kernel(name, replaces, BAG_SRC, kernel_fn, plain_fn,
                       library_fn,
                       n_bytes=bag_bytes(gid, n_out, s) + extra_bytes,
                       flops=2 * gid.numel() * s, flush=flush)
    plan = hold_bag_model(name, kernel_fn().reshape(n_out, s), table, ids,
                          w, rows=rows, n_tables=n_tables, tid=tid,
                          rows_form=tid is not None)
    slot_bytes = gid.numel() * s * 4
    log(f"[kernel] {name}: bit-identical to its summation model; plan "
        f"{plan}; all-slot bytes {slot_bytes / 1e6:.1f} MB, "
        f"{slot_bytes / row['ms'] / 1e9:.3f} TB/s all-slot rate")
    return row


def kernel_phase(params, cfg, dev, flush):
    """Phase 3: each kernel against its plain version at the main path's
    shapes: the served microbatch (128 samples, what ``DLRMEngine`` with 4
    microbatches of 512 launches) and, for continuity, 512 samples a call.
    ``flush`` evicts L2 before each timed bag call (served bags read random
    rows of a 7 GB stack); the interaction is timed warm, as its input was
    written just before it on the serving path.  Returns (row, launch key)
    pairs."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    tables = params["tables"][:cfg.n_tables]
    t, r, s = tables.shape
    flat = tables.reshape(t * r, s)
    rows = []

    def bag_row(name, replaces, kernel_fn, plain_fn, library_fn, gid, ids,
                w, n_out, key, *, tid=None, table=flat, n_tables=t,
                extra_bytes=0):
        rows.append((bag_kernel_row(
            name, replaces, kernel_fn, plain_fn, library_fn, gid, ids, w,
            n_out, table=table, rows=r, n_tables=n_tables, flush=flush,
            tid=tid, extra_bytes=extra_bytes), key))

    for mode, replaces, label, b in (
            ("uniform", f"{EB_PY}:867", "hot1", BATCH),
            ("hetero", f"{EB_PY}:619", "hot100", BATCH),
            ("hetero", f"{EB_PY}:619", "hot100_mb128", SERVED_MB)):
        batch = make_batch(cfg, BATCH, mode=mode, seed=SEED)
        idx = torch.from_numpy(batch.idx[:b]).to(dev).contiguous()
        mask = torch.from_numpy(batch.mask[:b]).to(dev).contiguous()
        hot = idx.shape[2]
        gid = (torch.arange(t, device=dev)[None, :, None] * r
               + idx.long().clamp(0, r - 1)).reshape(b * t, hot)
        w = mask.reshape(b * t, hot)
        bag_row(f"embedding_bag_pool/stacked_{label}", replaces,
                lambda idx=idx, mask=mask: eb.embedding_bag_stacked(
                    tables, idx, mask),
                lambda idx=idx, mask=mask: ref.embedding_bag_stacked_ref(
                    tables, idx, mask),
                lambda gid=gid, w=w, b=b: F.embedding_bag(
                    gid, flat, mode="sum", per_sample_weights=w)
                .reshape(b, t, s),
                gid, idx.reshape(b * t, hot), w, b * t,
                eb.launch_key(b * t, hot, s, t))
        if label == "hot100":
            hetero_idx, hetero_mask = idx, mask

    # the rows form on a packed set of (sample, table) rows of the hetero
    # batch, and the single-table form on the largest table
    idx, mask = hetero_idx, hetero_mask
    hot = idx.shape[2]
    pick = torch.from_numpy(np.random.default_rng(SEED).choice(
        BATCH * t, PACKED_ROWS, replace=False)).to(dev)
    tid = (pick % t).to(torch.int32)
    idx_r = idx.reshape(BATCH * t, hot)[pick]
    mask_r = mask.reshape(BATCH * t, hot)[pick]
    gid_r = tid.long()[:, None] * r + idx_r.long().clamp(0, r - 1)
    bag_row("embedding_bag_pool/rows", f"{EB_PY}:619",
            lambda: eb.embedding_bag_rows(tables, tid, idx_r, mask_r),
            lambda: ref.embedding_bag_rows_ref(tables, tid, idx_r, mask_r),
            lambda: F.embedding_bag(gid_r, flat, mode="sum",
                                    per_sample_weights=mask_r),
            gid_r, idx_r, mask_r, PACKED_ROWS,
            eb.launch_key(PACKED_ROWS, hot, s, t, True), tid=tid,
            extra_bytes=PACKED_ROWS * 4)
    big = int(np.argmax(cfg.table_sizes))
    table = tables[big]
    idx_1 = idx[:, big].contiguous()
    mask_1 = mask[:, big].contiguous()
    gid_1 = idx_1.long().clamp(0, r - 1)
    bag_row("embedding_bag_pool/single", f"{EB_PY}:742",
            lambda: eb.embedding_bag(table, idx_1, mask_1),
            lambda: ref.embedding_bag_ref(table, idx_1, mask_1),
            lambda: F.embedding_bag(gid_1, table, mode="sum",
                                    per_sample_weights=mask_1),
            gid_1, idx_1, mask_1, BATCH, eb.launch_key(BATCH, hot, s, 1),
            table=table, n_tables=1)

    f = cfg.n_tables + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ii, jj = torch.tril_indices(f, f, -1, device=dev)
    n_out = f * (f - 1) // 2
    empty = _build.library("dot_interaction.cu").dot_interaction_empty
    empty.argtypes, empty.restype = [ctypes.c_int, ctypes.c_void_p], \
        ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, b in (("dot_interaction", BATCH),
                    ("dot_interaction/mb128", SERVED_MB)):
        z = torch.randn((b, f, s), generator=gen, device=dev)
        row = check_kernel(
            name, "src/repro/kernels/dot_interaction.py:52", DOT_SRC,
            lambda z=z: di.dot_interaction(z),
            lambda z=z: ref.dot_interaction_ref(z),
            lambda z=z: torch.bmm(z, z.transpose(1, 2))[:, ii, jj],
            n_bytes=(b * f * s + b * n_out) * 4,
            flops=2 * b * n_out * s, flush=None)
        kp = hold_dot_model(name, di.dot_interaction(z), z)
        floor = time_ms(lambda b=b: empty(b, stream))
        log(f"[kernel] {name}: bit-identical to its summation model (KP "
            f"{kp}); an empty kernel on the same grid ({b} blocks) takes "
            f"{floor:.4f} ms in this harness (the launch-and-ramp floor); "
            f"the kernel {row['ms'] - floor:.4f} ms above it")
        rows.append((row, di.launch_key(b, f, s)))
    return rows


def dlrm_edge_phase(dev) -> None:
    """Phase 4: the bag and interaction kernels on their edge cases, on
    small seeded tables: ids -7 and R + 10^4 clamp; a table id out of range
    clamps in the rows form; an all-masked bag is exactly 0; a NaN row
    under weight 0 gives NaN in that bag, as the plain version does; hot in
    {1, 7, 100, 300} (300: split over groups, ids staged in two chunks at
    s 16) and s in {5, 6, 16, 64, 128} (every vector width, every lane
    count); stacked (table-major), rows and single-table forms.  Each is
    held against the plain version at 1e-5 and bit for bit against its
    summation model.  The interaction at F in {2, 27} x S in {4, 6, 64}:
    seeded normals at 1e-5 (and, at S 4 and 64, bit for bit against its
    summation model), small integers (exact dots) bit for bit."""
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t, r, b = 5, 300, 24
    cases = 0
    for s in (5, 6, 16, 64, 128):
        for hot in (1, 7, 100, 300):
            tables = torch.randn((t, r, s), generator=gen, device=dev)
            tables[2, 11] = float("nan")
            idx = torch.randint(0, r, (b, t, hot), generator=gen,
                                device=dev, dtype=torch.int32)
            mask = (torch.rand((b, t, hot), generator=gen, device=dev)
                    < 0.5).float()
            # row 11 of table 2 is NaN: only the one weight-0 slot names it
            idx[:, 2][idx[:, 2] == 11] = 12
            idx[:, :, 0] = -7
            if hot > 1:
                idx[:, :, 1] = r + 10_000
            mask[3] = 0.0                      # sample 3: every bag empty
            idx[5, 2, hot - 1], mask[5, 2, hot - 1] = 11, 0.0  # NaN row, w 0
            out = eb.embedding_bag_stacked(tables, idx, mask)
            plain = ref.embedding_bag_stacked_ref(tables, idx, mask)
            torch.cuda.synchronize()
            label = f"s {s} hot {hot}"
            torch.testing.assert_close(out, plain, equal_nan=True, **TOL)
            if not torch.equal(out[3], torch.zeros_like(out[3])):
                raise AssertionError(f"bag edge {label}: all-masked bags "
                                     "are not exactly 0")
            if not (torch.isnan(out[5, 2]).all()
                    and torch.isnan(plain[5, 2]).all()):
                raise AssertionError(f"bag edge {label}: NaN row under "
                                     "weight 0 did not give NaN")
            flat = tables.reshape(t * r, s)
            hold_bag_model(f"bag edge {label}", out.reshape(b * t, s), flat,
                           idx.reshape(b * t, hot), mask.reshape(b * t, hot),
                           rows=r, n_tables=t)
            tid = torch.randint(-2, t + 3, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
            tid[0], tid[1] = -1, t + 7
            ridx, rmask = idx[:, 0].contiguous(), mask[:, 1].contiguous()
            out_r = eb.embedding_bag_rows(tables, tid, ridx, rmask)
            torch.testing.assert_close(
                out_r, ref.embedding_bag_rows_ref(tables, tid, ridx, rmask),
                equal_nan=True, **TOL)
            hold_bag_model(f"bag edge rows {label}", out_r, flat, ridx,
                           rmask, rows=r, n_tables=t, tid=tid,
                           rows_form=True)
            out_1 = eb.embedding_bag(tables[1], ridx, rmask)
            torch.testing.assert_close(
                out_1, ref.embedding_bag_ref(tables[1], ridx, rmask),
                equal_nan=True, **TOL)
            hold_bag_model(f"bag edge single {label}", out_1, tables[1],
                           ridx, rmask, rows=r, n_tables=1)
            cases += 1
    log(f"[edge] bag: {cases} (s, hot) cases x stacked, rows and single "
        f"forms: ids -7 and R + 10^4 clamp, table ids -1 and T + 7 clamp, "
        f"all-masked bags exactly 0, a NaN row under weight 0 NaN as in the "
        f"plain version; within 1e-5 of the plain version and bit-identical "
        f"to the summation model")
    for f in (2, 27):
        for s in (4, 6, 64):
            z = torch.randn((SERVED_MB, f, s), generator=gen, device=dev)
            out = di.dot_interaction(z)
            torch.testing.assert_close(out, ref.dot_interaction_ref(z), **TOL)
            if s % 4 == 0:
                hold_dot_model(f"interaction edge F {f} S {s}", out, z)
            zi = torch.randint(-3, 4, (SERVED_MB, f, s), generator=gen,
                               device=dev).float()
            if not torch.equal(di.dot_interaction(zi),
                               ref.dot_interaction_ref(zi)):
                raise AssertionError(f"interaction F {f} S {s}: small "
                                     "integers not bit-exact")
    log("[edge] interaction: F in {2, 27} x S in {4, 6, 64} at B 128 within "
        "1e-5 of the plain version, bit-identical to the summation model at "
        "S 4 and 64, small-integer inputs bit-exact")


def serve(params, cfg, batch, bound, dev, *, calibrate=None,
          before_flush=None, **engine_kw):
    """Serve ``batch`` through a ``DLRMEngine`` at ``BATCH`` a flush.
    ``calibrate`` (idx, mask, cache rows) builds the engine's cache with
    ``calibrate_cache`` first; ``before_flush(engine, j)`` runs before batch
    j's last request.  Returns (CTRs, the engine)."""
    from repro_torch.serving.engine import DLRMEngine

    eng = DLRMEngine(params, cfg, batch_size=BATCH, bound=bound,
                     microbatches=4, device=dev, **engine_kw)
    if calibrate is not None:
        idx, mask, rows = calibrate
        eng.calibrate_cache(idx, mask, cache_rows=rows)
    outs = []
    for i in range(batch.dense.shape[0]):
        if before_flush is not None and i % BATCH == BATCH - 1:
            before_flush(eng, i // BATCH)
        o = eng.submit(batch.dense[i], batch.idx[i], batch.mask[i])
        if o is not None:
            outs.append(o)
    tail = eng.drain()
    if tail is not None:
        outs.append(tail)
    return np.concatenate(outs), eng


def profile_flush(params, cfg, batch, dev, tag="profile", **engine_kw):
    """One more served batch under torch.profiler: device time by kernel
    and the kernels' share of the flush's wall time."""
    from repro_torch.serving.engine import DLRMEngine

    profile_batch(DLRMEngine(params, cfg, batch_size=BATCH, bound=2,
                             microbatches=4, device=dev, **engine_kw),
                  batch, tag)


def profile_batch(eng, batch, tag):
    """Submit ``batch``'s first BATCH requests to ``eng``, the flushing
    one under torch.profiler; print the device time by kernel, the
    kernels' share of the flush's wall time and the host's operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(BATCH - 1):
        eng.submit(batch.dense[i], batch.idx[i], batch.mask[i])
    last = BATCH - 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.submit(batch.dense[last], batch.idx[last], batch.mask[last])
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    n_device = 0
    ranges = {e.name for e in prof.events()
              if e.device_type != DeviceType.CUDA and e.is_user_annotation}
    for e in prof.events():
        # a profiler range's span on the device is no device work
        if e.device_type == DeviceType.CUDA and e.name not in ranges:
            n_device += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not by_name:
        log(f"[{tag}] the profiler saw no device activity: device time "
            "not measured")
        return None
    log(f"[{tag}] one flush: wall {wall_us:.0f} us, device activity "
        f"{busy:.0f} us ({100 * busy / wall_us:.1f}% of wall)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[{tag}]   {us:9.1f} us  {name[:90]}")
    # the host side: how many device operations the flush issued, and the
    # host operations that took the most of its own time
    host = [a for a in prof.key_averages()
            if a.key.startswith("aten::") and a.self_cpu_time_total > 0]
    host.sort(key=lambda a: -a.self_cpu_time_total)
    log(f"[{tag}] host: {n_device} device operations (kernels and "
        f"copies); {sum(a.count for a in host)} aten calls taking "
        f"{sum(a.self_cpu_time_total for a in host):.0f} us of self CPU "
        f"time; most: " + ", ".join(
            f"{a.key} {a.self_cpu_time_total:.0f} us x{a.count}"
            for a in host[:8]))
    return prof


@contextlib.contextmanager
def model_group(backend):
    """A one-rank model group on a free localhost port for phases 5 and
    5b; destroyed on the way out."""
    from repro_torch.launch import mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh.init_model_group(backend, 1, 0, f"tcp://localhost:{port}")
    try:
        yield
    finally:
        mesh.destroy_model_group()


def log_serve(tag, label, eng, card):
    log(f"[{tag}] {label} ServeStats {json.dumps(eng.stats.to_dict())} "
        f"flush p50_ms={eng.monitor.percentile(0.5) * 1e3:.3f} "
        f"p99_ms={eng.monitor.percentile(0.99) * 1e3:.3f} card={card!r}")


def serve_phase(params, cfg, dev, card):
    """Phase 5: serve full-width hetero traffic through the BLS engine on
    the one-rank process group; returns each DLRM kernel's launches on that
    run by launch key (shape), and the bound-2 CTRs."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm

    batch = make_batch(cfg, N_BATCHES * BATCH, mode="hetero", seed=SEED)
    # warm-up: the first collective sets up the communicator
    warm = make_batch(cfg, BATCH, mode="hetero", seed=SEED + 1)
    serve(params, cfg, warm, 2, dev)
    ops.reset_launches()
    ctr, eng = serve(params, cfg, batch, 2, dev)
    launches = {k: ops.kernels()[k].launches for k in DLRM_KERNELS}
    by_key = {k: dict(ops.kernels()[k].by_key) for k in DLRM_KERNELS}
    ctr0, eng0 = serve(params, cfg, batch, 0, dev)
    profile_flush(params, cfg, warm, dev)
    log(f"[serve] launches on the bound=2 run: {launches}; by shape "
        f"{by_key}")
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
        log_serve("serve", f"bound={k}", e, card)
    return by_key, ctr


def host_live(slot_of, idx, mask):
    """(live (N, T) bags with >= 1 miss, the most live rows of any
    microbatch in each flush of ``BATCH``): the diagnostics' count at
    P = 1, taken with numpy from the cache's slot map."""
    t = idx.shape[1]
    slots = slot_of[np.arange(t)[None, :, None],
                    np.clip(idx, 0, slot_of.shape[1] - 1)]
    live = ((mask > 0) & (slots < 0)).any(-1)
    per_mb = live.reshape(-1, SERVED_MB * t).sum(1)
    return live, per_mb.reshape(-1, BATCH // SERVED_MB).max(1).tolist()


def check_ragged_run(label, ctr, eng, by_key, live_want, cap, t, hot, s):
    """Gates every ragged (or autotuned) run shares: CTRs finite in
    (0, 1), zero drops, the engine's live_max equal to the host's count
    flush by flush and, where ``cap`` is given, the rows kernel launched
    once per microbatch at (cap, hot) and nowhere else, and the pooled
    hits and the interaction once per microbatch."""
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import embedding_bag as eb

    if not (np.isfinite(ctr).all() and (ctr > 0).all() and (ctr < 1).all()):
        raise AssertionError(f"{label}: CTRs not finite or not in (0, 1)")
    if eng.cap_tuner.total_drops:
        raise AssertionError(f"{label}: {eng.cap_tuner.total_drops} drops")
    if list(eng.cap_tuner.live) != live_want:
        raise AssertionError(f"{label}: live_max {list(eng.cap_tuner.live)}"
                             f" != host {live_want}")
    if cap is None:
        return
    n_mb = RAGGED_BATCHES * (BATCH // SERVED_MB)
    rows_keys = {k: v for k, v in by_key["embedding_bag_pool"].items()
                 if k[4]}
    want = {eb.launch_key(cap, hot, s, t, rows_form=True): n_mb}
    if rows_keys != want:
        raise AssertionError(f"{label}: rows-form launches {rows_keys}, "
                             f"not {want}")
    hits = by_key["embedding_bag_pool"].get(
        eb.launch_key(SERVED_MB * t, hot, s, t), 0)
    inter = by_key["dot_interaction"].get(di.launch_key(SERVED_MB, t + 1, s),
                                          0)
    if (hits, inter) != (n_mb, n_mb):
        raise AssertionError(f"{label}: pooled-hit launches {hits}, "
                             f"interaction {inter}, not {n_mb} each")


def ragged_phase(params, cfg, dev, card):
    """Phase 5b: the hot-row cache and the ragged miss-residual exchange
    at full ``dlrm-kaggle`` width on the phase-5 group.  A 4096-row cache
    is calibrated on a powerlaw_hetero batch (seed 1); 8 x 512 requests
    (seed 0) are served at bound 2 over 4 microbatches (1) by an
    ``exchange='auto'`` engine retuning every 2 flushes (its cache from
    ``DLRMEngine.calibrate_cache``), which must move onto the ragged
    exchange, (2) at the cap it settles on, ragged, with that cache, on
    each wire codec, mono and ring, (3) f32 ragged at bound 0.  Gates:
    :func:`check_ragged_run` on each; ring == mono and bound 2 == bound 0
    bit for bit; f32 CTRs within 1e-5 of the plain forward, bf16 and int8
    logits within 5e-2 and 1e-1 of it.  Then the exchanged bytes, a
    profiled ragged flush and the rows kernel's row at the served shape
    (the packed residual of microbatch 0 at the settled cap).  Returns
    that row."""
    from repro_torch.core import alltoallv as a2a
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops, ref
    from repro_torch.models import dlrm
    from repro_torch.serving import hot_cache as hc

    tables = params["tables"][:cfg.n_tables]
    t, r, s = tables.shape
    hot = cfg.max_hot
    traffic = make_batch(cfg, RAGGED_BATCHES * BATCH,
                         mode="powerlaw_hetero", seed=SEED)
    warm = make_batch(cfg, BATCH, mode="powerlaw_hetero", seed=SEED + 1)
    dense_rows = SERVED_MB * t

    # run 1: 'auto' with a cache calibrated on the warm batch, retuning
    # every 2 flushes
    exchanges = []
    t_cal = []

    def note(eng, j):
        if j == 0:
            t_cal.append(time.perf_counter() - t0)
        exchanges.append(dlrm.resolve_exchange(
            eng.exchange, use_cache=True, cap=eng.ragged_cap,
            dense_rows=dense_rows))

    ops.reset_launches()
    t0 = time.perf_counter()
    ctr_auto, eng_auto = serve(params, cfg, traffic, 2, dev,
                               calibrate=(warm.idx, warm.mask, CACHE_ROWS),
                               exchange="auto", retune_every=2,
                               before_flush=note)
    auto_keys = {k: dict(ops.kernels()[k].by_key) for k in DLRM_KERNELS}
    cap, cache = eng_auto.ragged_cap, eng_auto.cache
    slot_host = cache.slot_of.cpu().numpy()
    live, live_want = host_live(slot_host, traffic.idx, traffic.mask)
    whole = sum(1 for n in cfg.table_sizes if n <= CACHE_ROWS)
    log(f"[ragged] cache of {CACHE_ROWS} rows a table calibrated on 512 "
        f"powerlaw_hetero requests (calibrate_cache; engine set-up and "
        f"calibration to the first flush {t_cal[0]:.2f} s): hot block "
        f"{cache.hot_rows.numel() * 4 / 1e6:.1f} MB, slot map "
        f"{cache.slot_of.numel() * 4 / 1e6:.1f} MB; {whole} of {t} tables "
        f"cached whole; on the served traffic hit rate "
        f"{hc.hit_rate(cache, traffic.idx, traffic.mask):.4f}, live share "
        f"{live.mean():.4f} of the (sample, table) bags; host live_max per "
        f"flush {live_want}")
    check_ragged_run("auto", ctr_auto, eng_auto, auto_keys, live_want, None,
                     t, hot, s)
    want_rows: dict = {}
    for use, c in exchanges:
        if use:
            key = eb.launch_key(c, hot, s, t, rows_form=True)
            want_rows[key] = want_rows.get(key, 0) + BATCH // SERVED_MB
    got_rows = {k: v for k, v in auto_keys["embedding_bag_pool"].items()
                if k[4]}
    ends_ragged = dlrm.resolve_exchange("auto", use_cache=True, cap=cap,
                                        dense_rows=dense_rows)[0]
    if eng_auto.stats.retunes < 1 or not ends_ragged or got_rows != \
            want_rows:
        raise AssertionError(
            f"auto: retunes {eng_auto.stats.retunes}, cap {cap} of "
            f"{dense_rows} dense rows, exchange per flush {exchanges}, "
            f"rows-form launches {got_rows} (expected {want_rows})")
    log(f"[ragged] auto: {eng_auto.stats.retunes} retunes, settled cap "
        f"{cap} of {dense_rows} dense rows a destination; exchange per "
        f"flush {[('ragged' if u else 'dense', c) for u, c in exchanges]}; "
        f"rows-form launches {got_rows}; tuner "
        f"{eng_auto.cap_tuner.recommend(dense_rows=dense_rows, peek=True)}")
    log_serve("ragged", "auto bound=2 float32 mono", eng_auto, card)

    # run 2: ragged at the settled cap, each codec, mono and ring; run 3:
    # f32 ragged at bound 0
    runs = {}
    for wire, pipe, bound in [(w, p, 2) for w in CODECS
                              for p in ("mono", "ring")] + \
            [("float32", "mono", 0)]:
        ops.reset_launches()
        ctr, eng = serve(params, cfg, traffic, bound, dev, cache=cache,
                         exchange="ragged", ragged_cap=cap, wire_dtype=wire,
                         exchange_pipeline=pipe)
        by_key = {k: dict(ops.kernels()[k].by_key) for k in DLRM_KERNELS}
        label = f"ragged bound={bound} {wire} {pipe}"
        check_ragged_run(label, ctr, eng, by_key, live_want, cap, t, hot,
                         s)
        log_serve("ragged", label, eng, card)
        runs[wire, pipe, bound] = (ctr, by_key)
    for wire in CODECS:
        if not np.array_equal(runs[wire, "ring", 2][0],
                              runs[wire, "mono", 2][0]):
            raise AssertionError(f"ragged {wire}: ring CTRs differ from mono")
    if not np.array_equal(runs["float32", "mono", 0][0],
                          runs["float32", "mono", 2][0]):
        raise AssertionError("ragged: bound=2 CTRs differ from bound=0")
    plain_cfg = cfg.replace(sparse_backend="ref")
    errs = {w: 0.0 for w in CODECS}
    for j in range(RAGGED_BATCHES):
        sl = slice(j * BATCH, (j + 1) * BATCH)
        logits = dlrm.forward_local(
            params, plain_cfg, torch.from_numpy(traffic.dense[sl]).to(dev),
            torch.from_numpy(traffic.idx[sl]).to(dev),
            torch.from_numpy(traffic.mask[sl]).to(dev)).cpu()
        for ctr in (ctr_auto, runs["float32", "mono", 2][0]):
            torch.testing.assert_close(torch.from_numpy(ctr[sl]),
                                       torch.sigmoid(logits), **TOL)
        for w in CODECS:
            # the logit of a float32 CTR, in float64: off by ~1e-6 at most
            got = torch.logit(torch.from_numpy(
                runs[w, "mono", 2][0][sl]).double())
            errs[w] = max(errs[w],
                          (got - logits.double()).abs().max().item())
    for w, tol in RAGGED_LOGIT_TOL.items():
        if errs[w] > tol:
            raise AssertionError(f"ragged {w}: logits {errs[w]:.3e} from "
                                 f"the plain forward, over {tol}")
    log(f"[ragged] ring == mono per codec and bound=2 == bound=0 "
        f"bit-identical; f32 CTRs (auto and ragged) within 1e-5 of the "
        f"plain forward; max |logit - plain| f32 {errs['float32']:.3e}, "
        f"bf16 {errs['bfloat16']:.3e} (<= 5e-2), int8 {errs['int8']:.3e} "
        f"(<= 1e-1); zero drops; live_max equal to the host count on every "
        f"run; the rows kernel, the pooled hits and the interaction "
        f"launched once per microbatch on every ragged run")

    slots = slot_host[np.arange(t)[None, :, None],
                      np.clip(traffic.idx, 0, r - 1)]
    miss = traffic.mask * (slots < 0)
    n_ex = RAGGED_BATCHES * BATCH // SERVED_MB
    for w in CODECS:
        dense_b = a2a.dense_wire_bytes(1, SERVED_MB, t, s, w)
        ragged_b = a2a.ragged_wire_bytes(1, cap, s, w,
                                         n_slots=SERVED_MB * t)
        ws = a2a.wire_stats(miss, s, w)
        log(f"[ragged] {w} wire, bytes a member moves per exchange (one "
            f"microbatch): dense layout {dense_b}, ragged layout at cap "
            f"{cap} {ragged_b} ({ragged_b / dense_b:.4f} of dense); the "
            f"live rows carry {ws.live_bytes / n_ex:.1f} on average "
            f"(wire_stats), the dense exchange {ws.dense_bytes / n_ex:.1f}, "
            f"the f32 reference {ws.ref_bytes / n_ex:.1f}")
    profile_flush(params, cfg, traffic, dev, tag="profile-ragged",
                  cache=cache, exchange="ragged", ragged_cap=cap)

    # the rows kernel at the served shape: what the ragged pack hands it
    # for microbatch 0 (live rows of the miss residual, cap-padded)
    ix = torch.from_numpy(traffic.idx[:SERVED_MB]).to(dev)
    mk = torch.from_numpy(traffic.mask[:SERVED_MB]).to(dev)
    res = hc.miss_mask_of(cache.slot_of, ix, mk)
    flat_n = SERVED_MB * t
    packed, counts, drops = a2a.pack_ragged_segments(
        {"idx": ix.reshape(flat_n, hot), "mask": res.reshape(flat_n, hot),
         "tid": torch.arange(flat_n, device=dev, dtype=torch.int32) % t},
        (res > 0).any(-1).reshape(-1), 1, cap)
    tid = packed["tid"].reshape(cap).contiguous()
    pidx = packed["idx"].reshape(cap, hot).contiguous()
    pmask = packed["mask"].reshape(cap, hot).contiguous()
    gid = tid.long()[:, None] * r + pidx.long().clamp(0, r - 1)
    flat = tables.reshape(t * r, s)
    l2 = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    name = f"embedding_bag_pool/rows_hot{hot}_cap{cap}"
    row = bag_kernel_row(
        name, f"{EB_PY}:619",
        lambda: eb.embedding_bag_rows(tables, tid, pidx, pmask),
        lambda: ref.embedding_bag_rows_ref(tables, tid, pidx, pmask),
        lambda: F.embedding_bag(gid, flat, mode="sum",
                                per_sample_weights=pmask),
        gid, pidx, pmask, cap, table=flat, rows=r, n_tables=t,
        flush=l2.zero_, tid=tid, extra_bytes=cap * 4)
    row["launches"] = runs["float32", "mono", 2][1]["embedding_bag_pool"] \
        .get(eb.launch_key(cap, hot, s, t, rows_form=True), 0)
    log(f"[kernel] {name}: microbatch 0 packs {int(counts.sum())} live rows "
        f"into cap {cap} ({int(drops)} dropped); launches on the f32 mono "
        f"ragged run {row['launches']}")
    return row, cache


def served_launches(label, cfg, n_flushes=N_BATCHES, bags_per_mb=1):
    """The DLRM kernels' launches by shape since the last reset; fails
    unless the bag and the interaction each ran once per microbatch of
    the ``n_flushes`` served batches at the served shape, and at no other
    (with a cache and the dense exchange the bag runs twice a microbatch
    at that shape: the pooled hits and the miss residual,
    ``bags_per_mb=2``)."""
    from repro_torch.kernels import dot_interaction as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops

    t, hot, s = cfg.n_tables, cfg.max_hot, cfg.embed_dim
    by_key = {k: dict(ops.kernels()[k].by_key) for k in DLRM_KERNELS}
    n_mb = n_flushes * (BATCH // SERVED_MB)
    want = {"embedding_bag_pool": {eb.launch_key(SERVED_MB * t, hot, s, t):
                                   bags_per_mb * n_mb},
            "dot_interaction": {di.launch_key(SERVED_MB, t + 1, s): n_mb}}
    if by_key != want:
        raise AssertionError(f"{label}: launches by shape {by_key}, not "
                             f"{want}")
    return by_key


def plans_chaos_phase(params, cfg, dev, card):
    """Phase 5c: precomputed stream plans with the pipelined engine, and
    the chaos path at P = 1, at full ``dlrm-kaggle`` width on the phase-5
    group (see the module docstring)."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.runtime.faults import (FaultInjector, FaultPlan,
                                            predict_absorption)
    from repro_torch.serving.engine import DLRMEngine

    batch = make_batch(cfg, N_BATCHES * BATCH, mode="hetero", seed=SEED)
    first = [torch.from_numpy(a[:BATCH]).to(dev)
             for a in (batch.dense, batch.idx, batch.mask)]

    # the plans: exist, stream the whole stack, sort
    plan = dlrm.build_forward_plans(params, cfg, first[1], microbatches=4)
    if plan is None:
        raise AssertionError("build_forward_plans gave no plan at full "
                             "width")
    _, tiles, L = plan.sid.shape
    n_blocks = -(-plan.total_rows // plan.rb)
    method = eb._resolve_plan_method("auto", L, n_blocks, tiles)
    if method != "sort" or plan.total_rows != cfg.n_tables * \
            params["tables"].shape[1]:
        raise AssertionError(f"plan over {plan.total_rows} rows by "
                             f"{method}: not the whole stack by 'sort'")
    side = torch.cuda.Stream(dev)
    build_ms, wall_ms = [], []
    for _ in range(7):
        side.wait_stream(torch.cuda.current_stream(dev))
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        with torch.cuda.stream(side):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            dlrm.build_forward_plans(params, cfg, first[1], microbatches=4)
            e1.record()
        wall_ms.append((time.perf_counter() - w0) * 1e3)
        e1.synchronize()
        build_ms.append(e0.elapsed_time(e1))
    log(f"[plans] build_forward_plans at 4 microbatches of 128: leaves "
        f"{tuple(plan.sid.shape)} (sid/pos/inv/cum) and "
        f"{tuple(plan.off.shape)} (off/seg0/seg1), rb {plan.rb}, "
        f"{plan.total_rows} rows in {n_blocks} blocks, 'auto' -> {method} "
        f"({tiles} tiles x L {L} x {n_blocks} blocks); on a side stream "
        f"median {statistics.median(build_ms):.3f} ms of card time, "
        f"{statistics.median(wall_ms):.3f} ms of host time to enqueue "
        f"(7 builds) card={card!r}")

    # plan vs inline at bound 0 / 1 microbatch and bound 2 / 4
    for bound, mb in ((0, 1), (2, 4)):
        p = dlrm.build_forward_plans(params, cfg, first[1], microbatches=mb)
        a = dlrm.forward_distributed(params, cfg, *first, bound=bound,
                                     microbatches=mb, plan=p)
        b = dlrm.forward_distributed(params, cfg, *first, bound=bound,
                                     microbatches=mb)
        if p is None or not torch.equal(a, b):
            raise AssertionError(f"plan at bound {bound} / {mb} "
                                 f"microbatches: logits differ from inline")
    other = dlrm.build_forward_plans(params, cfg, first[1], microbatches=4,
                                     row_block=4096)
    try:
        dlrm.forward_distributed(params, cfg, *first, bound=2,
                                 microbatches=4, plan=other)
        raise AssertionError("a plan for row_block 4096 was accepted")
    except ValueError:
        pass
    log("[plans] forward_distributed(plan=...) bit-identical to inline "
        "planning at bound 0 / 1 microbatch and bound 2 / 4; a plan built "
        "for row_block 4096 refused")

    # an inline and a pipelined engine on the same requests, after one
    # warm-up batch through the pipeline (its plan buffers, pinned blocks)
    warm = make_batch(cfg, BATCH, mode="hetero", seed=SEED + 1)
    serve(params, cfg, warm, 2, dev, plan_pipeline=True)
    ops.reset_launches()
    ctr_inline, eng_inline = serve(params, cfg, batch, 2, dev)
    keys = served_launches("inline engine", cfg)
    ops.reset_launches()
    pipe = DLRMEngine(params, cfg, batch_size=BATCH, bound=2,
                      microbatches=4, device=dev, plan_pipeline=True)
    outs = []
    for i in range(N_BATCHES * BATCH):
        if i == BATCH:
            # batch 1's plans, staged while batch 0 is in flight
            pipe.stage_plan(list(batch.idx[BATCH:2 * BATCH]))
        o = pipe.submit(batch.dense[i], batch.idx[i], batch.mask[i])
        if o is not None:
            outs.append(o)
    late = len(outs)
    tail = pipe.drain()
    served_launches("pipelined engine", cfg)
    if late != N_BATCHES - 1 or tail is None or tail.shape != (BATCH,) or \
            pipe.drain() is not None:
        got = None if tail is None else tail.shape
        raise AssertionError(f"pipelined engine: {late} batches before "
                             f"drain, then {got}")
    ctr_pipe = np.concatenate(outs + [tail])
    if not np.array_equal(ctr_pipe, ctr_inline):
        raise AssertionError("pipelined CTRs differ from inline")
    if pipe.stats.batches != N_BATCHES or pipe.plan_stage_hits < 1:
        raise AssertionError(f"pipelined engine: {pipe.stats.batches} "
                             f"batches, {pipe.plan_stage_hits} staged plans "
                             f"adopted")
    log(f"[plans] inline and plan_pipeline engines: 4 x 512 CTRs "
        f"bit-identical; the pipeline returned {late} batches one flush "
        f"late and drain the last; {pipe.plan_stage_hits} staged plan "
        f"adopted; launches per run by shape {keys}")
    for label, e in (("inline bound=2", eng_inline),
                     ("plan_pipeline bound=2", pipe)):
        log_serve("plans", label, e, card)

    # chaos at P = 1: a transient plan leaves the CTRs bit-identical
    fplan = FaultPlan.none(1, 8, seed=SEED).with_jitter(0.001) \
        .with_spike(0, 1, 0.002)
    inj = FaultInjector(fplan)
    ops.reset_launches()
    ctr_fault, eng_fault = serve(params, cfg, batch, 2, dev, faults=inj)
    served_launches("faulted engine", cfg)
    planned = sum(fplan.delay_of(0, k) for k in range(N_BATCHES))
    if not np.array_equal(ctr_fault, ctr_inline):
        raise AssertionError("CTRs under the transient fault plan differ")
    if inj.injected_delay_s != planned:
        raise AssertionError(f"injected {inj.injected_delay_s} s, the plan "
                             f"has {planned} s")
    # a deadline under every flush: each breach is transient (one member
    # flags no straggler), so the engine raises its bound
    deadline = 0.5 * min(eng_inline.monitor.lat)
    inj2 = FaultInjector(fplan)
    ops.reset_launches()
    ctr_dl, eng_dl = serve(params, cfg, batch, 0, dev, faults=inj2,
                           deadline_s=deadline, on_deadline="degrade")
    served_launches("deadline engine", cfg)
    st = eng_dl.stats
    if not np.array_equal(ctr_dl, ctr_inline) or \
            st.deadline_breaches != N_BATCHES or eng_dl.bound < 1 or \
            eng_dl.degraded_members or st.degraded_batches:
        raise AssertionError(
            f"deadline engine: breaches {st.deadline_breaches}, bound "
            f"{eng_dl.bound}, degraded {eng_dl.degraded_members}, CTRs "
            f"equal {np.array_equal(ctr_dl, ctr_inline)}")
    try:
        dlrm.forward_distributed(params, cfg, *first, degraded_members=(0,))
        raise AssertionError("degrading the only member was accepted")
    except ValueError:
        pass
    pred = {k: predict_absorption(fplan, k) for k in (0, 2)}
    log(f"[chaos] FaultPlan.none(1, 8).with_jitter(0.001).with_spike(0, 1, "
        f"0.002): injected {inj.injected_delay_s * 1e3:.3f} ms over "
        f"{N_BATCHES} flushes (the plan's {planned * 1e3:.3f} ms), CTRs "
        f"bit-identical to the fault-free run card={card!r}")
    log(f"[chaos] deadline {deadline * 1e3:.3f} ms (half the fastest "
        f"fault-free flush), on_deadline='degrade', bound 0: "
        f"{st.deadline_breaches} breaches, bound raised to {eng_dl.bound}, "
        f"nothing degraded, CTRs bit-identical card={card!r}")
    for k, r in pred.items():
        log(f"[chaos] predict_absorption bound {k}: absorbed {r.absorbed}, "
            f"blocked {r.blocked_s * 1e3:.3f} ms (fault-free "
            f"{r.baseline_blocked_s * 1e3:.3f}), makespan "
            f"{r.makespan_s * 1e3:.3f} ms (fault-free "
            f"{r.baseline_makespan_s * 1e3:.3f})")
    log("[chaos] P = 1 cannot degrade or evict: degrading the only member "
        "is refused and eviction would leave none; those paths are held "
        "on gloo at P = 4 by tests/test_torch_faults.py")
    for label, e in (("faults bound=2", eng_fault),
                     ("deadline bound=0->" + str(eng_dl.bound), eng_dl)):
        log_serve("chaos", label, e, card)


# phase 5d: the frontend open loop (8192 hetero requests, seed 7, at 1.5x
# the measured capacity, SLO 100 ms, queue bound 2048), its bit-identity
# check on a virtual clock (1024 hetero requests, seed 21, the first 32
# flushed alone), and freshness (16 powerlaw versions of 32 rows, seed 7,
# k_fresh 2, slices of 8, 4 rows of member 0 corrupted at flush 2, at most
# 32 flushes of 512 powerlaw_hetero requests)
FE_REQUESTS, FE_OVERLOAD, FE_SLO_S, FE_QUEUE = 8192, 1.5, 0.100, 2048
FE_VCLOCK_REQUESTS, FE_VCLOCK_RPS, FE_VCLOCK_STEP_S = 1024, 2000.0, 0.00025
FE_SINGLE = 32
FRESH_VERSIONS, FRESH_ROWS, FRESH_K, FRESH_CAP = 16, 32, 2, 8
FRESH_MAX_FLUSHES = 32
FRESH_PROFILED = 8           # the freshness flush traced by the profiler
FRESH_RECOUNT = 4            # the freshness flush whose stale bags the
                             # host model recounts
COUNTED = ("all_to_all_single", "batch_isend_irecv", "all_gather",
           "all_reduce")


class VClock:
    """A clock that moves only when its caller moves it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@contextlib.contextmanager
def count_collectives():
    """Counts the calls of each ``torch.distributed`` collective the
    forward makes, while the block runs."""
    import torch.distributed as dist

    counts = dict.fromkeys(COUNTED, 0)
    orig = {k: getattr(dist, k) for k in COUNTED}

    def counted(name):
        def call(*a, **kw):
            counts[name] += 1
            return orig[name](*a, **kw)
        return call

    for k in COUNTED:
        setattr(dist, k, counted(k))
    try:
        yield counts
    finally:
        for k, f in orig.items():
            setattr(dist, k, f)


def plain_ctrs(params, cfg, dev, dense, idx, mask):
    """sigmoid of the plain-PyTorch forward, BATCH requests at a time."""
    from repro_torch.models import dlrm

    plain_cfg = cfg.replace(sparse_backend="ref")
    out = []
    for k in range(0, len(dense), BATCH):
        sl = slice(k, k + BATCH)
        out.append(torch.sigmoid(dlrm.forward_local(
            params, plain_cfg, torch.from_numpy(dense[sl]).to(dev),
            torch.from_numpy(idx[sl]).to(dev),
            torch.from_numpy(mask[sl]).to(dev))).cpu())
    return torch.cat(out)


def ms(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3


def frontend_fresh_phase(params, cfg, dev, card, cache):
    """Phase 5d: the serving frontend and online embedding freshness at
    full ``dlrm-kaggle`` width on the phase-5 group, with phase 5b's
    4096-row cache for the freshness run (see the module docstring)."""
    import itertools

    from repro_torch.data.synthetic import (delta_stream, make_batch,
                                            make_delta_batch,
                                            request_stream)
    from repro_torch.kernels import ops
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.runtime.freshness import (FreshnessManager,
                                               oracle_tables)
    from repro_torch.serving import hot_cache as hc
    from repro_torch.serving.engine import DLRMEngine
    from repro_torch.serving.frontend import ServingFrontend

    def engine(p=params, **kw):
        return DLRMEngine(p, cfg, batch_size=BATCH, bound=2, microbatches=4,
                          exchange="dense", device=dev, **kw)

    # 1. the open loop in real time, at 1.5x the measured capacity
    warm = make_batch(cfg, BATCH, mode="hetero", seed=7)
    eng = engine()
    ops.reset_launches()
    flush_s = []
    for _ in range(4):
        t0 = time.perf_counter()
        for i in range(BATCH):
            eng.submit(warm.dense[i], warm.idx[i], warm.mask[i])
        eng.drain()
        flush_s.append(time.perf_counter() - t0)
    served_launches("capacity engine", cfg, 4)
    flush = min(flush_s)
    capacity = BATCH / flush
    rate = FE_OVERLOAD * capacity
    reqs = request_stream(cfg, FE_REQUESTS, rate_rps=rate, burstiness=0.3,
                          mode="hetero", seed=7)
    eng = engine()
    fe = ServingFrontend(eng, slo_s=FE_SLO_S, max_queue=FE_QUEUE,
                         admission="slo", init_flush_s=flush)
    ops.reset_launches()
    which, completed, nxt, submit_s = {}, [], 0, 0.0
    t0 = time.perf_counter()
    while nxt < len(reqs):
        # the reference example's drive: everything that has arrived by
        # now enters, backdated to its arrival, before the next round
        now = time.perf_counter()
        while nxt < len(reqs) and t0 + reqs[nxt].t_arrive <= now:
            r = reqs[nxt]
            s0 = time.perf_counter()
            res = fe.try_submit(r.dense, r.idx, r.mask, now=t0 + r.t_arrive)
            submit_s += time.perf_counter() - s0
            if res.admitted:
                which[res.request_id] = nxt
            nxt += 1
        completed += fe.pump()
    completed += fe.drain()
    wall = time.perf_counter() - t0
    st = fe.stats
    served_launches("frontend engine", cfg, st.batches)
    if not (st.accounted and st.queued == 0 and st.inflight == 0
            and len(completed) == st.completed
            and st.admitted == st.served + st.degraded_served + st.shed):
        raise AssertionError(f"frontend accounting drifted: "
                             f"{st.to_dict()}")
    ctr = np.array([c.ctr for c in completed], np.float32)
    if not (np.isfinite(ctr).all() and (ctr > 0).all() and (ctr < 1).all()):
        raise AssertionError("frontend CTRs not finite or not in (0, 1)")
    sel = [which[c.request_id] for c in completed]
    want = plain_ctrs(params, cfg, dev,
                      *(np.stack([getattr(reqs[i], k) for i in sel])
                        for k in ("dense", "idx", "mask")))
    torch.testing.assert_close(torch.from_numpy(ctr), want, **TOL)
    qd, e2e = st.queue_delay, st.e2e
    host_us = (wall - st.total_s) / st.offered * 1e6
    log(f"[frontend] capacity {capacity:.1f} req/s (fastest of 4 warm "
        f"flushes of 512 hetero requests: {flush * 1e3:.3f} ms); offered "
        f"{FE_OVERLOAD}x = {rate:.1f} req/s, burstiness 0.3, "
        f"{FE_REQUESTS} requests, SLO {FE_SLO_S * 1e3:.0f} ms, queue bound "
        f"{FE_QUEUE}, admission 'slo' card={card!r}")
    log(f"[frontend] offered {st.offered}, admitted {st.admitted}, "
        f"rejected {st.rejected} (retried {st.retried}), shed {st.shed}, "
        f"served {st.served} (+{st.degraded_served} degraded), late "
        f"{st.served_late}; escalations {st.escalations}, de-escalations "
        f"{st.deescalations}; {st.batches} flushes; shed share "
        f"{st.shed / st.offered:.4f}, rejected share "
        f"{st.rejected / st.offered:.4f}")
    log(f"[frontend] queue delay p50 {qd.percentile(0.5) * 1e3:.3f} ms p99 "
        f"{qd.percentile(0.99) * 1e3:.3f} ms; e2e p50 "
        f"{e2e.percentile(0.5) * 1e3:.3f} ms p99 "
        f"{e2e.percentile(0.99) * 1e3:.3f} ms; engine flush p50 "
        f"{eng.monitor.percentile(0.5) * 1e3:.3f} ms card={card!r}")
    log(f"[frontend] host: the drive took {wall * 1e3:.3f} ms, "
        f"{st.total_s * 1e3:.3f} of them in the engine's flushes; "
        f"frontend host time {host_us:.2f} us a request outside the "
        f"flushes (try_submit {submit_s / st.offered * 1e6:.2f} us a call); "
        f"arrivals {1e6 / rate:.2f} us apart on average")
    log(f"[frontend] accounting exact (admitted {st.admitted} == served "
        f"{st.served} + degraded {st.degraded_served} + shed {st.shed}); "
        f"{len(completed)} CTRs finite in (0, 1) and within 1e-5 of the "
        f"plain forward; launches at the served shape only")
    log_serve("frontend", "open loop bound=2", eng, card)

    # 2. bit-identity on a virtual clock: batched == alone, inline ==
    # pipelined with lookahead
    vreqs = request_stream(cfg, FE_VCLOCK_REQUESTS, rate_rps=FE_VCLOCK_RPS,
                           mode="hetero", seed=21)

    def vdrive(e, lookahead):
        clock = VClock()
        f = ServingFrontend(e, slo_s=FE_SLO_S, admission="none", shed=False,
                            lookahead=lookahead, init_flush_s=flush,
                            clock=clock)
        done, k = [], 0
        while k < len(vreqs):
            while k < len(vreqs) and vreqs[k].t_arrive <= clock.t:
                r = vreqs[k]
                f.try_submit(r.dense, r.idx, r.mask)
                k += 1
            done += f.pump()
            clock.t += FE_VCLOCK_STEP_S
        done += f.drain()
        if not f.stats.accounted or f.stats.completed != len(vreqs):
            raise AssertionError(f"virtual-clock frontend: "
                                 f"{f.stats.to_dict()}")
        return {c.request_id: c.ctr for c in done}, f

    ops.reset_launches()
    eng_v = engine()
    inline, fe_v = vdrive(eng_v, False)
    served_launches("virtual-clock frontend", cfg, eng_v.stats.batches)
    ops.reset_launches()
    alone = engine()
    for i in range(FE_SINGLE):
        r = vreqs[i]
        alone.submit(r.dense, r.idx, r.mask)
        out = alone.flush()
        if out.shape != (1,) or np.float64(out[0]) != inline[i]:
            raise AssertionError(f"request {i}: flushed alone {out}, in its "
                                 f"frontend batch {inline[i]}")
    served_launches("single-request flushes", cfg, FE_SINGLE)
    ops.reset_launches()
    pipe = engine(plan_pipeline=True)
    piped, fe_p = vdrive(pipe, True)
    served_launches("pipelined frontend", cfg, pipe.stats.batches)
    if piped != inline:
        raise AssertionError("pipelined frontend CTRs differ from inline")
    if fe_p.stats.plans_staged < 1 or pipe.plan_stage_hits < 1:
        raise AssertionError(f"lookahead: {fe_p.stats.plans_staged} plans "
                             f"staged, {pipe.plan_stage_hits} adopted")
    log(f"[frontend] virtual clock, {FE_VCLOCK_REQUESTS} hetero requests "
        f"(seed 21) at {FE_VCLOCK_RPS:.0f} req/s, admission 'none': "
        f"{eng_v.stats.batches} flushes; the first {FE_SINGLE} requests "
        f"flushed alone bit-identical to their batched CTRs; a "
        f"plan_pipeline engine under a lookahead frontend bit-identical "
        f"({fe_p.stats.plans_staged} plans staged, "
        f"{pipe.plan_stage_hits} adopted, {pipe.stats.batches} flushes)")

    # 3. freshness on a copy of the stack, with phase 5b's cache
    base = params["tables"]
    fparams = dict(params, tables=base.clone())
    fcache = hc.HotCache(hot_ids=cache.hot_ids,
                         hot_rows=cache.hot_rows.clone(),
                         slot_of=cache.slot_of)
    versions = [make_delta_batch(cfg, v, rows_per_version=FRESH_ROWS,
                                 mode="powerlaw", seed=7)
                for v in range(1, FRESH_VERSIONS + 1)]
    fm = FreshnessManager(itertools.islice(delta_stream(
        cfg, rows_per_version=FRESH_ROWS, mode="powerlaw", seed=7),
        FRESH_VERSIONS), k_fresh=FRESH_K, slice_cap=FRESH_CAP)
    fplan = FaultPlan.none(1, 64).with_delta_corruption(0, 2, n_rows=4)
    feng = engine(fparams, cache=fcache, freshness=fm,
                  faults=FaultInjector(fplan, time_scale=0.0))
    stale = {"n": 0, "recount": None, "flush": None}
    host = {k: [] for k in ("apply", "next_wire", "ingest",
                            "count_stale_served")}

    def timed(name):
        # the manager's host time a flush, method by method, each call a
        # profiler range
        fn = getattr(fm, name)

        def call(*a):
            if name == "count_stale_served" and \
                    len(host[name]) == FRESH_RECOUNT:
                # the pending rows as the manager's count sees them
                stale["recount"] = host_stale_count(
                    fm, fparams["tables"].shape[1], *a[1:])
            s0 = time.perf_counter()
            with torch.profiler.record_function(f"fresh.{name}"):
                out = fn(*a)
            host[name].append(time.perf_counter() - s0)
            if name == "count_stale_served":
                stale["n"] += out
                if len(host[name]) == FRESH_RECOUNT + 1:
                    stale["flush"] = out
            return out
        return call

    for name in host:
        setattr(fm, name, timed(name))
    ops.reset_launches()
    served = []
    prof = None
    try:
        for step in range(FRESH_MAX_FLUSHES):
            b = make_batch(cfg, BATCH, mode="powerlaw_hetero",
                           seed=SEED + 2, step=step)
            served.append(b)
            if step == FRESH_PROFILED:
                # one flush mid-stream, rows pending and applied, profiled
                prof = profile_batch(feng, b, "profile-fresh")
            else:
                for i in range(BATCH):
                    feng.submit(b.dense[i], b.idx[i], b.mask[i])
            if fm.fully_committed:
                break
    finally:
        # the wrappers refer to the manager and to the stack's copy: drop
        # them, so nothing holds the copy once the phase returns
        for name in host:
            delattr(fm, name)
    served_launches("freshness engine", cfg, len(served), bags_per_mb=2)
    # the profiled and the recounted flushes are left out of the flush
    # times, on both sides
    left_out = sorted((FRESH_PROFILED, FRESH_RECOUNT), reverse=True)
    with_lat = list(feng.monitor.lat)
    for i in left_out:
        with_lat.pop(i)
    if stale["recount"] is None or stale["recount"] != stale["flush"] or \
            stale["flush"] < 1:
        raise AssertionError(
            f"rows_stale_served of flush {FRESH_RECOUNT}: the manager "
            f"counted {stale['flush']}, the host model "
            f"{stale['recount']}")
    fs = feng.stats
    n_rows = sum(v.n_rows for v in versions)
    if not fm.fully_committed:
        raise AssertionError(f"freshness: not committed after "
                             f"{FRESH_MAX_FLUSHES} flushes")
    if any(v > FRESH_K for v in fm.behind_trace):
        raise AssertionError(f"versions_behind {fm.behind_trace} over "
                             f"k_fresh {FRESH_K}")
    if fm.rows_applied != n_rows or fm.delta_rejects < 1 or fm.rollbacks:
        raise AssertionError(f"freshness: rows_applied {fm.rows_applied} "
                             f"of {n_rows}, rejects {fm.delta_rejects}, "
                             f"rollbacks {fm.rollbacks}")
    mirrored = (fs.rows_applied, fs.delta_rejects, fs.apply_rollbacks,
                fs.versions_behind, fs.rows_stale_served)
    if mirrored != (fm.rows_applied, fm.delta_rejects, fm.rollbacks,
                    fm.ledger.versions_behind, stale["n"]):
        raise AssertionError(f"ServeStats {mirrored} differ from the "
                             f"manager's")
    oracle = oracle_tables(base, versions)
    if not torch.equal(fparams["tables"], oracle):
        raise AssertionError("freshness: the stack differs from "
                             "oracle_tables")
    ids = fcache.hot_ids.long()
    want_rows = oracle[torch.arange(ids.shape[0], device=dev)[:, None], ids]
    if fm.cache_refreshed < 1 or not torch.equal(fcache.hot_rows,
                                                 want_rows):
        raise AssertionError(f"freshness: {fm.cache_refreshed} cached rows "
                             f"refreshed; cache equal to the oracle's rows "
                             f"{torch.equal(fcache.hot_rows, want_rows)}")
    # a fresh batch: this engine against a new one on the oracle stack
    oeng = engine(dict(params, tables=oracle),
                  cache=hc.HotCache(hot_ids=fcache.hot_ids,
                                    hot_rows=want_rows,
                                    slot_of=fcache.slot_of))
    probe = make_batch(cfg, BATCH, mode="powerlaw_hetero", seed=SEED + 3)
    ops.reset_launches()
    got = {}
    for label, e in (("fresh", feng), ("oracle", oeng)):
        with count_collectives() as calls:
            for i in range(BATCH):
                o = e.submit(probe.dense[i], probe.idx[i], probe.mask[i])
        got[label] = (o, dict(calls))
    served_launches("probe flushes", cfg, 2, bags_per_mb=2)
    if not np.array_equal(got["fresh"][0], got["oracle"][0]):
        raise AssertionError("a fresh batch served by the freshness engine "
                             "differs from a new engine on the oracle stack")
    if got["fresh"][1] != got["oracle"][1]:
        raise AssertionError(f"collective calls a flush with deltas "
                             f"{got['fresh'][1]}, without "
                             f"{got['oracle'][1]}")
    # the same requests without freshness, for the flush times
    plain = engine(cache=cache)
    for b in served:
        for i in range(BATCH):
            plain.submit(b.dense[i], b.idx[i], b.mask[i])
    card_ms = [a.elapsed_time(z) for _, a, z in fm.apply_trace
               if a is not None] or [float("nan")]
    host_ms = [h * 1e3 for h, _, _ in fm.apply_trace]
    without_lat = list(plain.monitor.lat)
    for i in left_out:
        without_lat.pop(i)
    slot_with, slot_without = feng.slot_bytes(), oeng.slot_bytes()
    log(f"[fresh] {FRESH_VERSIONS} powerlaw versions x {FRESH_ROWS} rows "
        f"({n_rows} after dedup), k_fresh {FRESH_K}, slices of "
        f"{FRESH_CAP}, 4 rows of member 0 corrupted at flush 2, phase 5b's "
        f"{CACHE_ROWS}-row cache: committed after {len(served)} flushes of "
        f"512 powerlaw_hetero requests; rows_applied {fm.rows_applied}, "
        f"delta_rejects {fm.delta_rejects}, rollbacks {fm.rollbacks}, "
        f"applies {fm.applies}, cache_refreshed {fm.cache_refreshed}, "
        f"source_blocked {fm.source_blocked}, rows_stale_served "
        f"{stale['n']}; versions_behind per flush {fm.behind_trace}")
    traced = {k: range_device_us(prof, f"fresh.{k}") for k in host}
    log(f"[fresh] apply window (in place with an undo log): device time "
        f"{traced['apply'][0]:.1f} us in the profiled flush's window "
        f"({traced['apply'][1]} device operations, from the trace); wall "
        f"on the stream between CUDA events p50 "
        f"{statistics.median(card_ms):.4f} ms max {max(card_ms):.4f} ms, "
        f"host ms p50 {statistics.median(host_ms):.4f} max "
        f"{max(host_ms):.4f} over {len(fm.apply_trace)} windows "
        f"card={card!r}")
    log("[fresh] device time of the profiled flush's other manager calls "
        "(from the trace): " + ", ".join(
            f"{k} {us:.1f} us ({n} device operations)"
            for k, (us, n) in traced.items() if k != "apply"))
    log(f"[fresh] flush p50 {ms(with_lat, 0.5):.3f} ms p99 "
        f"{ms(with_lat, 0.99):.3f} ms with deltas; the same requests "
        f"without freshness p50 {ms(without_lat, 0.5):.3f} ms p99 "
        f"{ms(without_lat, 0.99):.3f} ms card={card!r}")
    log(f"[fresh] slot_bytes {slot_with} with the xdelta field, "
        f"{slot_without} without ({slot_with - slot_without} B a slot)")
    log("[fresh] the manager's host ms a flush, p50 / max: " + ", ".join(
        f"{k} {ms(v, 0.5):.4f} / {max(v) * 1e3:.4f}"
        for k, v in host.items()) + f" (over {len(host['ingest'])} "
        f"flushes; apply counts every call, empty windows included)")
    log(f"[fresh] the stack bit-identical to oracle_tables (compared on the "
        f"card against a {base.numel() * base.element_size() / 1e9:.2f} GB "
        f"copy); the cache's rows equal the oracle's at hot_ids; a fresh "
        f"batch bit-identical to a new engine on the oracle stack; "
        f"collective calls a flush with and without deltas "
        f"{got['fresh'][1]}; launches at the served shape only, the bag "
        f"twice a microbatch (pooled hits and residual)")
    log_serve("fresh", "freshness bound=2", feng, card)
    log_serve("fresh", "no freshness bound=2", plain, card)


def host_stale_count(fm, r: int, idx, mask) -> int:
    """The plain host model of ``count_stale_served``: the (sample, table)
    bags of the batch whose live ids hit a row pending in ``fm``, by
    ``np.isin`` on the host."""
    pend = [g for gids in fm._remaining.values() for g in gids]
    if not pend:
        return 0
    i, m = idx.cpu().numpy(), mask.cpu().numpy()
    t = np.arange(i.shape[1], dtype=np.int64)[None, :, None]
    hit = np.isin(t * r + i.astype(np.int64),
                  np.asarray(pend, np.int64)) & (m > 0)
    return int(hit.any(axis=-1).sum())


def range_device_us(prof, name: str):
    """(device us, device operations) of the kernels and copies launched
    inside the profiler range ``name``, the range's own span on the
    device left out; (nan, 0) without a trace."""
    if prof is None:
        return float("nan"), 0
    us, n = 0.0, 0
    stack = [e for e in prof.events() if e.name == name
             and e.device_type != torch.autograd.DeviceType.CUDA]
    while stack:
        e = stack.pop()
        work = [k for k in e.kernels if k.name != name]
        us += sum(k.duration for k in work)
        n += len(work)
        stack.extend(e.cpu_children)
    return us, n


def admitted_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal layer of length s admits."""
    live = np.arange(1, s + 1)
    return int((np.minimum(live, window) if window else live).sum())


# phase 5e: placement (phase 5's 4 x 512 hetero requests under the
# reversed slot order), an online reshard at P = 1 (a hand-built plan
# rotating the slots of the 8 smallest tables, 206 rows, installments of
# 8 rows a microbatch slice, 12 flushes of 512 drift requests, seed 7),
# and scrubbing (budget 65,536 blocks of 32 rows and as many cache slots a
# flush, phase 5b's cache, 8 flushes of 512 powerlaw_hetero requests, seed
# 9) with three resident flips, one cached-copy flip and one corrupted
# segment
RESHARD_FLUSHES, RESHARD_CAP = 12, 8
SCRUB_FLUSHES, SCRUB_BUDGET, SCRUB_BLOCK, SCRUB_QCAP = 8, 65536, 32, 64
# (table, row, bit, flush) of each resident flip, and the flush its block
# is dispatched at: the cursor walks (table, block) table-major, 65,536
# blocks a flush, 34,416 blocks a table; the harvest comes one flush later
SCRUB_FLIPS = ((0, 700, 13, 0), (2, 500_000, 5, 0), (3, 1_000_000, 30, 0))
SCRUB_WIRE_FLUSH = 2
SCRUB_PROFILED = 1           # the scrub flush traced by the profiler


def rotation_plan(cfg, plc):
    """A hand-built ``MigrationPlan`` at P = 1: the slots of the 8
    smallest tables rotate by one, each move ``(t, 0, 0, rows)``."""
    sizes = np.asarray(cfg.table_sizes)
    small = sorted(np.argsort(sizes, kind="stable")[:8].tolist())
    perm = list(range(len(sizes)))
    for i, t in enumerate(small):
        perm[t] = small[(i + 1) % len(small)]
    moves = tuple((int(t), 0, 0, int(sizes[t])) for t in sorted(
        small, key=lambda t: perm.index(t)))
    return plc.MigrationPlan(
        new_map=plc.PartitionMap(tuple(perm)), moves=tuple(sorted(moves)),
        row_splits=(), load_before=(1.0,), load_after=(1.0,))


def add_launches(total, label, cfg, n_flushes, bags_per_mb=1):
    """Check the launches since the last reset (:func:`served_launches`)
    and add them to ``total``, by kernel and shape."""
    from repro_torch.kernels import ops

    for k, by in served_launches(label, cfg, n_flushes,
                                 bags_per_mb).items():
        for key, n in by.items():
            total.setdefault(k, {})
            total[k][key] = total[k].get(key, 0) + n
    ops.reset_launches()


def reshard_scrub_phase(params, cfg, dev, card, cache, ctr5):
    """Phase 5e: skew-aware placement, online resharding and integrity
    scrubbing at full ``dlrm-kaggle`` width on the phase-5 group (see the
    module docstring).  ``ctr5`` are phase 5's bound-2 CTRs.  Returns the
    DLRM kernels' launches of the phase by shape."""
    from repro_torch.core import integrity as integ
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.runtime import placement as plc
    from repro_torch.runtime import reshard as reshard_mod
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.serving import hot_cache as hc
    from repro_torch.serving.engine import DLRMEngine

    def engine(p, **kw):
        return DLRMEngine(p, cfg, batch_size=BATCH, bound=2, microbatches=4,
                          device=dev, **kw)

    launches: dict = {}
    base = params["tables"]
    t = cfg.n_tables
    stack_gb = base.numel() * base.element_size() / 1e9
    log(f"[reshard] device memory allocated at the phase's start "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB (the stack "
        f"{stack_gb:.2f} GB)")

    # (a) placement: the reversed slot order, phase 5's requests
    ops.reset_launches()
    perm = tuple(range(t))[::-1]
    pm = plc.PartitionMap(perm)
    p_perm = torch.from_numpy(pm.perm_array().astype(np.int64)).to(dev)
    placed = dict(params, tables=base[p_perm])
    batch = make_batch(cfg, N_BATCHES * BATCH, mode="hetero", seed=SEED)
    outs = []
    for j in range(N_BATCHES):
        sl = slice(j * BATCH, (j + 1) * BATCH)
        dense, idx, mask = (torch.from_numpy(a[sl]).to(dev) for a in (
            batch.dense, batch.idx, batch.mask))
        logits = dlrm.forward_distributed(
            placed, cfg, dense, idx[:, p_perm], mask[:, p_perm], bound=2,
            microbatches=4, table_inv=pm.inv_array())
        outs.append(torch.sigmoid(logits).cpu().numpy())
    del placed
    got = np.concatenate(outs)
    if not np.array_equal(got, ctr5):
        raise AssertionError(
            f"placement: CTRs under the reversed slot order differ from "
            f"phase 5's (max {np.abs(got - ctr5).max():.3e})")
    add_launches(launches, "placement", cfg, N_BATCHES)
    log(f"[reshard] (a) {N_BATCHES} x {BATCH} hetero requests under the "
        f"reversed slot order (table_inv): CTRs bit-identical to phase 5's")

    # (b) an online reshard at P = 1 onto a hand-built plan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plan = rotation_plan(cfg, plc)
    eng = engine(dict(params), rebalance=True, mig_slice_cap=RESHARD_CAP)
    static = engine(dict(params))
    commit = {}
    install = reshard_mod.install_stack

    def timed_install(*a):
        # the cutover's device work: gather, zero, scatter of the stack
        from torch.profiler import ProfilerActivity, profile
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ev[0].record()
            new = install(*a)
            ev[1].record()
            torch.cuda.synchronize()
            commit["wall_ms"] = (time.perf_counter() - t0) * 1e3
        commit["event_ms"] = ev[0].elapsed_time(ev[1])
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        commit["device_ms"] = sum(e.time_range.elapsed_us()
                                  for e in kern) / 1e3 if kern else None
        commit["ops"] = len(kern)
        return new

    reshard_mod.install_stack = timed_install
    lv0 = eng.layout_version
    calls = {"mig": [], "static": []}
    flush_ms = {"mig": [], "static": []}
    mig_flushes = 0
    cut = None
    try:
        for s in range(RESHARD_FLUSHES):
            if s == 1:
                eng.start_reshard(plan)
            b = make_batch(cfg, BATCH, mode="drift", seed=7, step=s)
            riding = eng.reshard is not None and eng.reshard.active
            mig_flushes += riding
            res = {}
            for key, e in (("mig", eng), ("static", static)):
                with count_collectives() as n:
                    t0 = time.perf_counter()
                    for i in range(BATCH):
                        o = e.submit(b.dense[i], b.idx[i], b.mask[i])
                    flush_ms[key].append((time.perf_counter() - t0) * 1e3)
                if riding:
                    calls[key].append(dict(n))
                res[key] = o
            if cut is None and eng.stats.reshards:
                cut = s
            if not np.array_equal(res["mig"], res["static"]):
                raise AssertionError(
                    f"reshard: flush {s} CTRs differ from the static "
                    f"engine's (migration in flight {riding})")
    finally:
        reshard_mod.install_stack = install
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    if (st.reshards, st.migrated_rows, eng.layout_version - lv0) != \
            (1, plan.moved_rows, 1):
        raise AssertionError(
            f"reshard: reshards {st.reshards}, migrated_rows "
            f"{st.migrated_rows} of {plan.moved_rows}, layout_version "
            f"{lv0} -> {eng.layout_version}")
    if eng.pmap.perm != plan.new_map.perm or not commit:
        raise AssertionError("reshard: the cutover did not land")
    if not calls["mig"] or calls["mig"] != calls["static"]:
        raise AssertionError(f"reshard: collective calls a flush with the "
                             f"xmig rider {calls['mig']}, without "
                             f"{calls['static']}")
    add_launches(launches, "reshard engines", cfg, 2 * RESHARD_FLUSHES)
    bound_ms = 2 * stack_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    log(f"[reshard] (b) a hand-built plan rotating the slots of the 8 "
        f"smallest tables ({plan.moved_rows} rows, moves {plan.moves}), "
        f"installments of {RESHARD_CAP} rows a slice: the xmig rider rode "
        f"{mig_flushes} flushes, cut over on flush {cut}: reshards "
        f"{st.reshards}, "
        f"migrated_rows {st.migrated_rows}, layout_version {lv0} -> "
        f"{eng.layout_version}; every CTR bit-identical to a static engine "
        f"before, during and after the cutover; collective calls a flush "
        f"with the rider {calls['mig'][0]}, without "
        f"{calls['static'][0]}")
    log(f"[reshard] cutover (install_stack: gather {stack_gb:.2f} GB into "
        f"the new slot order, zero the moved slots, scatter the banked "
        f"rows): wall {commit['wall_ms']:.3f} ms, device "
        f"{commit['device_ms']} ms over {commit['ops']} device operations "
        f"(profiler trace), stream span {commit['event_ms']:.3f} ms "
        f"between CUDA events, byte bound {bound_ms:.2f} ms (read and "
        f"write {stack_gb:.2f} GB at 3.35 TB/s); peak device memory "
        f"{peak_gb:.2f} GB; flush p50 {ms([x / 1e3 for x in flush_ms['mig']], 0.5):.3f} "
        f"ms with the reshard, {ms([x / 1e3 for x in flush_ms['static']], 0.5):.3f} "
        f"ms static card={card!r}")
    del eng, static
    torch.cuda.empty_cache()

    # (c) scrubbing with phase 5b's cache
    torch.cuda.reset_peak_memory_stats()
    c_row = int(cache.hot_ids[0, 0])
    # slots the scrubber will invalidate: the flipped copy's, and those of
    # flipped base rows that are cached (their copy no longer matches)
    inval = [(0, c_row)] + [(tb, row) for tb, row, _, _ in SCRUB_FLIPS
                            if int(cache.slot_of[tb, row]) >= 0]
    fp = FaultPlan.none(1, 64)
    for tb, row, bit, when in SCRUB_FLIPS:
        fp = fp.with_bitflip(0, tb, row, bit, when=when)
    fp = fp.with_bitflip(0, 0, c_row, 3, when=0, target="cache") \
        .with_wire_corruption(0, 0, when=SCRUB_WIRE_FLUSH)
    scache = hc.HotCache(hot_ids=cache.hot_ids,
                         hot_rows=cache.hot_rows.clone(),
                         slot_of=cache.slot_of)
    seng = engine(dict(params, tables=base.clone()), cache=scache,
                  exchange="dense", faults=FaultInjector(fp, time_scale=0.0),
                  scrub_budget=SCRUB_BUDGET, scrub_block_rows=SCRUB_BLOCK,
                  quarantine_cap=SCRUB_QCAP)
    sc = seng.scrub
    boot_cs = sc.ledger.block_cs.copy()
    boot = dict(sc.boot)
    # the clean engine: the same cache with the flipped copy's slot
    # invalidated, as the scrubber leaves it
    ccache, _ = hc.invalidate(cache, [tb for tb, _ in inval],
                              [row for _, row in inval])
    clean = engine(dict(params), cache=ccache, exchange="dense")
    detected: dict = {}
    recount = {"n": 0, "host": 0}
    host_ms: dict = {}

    def ranged(name, fn):
        # a profiler range and the host time of every call
        def call(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*a, **kw)
            host_ms.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        return call

    audit = ranged("scrub.audit", sc.audit)
    count = ranged("scrub.count_quarantined_served",
                   sc.count_quarantined_served)

    def audited(e, step):
        newly = audit(e, step)
        for g in newly:
            detected.setdefault(g, step)
        return newly

    def counted(e, idx, mask):
        n = count(e, idx, mask)
        if sc.quarantined:
            r = e.params["tables"].shape[1]
            i, m = idx.cpu().numpy(), mask.cpu().numpy()
            tt = np.arange(i.shape[1], dtype=np.int64)[None, :, None]
            hit = np.isin(tt * r + i.astype(np.int64),
                          np.fromiter(sc.quarantined, np.int64)) & (m > 0)
            recount["host"] += int(hit.any(axis=-1).sum())
        recount["n"] += n
        return n

    # instance attributes over the scrubber's and the engines' methods,
    # deleted in the finally below (they refer to their owners)
    wrapped = [(sc, "audit", audited), (sc, "count_quarantined_served",
                                        counted)]
    for name in ("_harvest", "_dispatch_blocks", "_dispatch_cache",
                 "bank_audit", "quarantine_phys", "apply", "next_wire",
                 "ingest"):
        wrapped.append((sc, name, ranged(f"scrub.{name}",
                                         getattr(sc, name))))
    for key, e in (("scrub", seng), ("clean", clean)):
        for name in ("_run_batch", "_dispatch", "_finish_batch"):
            wrapped.append((e, name, ranged(f"{key}.engine.{name}",
                                            getattr(e, name))))
    for obj, name, fn in wrapped:
        setattr(obj, name, fn)
    stamp, verify = integ.wire_stamp, integ.wire_verify
    integ.wire_stamp = ranged("scrub.wire_stamp", stamp)
    integ.wire_verify = ranged("scrub.wire_verify", verify)
    served = {"scrub": [], "clean": []}
    calls = {}
    prof = None
    try:
        for s in range(SCRUB_FLUSHES):
            b = make_batch(cfg, BATCH, mode="powerlaw_hetero", seed=9,
                           step=s)
            for key, e in (("scrub", seng), ("clean", clean)):
                with count_collectives() as n:
                    if key == "scrub" and s == SCRUB_PROFILED:
                        prof = profile_batch(e, b, "profile-scrub")
                        o = None
                    else:
                        for i in range(BATCH):
                            o = e.submit(b.dense[i], b.idx[i], b.mask[i])
                calls.setdefault(key, dict(n))
                served[key].append(o)
    finally:
        integ.wire_stamp, integ.wire_verify = stamp, verify
        for obj, name, _ in wrapped:
            delattr(obj, name)
    add_launches(launches, "scrub engines", cfg, 2 * SCRUB_FLUSHES,
                 bags_per_mb=2)
    r = base.shape[1]
    st = seng.stats
    want_lag, when_of = {}, {c_row: 0}
    nb = sc.ledger.n_blocks
    for tb, row, _, when in SCRUB_FLIPS:
        pos = tb * nb + row // SCRUB_BLOCK
        want_lag[tb * r + row] = pos // SCRUB_BUDGET + 1 - when
        when_of[tb * r + row] = when
    want_lag[c_row] = 1                  # slot (0, 0): the first sweep
    bad = {g: (detected.get(g), want_lag[g]) for g in want_lag
           if detected.get(g) is None
           or detected[g] - when_of[g] > want_lag[g]}
    if bad:
        raise AssertionError(f"scrub: flips detected late or never "
                             f"(gid: (flush, predicted lag)) {bad}")
    if st.repaired_rows != len(SCRUB_FLIPS) or not sc.fully_repaired:
        raise AssertionError(f"scrub: repaired {st.repaired_rows} of "
                             f"{len(SCRUB_FLIPS)}, fully repaired "
                             f"{sc.fully_repaired}")
    if sc.cache_invalidations != len(inval) or any(
            int(seng.cache.slot_of[tb, row]) >= 0 for tb, row in inval):
        raise AssertionError(f"scrub: {sc.cache_invalidations} cached "
                             f"copies invalidated, not those of {inval}")
    if recount["n"] != recount["host"] or recount["n"] < 1 or \
            st.quarantined_served != recount["n"]:
        raise AssertionError(f"scrub: quarantined_served "
                             f"{st.quarantined_served}, counted "
                             f"{recount['n']}, host recount "
                             f"{recount['host']}")
    if st.wire_rejects != seng.microbatches:
        raise AssertionError(f"scrub: wire_rejects {st.wire_rejects}, not "
                             f"one a microbatch of flush {SCRUB_WIRE_FLUSH}")
    if calls["scrub"] != calls["clean"]:
        raise AssertionError(f"scrub: collective calls a flush with scrub "
                             f"{calls['scrub']}, without {calls['clean']}")
    if any(o is None or not np.isfinite(o).all() or o.shape != (BATCH,)
           for o in served["scrub"][:SCRUB_PROFILED]
           + served["scrub"][SCRUB_PROFILED + 1:]):
        raise AssertionError("scrub: a flush lost requests or served a "
                             "non-finite CTR")
    settled = max(detected.values()) + 3
    for s in range(settled, SCRUB_FLUSHES):
        if not np.array_equal(served["scrub"][s], served["clean"][s]):
            raise AssertionError(f"scrub: flush {s}, after the repair, "
                                 f"differs from the clean engine's")
    tables = seng.params["tables"]
    for tb, row, _, _ in SCRUB_FLIPS:
        if tables[tb, row].cpu().numpy().tobytes() != \
                sc.mirror[tb, row].tobytes():
            raise AssertionError(f"scrub: row ({tb}, {row}) differs from "
                                 f"the mirror after the repair")
    # a full sweep of the repaired stack against the boot ledger
    blk = np.arange(nb, dtype=np.int64)
    offs = (blk[:, None] * SCRUB_BLOCK + np.arange(SCRUB_BLOCK)[None])
    sweep = []
    offs_d = torch.from_numpy(offs).to(dev)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as sprof:
        for tb in range(t):
            ix = torch.full((nb,), tb, dtype=torch.int64, device=dev)
            sweep.append(integ.fold_blocks(tables, ix, offs_d, ix))
        torch.cuda.synchronize()
    kern = [e for e in sprof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    sweep_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3 \
        if kern else float("nan")
    words = torch.stack(sweep).cpu().numpy()
    if not np.array_equal(words, boot_cs):
        raise AssertionError(f"scrub: a full sweep after the repair differs "
                             f"from the boot ledger in "
                             f"{int((words != boot_cs).sum())} blocks")
    audit_bound = SCRUB_BUDGET * SCRUB_BLOCK * cfg.embed_dim * 4 \
        / HBM_BYTES_PER_S * 1e3
    sweep_bound = stack_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    traced = {k: range_device_us(prof, f"scrub.{k}") for k in (
        "audit", "_dispatch_blocks", "_dispatch_cache", "_harvest",
        "bank_audit", "apply", "next_wire", "ingest", "quarantine_phys",
        "count_quarantined_served", "wire_stamp", "wire_verify")}
    scrub_lat = [x for i, x in enumerate(seng.monitor.lat)
                 if i != SCRUB_PROFILED]
    clean_lat = [x for i, x in enumerate(clean.monitor.lat)
                 if i != SCRUB_PROFILED]
    log(f"[scrub] budget {SCRUB_BUDGET} blocks of {SCRUB_BLOCK} rows ({nb * t:,} "
        f"blocks, a sweep every {-(-nb * t // SCRUB_BUDGET)} flushes) and "
        f"{SCRUB_BUDGET} of {scache.hot_ids.numel():,} cache slots a flush; "
        f"flips {[(tb, row) for tb, row, _, _ in SCRUB_FLIPS]} and the "
        f"cached copy of (0, {c_row}) at flush 0: detected on flushes "
        f"{[detected[g] for g in want_lag]} (predicted lags "
        f"{list(want_lag.values())}), detection_lag_flushes "
        f"{st.detection_lag_flushes}; repaired {st.repaired_rows} from the "
        f"mirror through xrep, cache_invalidations "
        f"{sc.cache_invalidations} (slots of {inval}), quarantined_served "
        f"{st.quarantined_served} (host recount {recount['host']}), "
        f"wire_rejects {st.wire_rejects} (segment flipped at flush "
        f"{SCRUB_WIRE_FLUSH}, one a microbatch), blocks_scrubbed "
        f"{st.blocks_scrubbed}; flushes {settled}..{SCRUB_FLUSHES - 1} "
        f"bit-identical to a clean engine; the repaired rows equal the "
        f"mirror byte for byte; a full sweep equals the boot ledger; "
        f"collective calls a flush with scrub {calls['scrub']}, without "
        f"{calls['clean']}")
    log(f"[scrub] boot: ledger on the card {boot['ledger_ms']} ms "
        f"(CUDA events; host clock {boot['ledger_s'] * 1e3:.3f} ms, the "
        f"shadow and the block words to the host included), mirror copy "
        f"{boot['mirror_s']:.3f} s ({stack_gb:.2f} GB to host memory); "
        f"full sweep's device time {sweep_ms:.3f} ms (trace) against a "
        f"byte bound of "
        f"{sweep_bound:.2f} ms; device time in the profiled flush (from "
        f"the trace): " + ", ".join(
            f"{k} {us:.1f} us ({n} ops)" for k, (us, n) in traced.items())
        + f"; the audit's byte bound {audit_bound:.3f} ms a flush")
    log(f"[scrub] flush p50 {ms(scrub_lat, 0.5):.3f} ms p99 "
        f"{ms(scrub_lat, 0.99):.3f} ms with scrub armed, the same requests "
        f"without p50 {ms(clean_lat, 0.5):.3f} ms p99 "
        f"{ms(clean_lat, 0.99):.3f} ms (flush {SCRUB_PROFILED} left out "
        f"on both sides); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB card={card!r}")
    # host time by call: every scrub flush but the profiled one (the
    # profiler slows the host), the engine's own calls on both engines
    keep = [i for i in range(SCRUB_FLUSHES) if i != SCRUB_PROFILED]

    def per_flush(name, calls_a_flush=1):
        v = host_ms.get(name, [])
        if len(v) != SCRUB_FLUSHES * calls_a_flush:
            return v
        return [x for i, x in enumerate(v)
                if i // calls_a_flush in keep]

    log("[scrub] host ms a flush by call, p50 / max over "
        f"{len(keep)} flushes: " + ", ".join(
            f"{k} {statistics.median(v):.3f} / {max(v):.3f}"
            for k, v in ((k, per_flush(k)) for k in sorted(host_ms)
                         if not k.startswith("scrub.wire_")) if v)
        + f" card={card!r}")
    log("[scrub] host ms of the wire checksum calls, summed a flush "
        "(mono: one stamp and one verify a microbatch): " + ", ".join(
            f"{k} {sum(host_ms.get(k, [])) / SCRUB_FLUSHES:.3f}"
            for k in ("scrub.wire_stamp", "scrub.wire_verify")))
    log_serve("scrub", "scrub bound=2", seng, card)
    del seng, clean, sc, scache
    torch.cuda.empty_cache()
    return launches


def flash_phase(dev):
    """Phase 6: the flash kernel against its plain version at the served
    layer shapes, in bf16, timed warm (q, k, v are written just before it
    on the prefill path).  Returns (row, launch key) pairs."""
    from repro_torch.configs.gemma2_9b import CONFIG as GEMMA
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2MOE
    from repro_torch.configs.qwen3_14b import CONFIG as QWEN
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    b, s = LM_BATCH, LM_PROMPT
    rows = []
    for label, cfg, window, cap in (
            ("gemma2_local", GEMMA, GEMMA.sliding_window,
             GEMMA.attn_logit_softcap),
            ("gemma2_global", GEMMA, 0, GEMMA.attn_logit_softcap),
            ("qwen3_heads", QWEN, 0, QWEN.attn_logit_softcap),
            ("qwen2moe_heads", QWEN2MOE, 0, QWEN2MOE.attn_logit_softcap)):
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = ((torch.randn((b, s, n, hd), generator=gen, device=dev)
                    * scale).to(torch.bfloat16)
                   for n, scale in ((h, FLASH_Q_SCALE), (kh, 1.0), (kh, 1.0)))
        library = None
        if not cap and not window:
            # one PyTorch call computes this layer's function (no softcap):
            # the yardstick, used nowhere in the port
            def library(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True).transpose(1, 2)
        name = f"flash_attention/{label}"
        rows.append((check_kernel(
            name, "src/repro/kernels/flash_attention.py:97",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            lambda: fa.flash_attention(q, k, v, window=window, softcap=cap),
            lambda: ref.flash_attention_ref(q, k, v, window=window,
                                            softcap=cap),
            library, n_bytes=2 * (2 * q.numel() + 2 * k.numel()),
            flops=4 * hd * admitted_pairs(s, window) * b * h, flush=None,
            tol=FLASH_TOL, rel=FLASH_REL, peak_flops=BF16_FLOPS),
            fa.launch_key(h, kh, hd, window)))
        row = rows[-1][0]
        if row["library_ms"] is not None:
            log(f"[kernel] {name}: kernel {row['ms']:.4f} ms beside "
                f"scaled_dot_product_attention {row['library_ms']:.4f} ms in "
                f"this run ({row['ms'] / row['library_ms']:.2f}x)")
        # the check sees each branch: a kernel that dropped the softcap or
        # the window would fail it
        plain = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
        branches = []
        if cap:
            branches.append(("softcap", {"window": window, "softcap": 0.0}))
        if window:
            branches.append(("window", {"window": 0, "softcap": cap}))
        for branch, kw in branches:
            wrong = ref.flash_attention_ref(q, k, v, **kw)
            if torch.allclose(wrong, plain, **FLASH_TOL):
                raise AssertionError(f"{name}: the plain version without the "
                                     f"{branch} passes the check")
            err, fro, _ = errors(wrong, plain, FLASH_TOL["rtol"])
            log(f"[kernel] {name}: the plain version without the {branch} "
                f"fails the check (max_abs_err {err:.3e}, relative "
                f"Frobenius error {fro:.3e})")
            del wrong
        del q, k, v, library, plain
        torch.cuda.empty_cache()
    return rows


def lm_prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(SEED).integers(
        0, vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)


def lm_parity_phase(dev):
    """Phase 7: full-width gemma2-9b in f32, depth cut to 4 layers (one
    local and one global group): prefill through the kernel against the
    plain attention, and one (plain) decode step from each one's cache."""
    from repro_torch.configs.gemma2_9b import CONFIG as GEMMA
    from repro_torch.models import transformer as T

    cfg = GEMMA.replace(n_layers=PARITY_LAYERS, dtype="float32")
    params = T.init_lm(SEED, cfg, dev)
    toks = torch.from_numpy(lm_prompts(cfg.vocab_size)).to(dev)
    out = {}
    for impl in ("auto", "ref"):
        logits, cache = T.prefill(params, cfg, toks, pad_to=LM_PROMPT + 1,
                                  attn_impl=impl)
        nxt = toks[:, -1:]
        step, _ = T.decode_step(params, cfg, nxt, cache)
        out[impl] = (logits, cache, step)
    (la, ca, da), (lr, cr, dr) = out["auto"], out["ref"]
    torch.testing.assert_close(la, lr, **LM_TOL)
    torch.testing.assert_close(ca["k"], cr["k"], **LM_TOL)
    torch.testing.assert_close(ca["v"], cr["v"], **LM_TOL)
    torch.testing.assert_close(da, dr, **LM_TOL)
    errs = [(a - r).abs().max().item() for a, r in
            ((la, lr), (ca["k"], cr["k"]), (ca["v"], cr["v"]), (da, dr))]
    log(f"[lm-parity] gemma2-9b full width, f32, depth cut 42 -> "
        f"{PARITY_LAYERS} layers, B {LM_BATCH} x {LM_PROMPT} tokens: kernel "
        f"vs plain attention max_abs_err prefill logits {errs[0]:.3e}, cache "
        f"k {errs[1]:.3e} v {errs[2]:.3e}, decode logits {errs[3]:.3e} "
        f"(rtol = atol = 1e-4)")
    del params, out, la, ca, da, lr, cr, dr
    torch.cuda.empty_cache()


def profile_device(label, fn, top: int = 8, tag: str = "lm-profile"):
    """Device time by kernel, and the card's share of the wall time, over
    one call of ``fn`` that ends in a synchronise; returns the device time
    by kernel name (empty when the profiler saw none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if not by_name:
        log(f"[{tag}] {label}: the profiler saw no device activity: "
            "device time not measured")
        return by_name
    busy = sum(by_name.values())
    log(f"[{tag}] {label}: wall {wall_us:.0f} us, device activity "
        f"{busy:.0f} us ({100 * busy / wall_us:.1f}% of wall), "
        f"{len(by_name)} kernel names")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[{tag}]   {us:10.1f} us  {name[:90]}")
    return by_name


def served_layers_check(params, cfg, toks):
    """The kernel against its plain version on the q, k and v the served
    model computes for the prompts at the first layer of each kind in its
    pattern (group 0 of each sublayer), at the tolerance of phase 6."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    x = T.embed_inputs(params, cfg, toks)
    positions = torch.arange(toks.shape[1], device=toks.device)[None, :]
    for i, kind in enumerate(T.layer_pattern(cfg)):
        sub = T._map(lambda a: a[0], params["layers"][f"sub{i}"])
        window = cfg.sliding_window if kind == "local" else 0
        h = L.rmsnorm(sub["ln1"], x, cfg.norm_eps, cfg.norm_plus_one)
        q, k, v = A._project_qkv(sub["attn"], cfg, h, positions)
        kw = {"window": window, "softcap": cfg.attn_logit_softcap}
        out = fa.flash_attention(q, k, v, **kw)
        plain = ref.flash_attention_ref(q, k, v, **kw)
        err, fro, need = hold(f"served layer {i} ({kind})", out, plain,
                              FLASH_TOL, FLASH_REL)
        log(f"[lm-layer] {cfg.name} layer {i} ({kind}, {cfg.dtype}, the "
            f"served prompts): kernel vs plain max_abs_err {err:.3e}, relative "
            f"Frobenius error {fro:.3e}, least atol passing at rtol "
            f"{FLASH_TOL['rtol']}: {need:.3e}, median |plain| "
            f"{plain.float().abs().median().item():.3e}")
        del h, q, k, v, out, plain
        x, _, _ = T.block_full(sub, cfg, x, kind)
    del x
    torch.cuda.empty_cache()


def lm_serve_phase(dev, card):
    """Phase 8: full gemma2-9b served by LMEngine; returns each kernel's
    launches on one generate run, and the flash kernel's by launch key."""
    from repro_torch.configs.gemma2_9b import CONFIG as GEMMA
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import LMEngine
    from repro_torch.train import steps as steps_mod

    cfg = GEMMA
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_lm(SEED, cfg, dev)
    torch.cuda.synchronize()
    n_bytes = sum(a.numel() * a.element_size()
                  for a in _leaves(params))
    log(f"[lm-init] gemma2-9b {cfg.n_layers} layers, {cfg.dtype}, "
        f"{n_bytes / 1e9:.3f} GB of weights in "
        f"{time.perf_counter() - t0:.2f} s")
    prompts = lm_prompts(cfg.vocab_size)
    toks = torch.from_numpy(prompts).to(dev)
    served_layers_check(params, cfg, toks)

    prefill_ms = []
    for _ in range(3):
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        if ops.kernels()["flash_attention"].launches != cfg.n_layers:
            raise AssertionError(
                f"prefill launched the flash kernel "
                f"{ops.kernels()['flash_attention'].launches} times, not "
                f"{cfg.n_layers}")
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits not finite")
        del logits, cache
    profile_device("one prefill",
                   lambda: T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN))

    eng = LMEngine(params, cfg, max_len=LM_MAX_LEN, device=dev)
    ops.reset_launches()
    first = eng.generate(prompts, LM_NEW)
    launches = {k: v.launches for k, v in ops.kernels().items()}
    by_key = dict(fa.FLASH.by_key)
    eng.monitor.reset()
    t0 = time.perf_counter()
    second = eng.generate(prompts, LM_NEW)
    gen_s = time.perf_counter() - t0
    if first.shape != (LM_BATCH, LM_NEW):
        raise AssertionError(f"generated shape {first.shape}")
    if not ((first >= 0) & (first < cfg.vocab_size)).all():
        raise AssertionError("generated tokens out of range")
    if not np.array_equal(first, second):
        raise AssertionError("two generate runs differ")
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    want = {fa.launch_key(*heads, cfg.sliding_window): cfg.n_layers // 2,
            fa.launch_key(*heads, 0): cfg.n_layers // 2}
    if launches["flash_attention"] != cfg.n_layers or by_key != want:
        raise AssertionError(f"generate launched {launches}, flash by key "
                             f"{by_key}, not {want}")
    step = steps_mod.make_serve_step(cfg)
    _, cache = T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN)
    last = toks[:, -1:]
    profile_device("one decode step",
                   lambda: step(params, last, cache)[0].cpu())
    del cache
    steps = sorted(eng.monitor.lat)
    warm = prefill_ms[1:]
    log(f"[lm-serve] gemma2-9b B {LM_BATCH} x prompt {LM_PROMPT}, "
        f"{LM_NEW} greedy tokens, cache {LM_MAX_LEN}: prefill ms "
        f"{prefill_ms[0]:.1f} first, {statistics.median(warm):.1f} warm "
        f"({LM_BATCH * LM_PROMPT / statistics.median(warm) * 1e3:.0f} "
        f"prefill tokens/s); decode ms/token p50 "
        f"{eng.monitor.percentile(0.5) * 1e3:.3f} p99 "
        f"{eng.monitor.percentile(0.99) * 1e3:.3f} min "
        f"{steps[0] * 1e3:.3f}; generated tokens/s "
        f"{LM_BATCH * LM_NEW / sum(steps):.1f} (decode steps only), "
        f"generate wall {gen_s * 1e3:.1f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; card {card!r}")
    log(f"[lm-serve] tokens identical across two runs; first row "
        f"{first[0].tolist()}; launches per generate {launches}; flash "
        f"launches by (H, Kh, hd, window) {by_key}")
    log(f"[lm-serve] decode weight-read bound {n_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms/token ({n_bytes / 1e9:.3f} GB at 3.35 TB/s)")
    return launches, by_key


def wkv_inputs(b, s, gen, dev, *, regime="default"):
    """Seeded WKV inputs at H 32, K = V = 64: r, k, v ~ N(0,1); logw =
    -exp(N(0,1)) (default), -exp(N(-4,1)) (long memory) or -50 (each
    token's state dies at the next); u ~ 0.5 N(0,1); state0 ~ 0.1 N(0,1)."""
    h, kk = WKV_HEADS, 64
    r, k, v = (torch.randn((b, s, h, kk), generator=gen, device=dev)
               for _ in range(3))
    if regime == "extreme":
        logw = torch.full((b, s, h, kk), -50.0, device=dev)
    else:
        mean = -4.0 if regime == "long" else 0.0
        logw = -torch.exp(torch.randn((b, s, h, kk), generator=gen,
                                      device=dev) + mean)
    u = 0.5 * torch.randn((h, kk), generator=gen, device=dev)
    s0 = 0.1 * torch.randn((b, h, kk, kk), generator=gen, device=dev)
    return r, k, v, logw, u, s0


def hold_wkv(name, got, plain):
    """Fail unless out and the final state are within ``WKV_TOL`` and
    ``WKV_REL`` of the plain version's; returns the errors of each."""
    return [hold(f"{name} {part}", g, p, WKV_TOL, WKV_REL)
            for part, g, p in zip(("out", "state"), got, plain)]


def wkv_phase(dev):
    """Phase 9: the WKV kernel against its plain chunked version at the
    served prefill shape and at B 8 x S 4096, timed warm (r, k, v and logw
    are written just before it on the prefill path); the plain version at
    S 32768 walks 1,024 chunks from Python, so it is timed over 3 runs.
    Returns (row, launch key) pairs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wk

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = []
    for label, b, s in WKV_SHAPES:
        x = wkv_inputs(b, s, gen, dev)
        out = wk.rwkv6_wkv(*x)
        again = wk.rwkv6_wkv(*x)
        plain = ref.rwkv6_wkv_chunked_ref(*x)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(out, again)):
            raise AssertionError(f"rwkv6_wkv/{label}: two kernel runs differ")
        (err, fro, need), (s_err, s_fro, _) = hold_wkv(
            f"rwkv6_wkv/{label}", out, plain)
        name = f"rwkv6_wkv/{label}"
        log(f"[kernel] {name}: out max_abs_err {err:.3e}, relative Frobenius "
            f"error {fro:.3e}, least atol passing at rtol {WKV_TOL['rtol']}: "
            f"{need:.3e}, median |plain| "
            f"{plain[0].abs().median().item():.3e}, max |plain| "
            f"{plain[0].abs().max().item():.3e}; final state max_abs_err "
            f"{s_err:.3e}, relative Frobenius error {s_fro:.3e}")
        # the check sees the bonus and the carried-in state: a kernel that
        # dropped either would fail it
        controls = (
            ("u bonus", ref.rwkv6_wkv_chunked_ref(*x[:4], torch.zeros_like(
                x[4]), x[5])),
            ("state0", ref.rwkv6_wkv_chunked_ref(*x[:5], torch.zeros_like(
                x[5]))))
        for branch, wrong in controls:
            passes = all(torch.allclose(w, p, **WKV_TOL)
                         for w, p in zip(wrong, plain))
            errs = [errors(w, p, WKV_TOL["rtol"])[:2]
                    for w, p in zip(wrong, plain)]
            if passes and all(e[1] <= WKV_REL for e in errs):
                raise AssertionError(f"{name}: the plain version without the "
                                     f"{branch} passes the check")
            log(f"[kernel] {name}: the plain version without the {branch} "
                f"fails the check (out max_abs_err {errs[0][0]:.3e}, "
                f"relative Frobenius error {errs[0][1]:.3e}; state "
                f"{errs[1][0]:.3e}, {errs[1][1]:.3e})")
        del controls
        n_bytes = 5 * x[0].numel() * 4 + x[4].numel() * 4 \
            + 2 * x[5].numel() * 4
        flops = 4 * 64 * 64 * b * s * WKV_HEADS
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
               "replaces": "src/repro/kernels/rwkv6_wkv.py:94",
               "launches": 0, "max_abs_err": max(err, s_err),
               "ms": time_ms(lambda: wk.rwkv6_wkv(*x)),
               "plain_ms": time_ms(lambda: ref.rwkv6_wkv_chunked_ref(*x),
                                   reps=3, warmup=1),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None}
        log(f"[kernel] {name}: max_abs_err={row['max_abs_err']:.3e} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms=None (no PyTorch call computes WKV-6) "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
        rows.append((row, wk.launch_key(b, s, WKV_HEADS)))
        # the two passes alone, on the chunk-start states one run wrote
        args = wk.check_args(*x)
        bufs = wk.run_passes(*args)
        p1, p2 = (time_ms(lambda n=n: wk.run_passes(*args, passes=n,
                                                    buffers=bufs))
                  for n in (wk.STATE_PASS, wk.OUTPUT_PASS))
        scratch = bufs[2].numel() * bufs[2].element_size()
        log(f"[kernel] {name}: scratch of chunk-start states {scratch} bytes "
            f"({scratch / 1e6:.1f} MB); state pass {p1:.4f} ms, output pass "
            f"{p2:.4f} ms, each timed alone")
        del x, out, again, plain, args, bufs
        torch.cuda.empty_cache()

    # two more decay regimes at the B 8 x S 4096 shape
    _, b, s = WKV_SHAPES[1]
    for regime in ("long", "extreme"):
        x = wkv_inputs(b, s, gen, dev, regime=regime)
        out = wk.rwkv6_wkv(*x)
        if not torch.isfinite(out[0]).all():
            raise AssertionError(f"rwkv6_wkv {regime} decay: not finite")
        (err, fro, need), (s_err, s_fro, _) = hold_wkv(
            f"rwkv6_wkv {regime} decay", out, ref.rwkv6_wkv_chunked_ref(*x))
        log(f"[kernel] rwkv6_wkv/b8_s4096 {regime} decay: out max_abs_err "
            f"{err:.3e}, relative Frobenius error {fro:.3e}, least atol "
            f"{need:.3e}; state max_abs_err {s_err:.3e}, relative Frobenius "
            f"error {s_fro:.3e}")
        del x, out
    torch.cuda.empty_cache()
    return rows


def rwkv_prompt(vocab: int, b: int, s: int, seed: int = SEED) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def rwkv_parity_phase(dev):
    """Phase 10: full-width rwkv6-1.6b in f32 (6.3 GB of weights) on 4096
    tokens.  f32 rounding differences grow layer by layer through this
    random model, whichever exact WKV evaluator makes them, so
    the 1e-4 checks run on the first RWKV_PARITY_LAYERS layers (kernel vs
    plain WKV; 128 decoded tokens vs the forward) and the full 24 layers are
    held against the spread between the reference's own two exact
    evaluators (the plain chunked forward vs token-by-token decode)."""
    from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV
    from repro_torch.models import rwkv6 as R
    from repro_torch.models import transformer as T

    full = RWKV.replace(dtype="float32")
    params = R.init_rwkv6(SEED, full, dev)
    toks = torch.from_numpy(rwkv_prompt(full.vocab_size, 1,
                                        RWKV_PARITY_LEN)).to(dev)
    for cfg in (full.replace(n_layers=RWKV_PARITY_LAYERS), full):
        n = cfg.n_layers
        p = dict(params, layers=T._map(lambda a: a[:n], params["layers"]))
        la, _, sa = R.forward(p, cfg, toks, collect_cache=True)
        lr, _, sr = R.forward(p, cfg, toks, collect_cache=True,
                              wkv_impl="ref")
        st = R.make_state(cfg, 1, device=dev)
        outs = []
        for t in range(RWKV_DECODE_CHECK):
            lg, st = R.decode_step(p, cfg, toks[:, t:t + 1], st)
            outs.append(lg)
        dec = torch.cat(outs, 1)
        head = la[:, :RWKV_DECODE_CHECK]
        errs = {"logits": errors(la, lr, 0.0)[:2]}
        errs.update({key: errors(sa[key], sr[key], 0.0)[:2]
                     for key in ("tm_shift", "cm_shift", "wkv")})
        d_kernel = errors(head, dec, 0.0)[:2]
        d_plain = errors(lr[:, :RWKV_DECODE_CHECK], dec, 0.0)[:2]
        if n == RWKV_PARITY_LAYERS:
            torch.testing.assert_close(la, lr, **LM_TOL)
            for key in ("tm_shift", "cm_shift", "wkv"):
                torch.testing.assert_close(sa[key], sr[key], **LM_TOL)
            torch.testing.assert_close(head, dec, **RWKV_DECODE_TOL)
            held = "rtol = atol = 1e-4; decode atol 2e-3"
        else:
            limit = min(RWKV_DEPTH_REL, RWKV_DEPTH_SHARE * d_plain[1])
            if errs["logits"][1] > limit or errs["wkv"][1] > RWKV_DEPTH_REL:
                raise AssertionError(
                    f"rwkv6 {n} layers: kernel vs plain WKV relative "
                    f"Frobenius error logits {errs['logits'][1]:.3e}, wkv "
                    f"state {errs['wkv'][1]:.3e}, over {limit:.3e}")
            held = (f"relative Frobenius error of logits and wkv states "
                    f"under {RWKV_DEPTH_REL}, and of logits under "
                    f"{RWKV_DEPTH_SHARE} x the plain forward's vs decode")
        log(f"[rwkv-parity] rwkv6-1.6b full width, {n} layers, f32, B 1 x "
            f"{RWKV_PARITY_LEN} tokens: kernel vs plain WKV (max_abs_err, "
            f"relative Frobenius) logits {errs['logits'][0]:.3e}, "
            f"{errs['logits'][1]:.3e}; states tm_shift "
            f"{errs['tm_shift'][0]:.3e}, cm_shift {errs['cm_shift'][0]:.3e}, "
            f"wkv {errs['wkv'][0]:.3e}, {errs['wkv'][1]:.3e}; first "
            f"{RWKV_DECODE_CHECK} tokens decoded one at a time vs the "
            f"forward: kernel path {d_kernel[0]:.3e}, {d_kernel[1]:.3e}, "
            f"plain path {d_plain[0]:.3e}, {d_plain[1]:.3e}; max |logit| "
            f"{la.abs().max().item():.3e}; held: {held}")
        del la, lr, sa, sr, dec, outs, st, head
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def device_split(by_name) -> dict:
    """Device time (us) of one profiled call, split into matrix products,
    the WKV kernel (its state and output passes) and everything else
    (elementwise, copies, reductions)."""
    out = {"gemm": 0.0, "wkv": 0.0, "other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        if "wkv_state_pass" in low or "wkv_output_pass" in low:
            out["wkv"] += us
        elif any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma",
                                    "sm90_")):
            out["gemm"] += us
        else:
            out["other"] += us
    return out


def rwkv_serve_phase(dev, card):
    """Phase 11: full rwkv6-1.6b in bf16: prefill steps of one 32768-token
    prompt, then LMEngine; returns the WKV kernel's launches by key on one
    served prefill."""
    from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wk
    from repro_torch.models import api
    from repro_torch.serving.engine import LMEngine
    from repro_torch.train import steps as steps_mod

    cfg = RWKV
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(SEED, cfg, dev)
    torch.cuda.synchronize()
    n_bytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    log(f"[rwkv-init] rwkv6-1.6b {cfg.n_layers} layers, {cfg.dtype}, "
        f"{n_bytes / 1e9:.3f} GB of weights in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = {"tokens": torch.from_numpy(
        rwkv_prompt(cfg.vocab_size, 1, RWKV_PROMPT)).to(dev)}
    step = steps_mod.make_prefill_step(cfg)
    prefill_ms, by_key = [], None
    for _ in range(3):
        ops.reset_launches()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        by_key = dict(wk.WKV.by_key)
        want = {wk.launch_key(1, RWKV_PROMPT, WKV_HEADS): cfg.n_layers}
        if wk.WKV.launches != cfg.n_layers or by_key != want:
            raise AssertionError(f"prefill launched the WKV kernel "
                                 f"{wk.WKV.launches} times ({by_key}), not "
                                 f"{want}")
        if logits.shape != (1, 1, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                                 "finite or of the wrong shape")
        del logits
    prefill_peak = torch.cuda.max_memory_allocated()
    split = device_split(profile_device(
        "one rwkv6-1.6b prefill", lambda: step(params, batch),
        tag="rwkv-profile"))
    log(f"[rwkv-profile] device time by kind (us): matrix products "
        f"{split['gemm']:.1f}, WKV kernel {split['wkv']:.1f}, other "
        f"{split['other']:.1f}")

    prompts = rwkv_prompt(cfg.vocab_size, RWKV_GEN_BATCH, RWKV_GEN_PROMPT,
                          SEED + 1)
    eng = LMEngine(params, cfg, max_len=RWKV_GEN_PROMPT + RWKV_NEW,
                   device=dev)
    ops.reset_launches()
    first = eng.generate(prompts, RWKV_NEW)
    gen_launches = {k: v.launches for k, v in ops.kernels().items()}
    eng.monitor.reset()
    t0 = time.perf_counter()
    second = eng.generate(prompts, RWKV_NEW)
    gen_s = time.perf_counter() - t0
    if first.shape != (RWKV_GEN_BATCH, RWKV_NEW):
        raise AssertionError(f"generated shape {first.shape}")
    if not ((first >= 0) & (first < cfg.vocab_size)).all():
        raise AssertionError("generated tokens out of range")
    if not np.array_equal(first, second):
        raise AssertionError("two generate runs differ")
    if any(gen_launches.values()):
        raise AssertionError(f"recurrent decode launched {gen_launches}: it "
                             "runs the plain recurrence, as the reference")
    serve = steps_mod.make_serve_step(cfg)
    state = api.make_cache(cfg, RWKV_GEN_BATCH, 0, device=dev)
    last = torch.from_numpy(prompts[:, -1:]).to(dev)
    profile_device("one rwkv6-1.6b decode step",
                   lambda: serve(params, last, state)[0].cpu(),
                   tag="rwkv-profile")
    steps = sorted(eng.monitor.lat)
    warm = statistics.median(prefill_ms[1:])
    log(f"[rwkv-serve] rwkv6-1.6b bf16 prefill of 1 x {RWKV_PROMPT} tokens "
        f"(make_prefill_step): ms {prefill_ms[0]:.1f} first, {warm:.1f} warm "
        f"({RWKV_PROMPT / warm * 1e3:.0f} prefill tokens/s), "
        f"{cfg.n_layers} WKV launches each, max_memory_allocated "
        f"{prefill_peak / 1e9:.3f} GB; card {card!r}")
    log(f"[rwkv-serve] LMEngine B {RWKV_GEN_BATCH} x prompt "
        f"{RWKV_GEN_PROMPT} (fed token by token), {RWKV_NEW} greedy tokens: "
        f"decode ms/token p50 {eng.monitor.percentile(0.5) * 1e3:.3f} p99 "
        f"{eng.monitor.percentile(0.99) * 1e3:.3f} min {steps[0] * 1e3:.3f}; "
        f"generated tokens/s {RWKV_GEN_BATCH * RWKV_NEW / sum(steps):.1f} "
        f"(decode steps only), generate wall {gen_s * 1e3:.1f} ms (prompt "
        f"{(gen_s - sum(steps)) * 1e3:.1f} ms); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log(f"[rwkv-serve] tokens identical across two runs; first row "
        f"{first[0].tolist()}; kernel launches per generate {gen_launches}")
    log(f"[rwkv-serve] decode weight-read bound "
        f"{n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/token ({n_bytes / 1e9:.3f} "
        f"GB at 3.35 TB/s)")
    return by_key


def moe_ffn_inputs(params, cfg, toks):
    """Each layer's parameters and the input its MoE FFN takes for
    ``toks``, layer by layer, as ``transformer.block_full`` computes them
    (qwen2-moe: one global sublayer a group, no post norms)."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    x = T.embed_inputs(params, cfg, toks)
    for gi in range(T.n_groups(cfg)):
        sub = T._map(lambda a: a[gi], params["layers"]["sub0"])
        h = L.rmsnorm(sub["ln1"], x, cfg.norm_eps)
        x = x + A.attend_full(sub["attn"], cfg, h)[0]
        h = L.rmsnorm(sub["ln2"], x, cfg.norm_eps)
        yield sub, h
        x = x + T._ffn(sub["ffn"], cfg, h)[0]


def moe_drops(ffn, cfg, h, factor: float) -> int:
    """(token, expert) slots the local dispatch drops at capacity factor
    ``factor``, counted from ``route`` and ``dispatch_indices``."""
    from repro_torch.models import moe as M

    e_pad = ffn["gate"].shape[0]
    xl = h.reshape(-1, cfg.d_model)
    cap = M.capacity(xl.shape[0], cfg.moe.experts_per_token, e_pad, factor)
    _, idx, _ = M.route(ffn["router"], xl, cfg.moe, e_pad)
    return int((~M.dispatch_indices(idx, e_pad, cap)[3]).sum())


def moe_parity_phase(dev):
    """Phase 12: full-width qwen2-moe-a2.7b in f32, depth cut to
    MOE_PARITY_LAYERS: prefill of the LM prompts through the flash kernel
    against the plain attention and one decode step from each cache
    (rtol = atol = 1e-4); layer 0's MoE FFN through the local gather mode
    at capacity factor MOE_DENSE_CF (nothing dropped) against
    ``moe_ref_dense``; the slots the config's capacity factor drops, layer
    by layer."""
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2MOE
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = QWEN2MOE.replace(n_layers=MOE_PARITY_LAYERS, dtype="float32")
    params = T.init_lm(SEED, cfg, dev)
    toks = torch.from_numpy(lm_prompts(cfg.vocab_size)).to(dev)
    out = {}
    for impl in ("auto", "ref"):
        logits, cache = T.prefill(params, cfg, toks, pad_to=LM_PROMPT + 1,
                                  attn_impl=impl)
        step, _ = T.decode_step(params, cfg, toks[:, -1:], cache)
        out[impl] = (logits, cache, step)
    (la, ca, da), (lr, cr, dr) = out["auto"], out["ref"]
    pairs = ((la, lr), (ca["k"], cr["k"]), (ca["v"], cr["v"]), (da, dr))
    for a, r in pairs:
        torch.testing.assert_close(a, r, **LM_TOL)
    errs = [(a - r).abs().max().item() for a, r in pairs]
    del out, la, ca, da, lr, cr, dr, pairs
    torch.cuda.empty_cache()
    log(f"[moe-parity] qwen2-moe-a2.7b full width, f32, depth cut "
        f"{QWEN2MOE.n_layers} -> {MOE_PARITY_LAYERS} layers, B {LM_BATCH} x "
        f"{LM_PROMPT} tokens: kernel vs plain attention max_abs_err prefill "
        f"logits {errs[0]:.3e}, cache k {errs[1]:.3e} v {errs[2]:.3e}, "
        f"decode logits {errs[3]:.3e} (rtol = atol = 1e-4)")
    big = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              capacity_factor=MOE_DENSE_CF))
    t = LM_BATCH * LM_PROMPT
    e_pad = params["layers"]["sub0"]["ffn"]["gate"].shape[1]
    drops = []
    for i, (sub, h) in enumerate(moe_ffn_inputs(params, cfg, toks)):
        drops.append(moe_drops(sub["ffn"], cfg, h, cfg.moe.capacity_factor))
        if i:
            continue
        if moe_drops(sub["ffn"], big, h, MOE_DENSE_CF):
            raise AssertionError(f"capacity factor {MOE_DENSE_CF} drops "
                                 "slots")
        got, aux = M.moe_gather(sub["ffn"], big, h)
        want, aux_d = M.moe_ref_dense(sub["ffn"], cfg, h)
        torch.testing.assert_close(got, want, **LM_TOL)
        torch.testing.assert_close(aux, aux_d, **LM_TOL)
        log(f"[moe-parity] layer 0 MoE FFN on the prompts' hidden states "
            f"({t} tokens): moe_gather (local) at capacity factor "
            f"{MOE_DENSE_CF} (0 slots dropped) vs moe_ref_dense max_abs_err "
            f"{(got - want).abs().max().item():.3e}, aux loss "
            f"{aux.item():.6f} (rtol = atol = 1e-4)")
        del got, want
    log(f"[moe-parity] slots dropped at the config's capacity factor "
        f"{cfg.moe.capacity_factor} (capacity "
        f"{M.capacity(t, cfg.moe.experts_per_token, e_pad, cfg.moe.capacity_factor)} "
        f"a routed expert, {t * cfg.moe.experts_per_token} slots a layer), "
        f"by layer: {drops}")
    del params, sub, h
    torch.cuda.empty_cache()


def moe_ep_phase(ffn, cfg, h, card):
    """Phase 13b, on a one-rank NCCL group: the served model's layer-0 MoE
    FFN at the served prefill tokens in bf16 through ``moe_gather(group)``
    and ``moe_a2a(group)`` against the local ``moe_gather`` (MOE_EP_TOL),
    the collective calls of each forward, and the a2a stages over
    MOE_MICROBATCHES microbatches under ``bls_pipeline`` at bounds 0, 1, 2,
    each bit-identical to ``reference_loop``."""
    import torch.distributed as dist

    from repro_torch.core import bls
    from repro_torch.models import moe as M

    group = dist.group.WORLD
    local, _ = M.moe_gather(ffn, cfg, h)
    with count_collectives() as c_gather:
        g, _ = M.moe_gather(ffn, cfg, h, group)
    with count_collectives() as c_a2a:
        a, _ = M.moe_a2a(ffn, cfg, h, group)
    torch.cuda.synchronize()
    errs = {}
    for name, got in (("gather", g), ("a2a", a)):
        torch.testing.assert_close(got, local, **MOE_EP_TOL)
        errs[name] = ((got.float() - local.float()).abs().max().item(),
                      torch.equal(got, local))
    log(f"[moe-ep] qwen2-moe-a2.7b layer 0 FFN, {h.shape[0] * h.shape[1]} "
        f"tokens, bf16, one-rank NCCL group: moe_gather(group) vs local "
        f"max_abs_err {errs['gather'][0]:.3e} (bit-identical "
        f"{errs['gather'][1]}), moe_a2a(group) {errs['a2a'][0]:.3e} "
        f"(bit-identical {errs['a2a'][1]}) (rtol = atol = "
        f"{MOE_EP_TOL['atol']}); collective calls a forward: gather "
        f"{c_gather}, a2a {c_a2a}")
    if c_gather["all_reduce"] != 1 or c_a2a["all_to_all_single"] != 3:
        raise AssertionError(f"collective calls: gather {c_gather}, a2a "
                             f"{c_a2a}")
    del g, a, local
    moe, d = cfg.moe, cfg.d_model
    e_pad = ffn["gate"].shape[0]
    mbs = list(h.reshape(-1, d).chunk(MOE_MICROBATCHES))
    c_send, c_exp = M.a2a_capacities(mbs[0].shape[0], moe, 1, e_pad)
    experts = M._local_experts(ffn, 0, e_pad)

    def stage_a(xl):
        return M.a2a_stage_a(ffn["router"], xl, moe, e_pad, 1, c_send)

    def collective(payload):
        return M.a2a_dispatch(payload, group)

    def stage_b(recv, side):
        return M.a2a_stage_b(experts, cfg.act, recv, side, group, c_exp)

    with count_collectives() as c_loop:
        ref = bls.reference_loop(stage_a, collective, stage_b, mbs)
    for k in MOE_BOUNDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, stats = bls.bls_pipeline(stage_a, collective, stage_b, mbs, k)
        torch.cuda.synchronize()
        ms_k = (time.perf_counter() - t0) * 1e3
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"the a2a stages under bound {k} differ from "
                                 "reference_loop")
        log(f"[moe-ep] bls_pipeline bound {k} over {len(mbs)} microbatches "
            f"of {mbs[0].shape[0]} tokens (c_send {c_send}, c_exp {c_exp}): "
            f"bit-identical to reference_loop; ring bytes "
            f"{stats.ring_bytes}, wall {ms_k:.3f} ms")
    log(f"[moe-ep] reference_loop collective calls {c_loop}; card {card!r}")
    del ref, got


RANGES = ("moe.dispatch", "moe.experts")


def moe_profile(label, fn):
    """One call of ``fn`` under the profiler, with ``_moe_local`` and
    ``_expert_mlp`` inside ranges: device time split into the flash
    kernel, the expert GEMMs, the MoE dispatch (route, sort, scatter,
    gather, combine) and the rest, and the card's active share."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)

    from repro_torch.models import moe as M

    local, experts = M._moe_local, M._expert_mlp

    def ranged(name, fn_):
        def call(*a, **kw):
            with record_function(name):
                return fn_(*a, **kw)
        return call

    M._moe_local = ranged(RANGES[0], local)
    M._expert_mlp = ranged(RANGES[1], experts)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        M._moe_local, M._expert_mlp = local, experts
    by_name: dict = {}
    for e in prof.events():
        # the ranges' own spans on the device are annotations, not work
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.name not in RANGES:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if not by_name:
        log(f"[moe-profile] {label}: the profiler saw no device activity: "
            "device time not measured")
        return
    busy = sum(by_name.values())
    flash = sum(us for n, us in by_name.items() if "flash_" in n)
    moe_us, moe_n = range_device_us(prof, RANGES[0])
    exp_us, exp_n = range_device_us(prof, RANGES[1])
    log(f"[moe-profile] {label}: wall {wall_us:.0f} us, device activity "
        f"{busy:.0f} us ({100 * busy / wall_us:.1f}% of wall); flash "
        f"{flash:.1f} us, expert GEMMs {exp_us:.1f} us ({exp_n} ops), "
        f"dispatch (route, sort, scatter, gather, combine) "
        f"{moe_us - exp_us:.1f} us ({moe_n - exp_n} ops), the rest "
        f"{busy - flash - moe_us:.1f} us")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[moe-profile]   {us:10.1f} us  {name[:90]}")


def prefill_flops(cfg, b: int, s: int, e_pad: int) -> int:
    """Multiply-add flops (x2) of one served prefill as the path computes
    it: q/k/v/o projections, causal attention (4 hd a pair), router,
    capacity-padded routed experts (every one of e_pad x capacity slots),
    shared experts and gate, the LM head on the last positions."""
    from repro_torch.models import moe as M

    d, hd, h = cfg.d_model, cfg.head_dim, cfg.n_heads
    t = b * s
    cap = M.capacity(t, cfg.moe.experts_per_token, e_pad,
                     cfg.moe.capacity_factor)
    fs = cfg.moe.n_shared_experts * cfg.moe.d_shared_expert
    per_layer = (2 * t * d * (2 * h * hd + 2 * cfg.n_kv_heads * hd)
                 + 4 * hd * admitted_pairs(s, 0) * b * h
                 + 2 * t * d * e_pad
                 + 6 * e_pad * cap * d * cfg.moe.d_expert
                 + 6 * t * d * fs + 2 * t * d)
    return cfg.n_layers * per_layer + 2 * b * d * cfg.vocab_size


def moe_serve_phase(dev, card):
    """Phase 13: full qwen2-moe-a2.7b (24 layers, bf16) served by LMEngine;
    returns the flash kernel's launches by key on one generate run."""
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2MOE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import LMEngine
    from repro_torch.train import steps as steps_mod

    cfg = QWEN2MOE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_lm(SEED, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    ffn = params["layers"]["sub0"]["ffn"]
    expert_bytes = sum(ffn[k].numel() * ffn[k].element_size()   # all layers
                       for k in ("gate", "up", "down"))
    e_pad = ffn["gate"].shape[1]
    log(f"[moe-init] qwen2-moe-a2.7b {cfg.n_layers} layers, {cfg.dtype}, "
        f"{e_pad} routed experts ({cfg.moe.n_experts} + "
        f"{e_pad - cfg.moe.n_experts} phantoms), {n_bytes / 1e9:.3f} GB of "
        f"weights ({expert_bytes / 1e9:.3f} GB routed experts) in "
        f"{init_s:.2f} s")
    prompts = lm_prompts(cfg.vocab_size)
    toks = torch.from_numpy(prompts).to(dev)
    served_layers_check(params, cfg, toks)
    sub, h = next(moe_ffn_inputs(params, cfg, toks))
    with model_group("nccl"):
        moe_ep_phase(sub["ffn"], cfg, h, card)
    del sub, h
    torch.cuda.empty_cache()

    prefill_ms = []
    for _ in range(3):
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        if ops.kernels()["flash_attention"].launches != cfg.n_layers:
            raise AssertionError(
                f"prefill launched the flash kernel "
                f"{ops.kernels()['flash_attention'].launches} times, not "
                f"{cfg.n_layers}")
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits not finite")
        del logits, cache
    prefill_peak = torch.cuda.max_memory_allocated()
    moe_profile("one prefill",
                lambda: T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN))

    eng = LMEngine(params, cfg, max_len=LM_MAX_LEN, device=dev)
    ops.reset_launches()
    first = eng.generate(prompts, LM_NEW)
    launches = {k: v.launches for k, v in ops.kernels().items()}
    by_key = dict(fa.FLASH.by_key)
    eng.monitor.reset()
    t0 = time.perf_counter()
    second = eng.generate(prompts, LM_NEW)
    gen_s = time.perf_counter() - t0
    if first.shape != (LM_BATCH, LM_NEW):
        raise AssertionError(f"generated shape {first.shape}")
    if not ((first >= 0) & (first < cfg.vocab_size)).all():
        raise AssertionError("generated tokens out of range")
    if not np.array_equal(first, second):
        raise AssertionError("two generate runs differ")
    want = {fa.launch_key(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0):
            cfg.n_layers}
    if launches["flash_attention"] != cfg.n_layers or by_key != want:
        raise AssertionError(f"generate launched {launches}, flash by key "
                             f"{by_key}, not {want}")
    step = steps_mod.make_serve_step(cfg)
    _, cache = T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN)
    last = toks[:, -1:]
    moe_profile("one decode step",
                lambda: step(params, last, cache)[0].cpu())
    del cache
    steps = sorted(eng.monitor.lat)
    warm = statistics.median(prefill_ms[1:])
    flops = prefill_flops(cfg, LM_BATCH, LM_PROMPT, e_pad)
    head = params["head"]["kernel"]
    read = n_bytes - params["embed"]["table"].numel() * \
        params["embed"]["table"].element_size()
    log(f"[moe-serve] qwen2-moe-a2.7b B {LM_BATCH} x prompt {LM_PROMPT}, "
        f"{LM_NEW} greedy tokens, cache {LM_MAX_LEN}: prefill ms "
        f"{prefill_ms[0]:.1f} first, {warm:.1f} warm "
        f"({LM_BATCH * LM_PROMPT / warm * 1e3:.0f} prefill tokens/s), "
        f"max_memory_allocated {prefill_peak / 1e9:.3f} GB; decode ms/token "
        f"p50 {eng.monitor.percentile(0.5) * 1e3:.3f} p99 "
        f"{eng.monitor.percentile(0.99) * 1e3:.3f} min {steps[0] * 1e3:.3f}; "
        f"generated tokens/s {LM_BATCH * LM_NEW / sum(steps):.1f} (decode "
        f"steps only), generate wall {gen_s * 1e3:.1f} ms; card {card!r}")
    log(f"[moe-serve] tokens identical across two runs; first row "
        f"{first[0].tolist()}; launches per generate {launches}; flash "
        f"launches by (H, Kh, hd, window) {by_key}")
    log(f"[moe-serve] prefill bound {flops / BF16_FLOPS * 1e3:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP at 989 TFLOP/s; weights "
        f"{read / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s); decode "
        f"weight-read bound {read / HBM_BYTES_PER_S * 1e3:.3f} ms/token "
        f"({read / 1e9:.3f} GB read a step: every padded expert's "
        f"{expert_bytes / 1e9:.3f} GB, "
        f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, the "
        f"head's {head.numel() * head.element_size() / 1e9:.3f} GB, "
        f"attention and shared experts)")
    del params
    torch.cuda.empty_cache()
    return by_key


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
    build_report(logs)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = init_dlrm(SEED, CONFIG, n_shards=1, device=dev)
    torch.cuda.synchronize()
    log(f"[init] dlrm-kaggle tables {tuple(params['tables'].shape)} in "
        f"{time.perf_counter() - t0:.2f} s")

    l2 = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        dlrm_rows = kernel_phase(params, CONFIG, dev, l2.zero_)
        del l2
        dlrm_edge_phase(dev)
        with model_group("nccl"):
            dlrm_by_key, ctr5 = serve_phase(params, CONFIG, dev, card)
            ragged_row, cache = ragged_phase(params, CONFIG, dev, card)
            plans_chaos_phase(params, CONFIG, dev, card)
            frontend_fresh_phase(params, CONFIG, dev, card, cache)
            by_key_5e = reshard_scrub_phase(params, CONFIG, dev, card,
                                            cache, ctr5)
            del cache
        # each DLRM row takes the served launches of its own shape: the
        # served path pools and interacts 128 samples a launch, once per
        # microbatch, so the two served rows must read N_BATCHES x 4 on
        # phase 5's run and the 512-sample rows, the rows form and the
        # single table read 0; phase 5e's launches (placement, reshard and
        # scrub engines) are added to each row of their shape
        rows = []
        for row, key in dlrm_rows:
            kern = row["name"].split("/")[0]
            row["launches"] = dlrm_by_key[kern].get(key, 0)
            if row["name"] in SERVED_ROWS and row["launches"] != \
                    N_BATCHES * BATCH // SERVED_MB:
                raise AssertionError(
                    f"{row['name']} read {row['launches']} launches on the "
                    f"served run, not {N_BATCHES} batches x "
                    f"{BATCH // SERVED_MB} microbatches")
            row["launches"] += by_key_5e.get(kern, {}).get(key, 0)
            rows.append(row)
        rows.append(ragged_row)
        log(f"[reshard] phase 5e launches by shape {by_key_5e}")
        # the LM phases need the card's memory: drop the 7.33 GB stack
        del params
        torch.cuda.empty_cache()
        flash_rows = flash_phase(dev)
        lm_parity_phase(dev)
        _, by_key = lm_serve_phase(dev, card)
        # the rwkv6 phases need the card's memory: gemma2-9b went with
        # lm_serve_phase's frame
        torch.cuda.empty_cache()
        wkv_rows = wkv_phase(dev)
        rwkv_parity_phase(dev)
        wkv_by_key = rwkv_serve_phase(dev, card)
        # the qwen2-moe phases need the card's memory: rwkv6-1.6b went with
        # rwkv_serve_phase's frame
        torch.cuda.empty_cache()
        moe_parity_phase(dev)
        moe_by_key = moe_serve_phase(dev, card)
    # each flash or WKV row takes the served launches of its own shape:
    # qwen3's heads and the B 8 WKV shape are timed but not served, so
    # their rows read 0
    for row, key in flash_rows:
        row["launches"] = by_key.get(key, 0) + moe_by_key.get(key, 0)
        rows.append(row)
    for row, key in wkv_rows:
        row["launches"] = wkv_by_key.get(key, 0)
        rows.append(row)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
