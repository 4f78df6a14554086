#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each on lines of its own:
  1. the card's identity and the float32 matmul settings (TF32 off);
  2. the CUDA kernels built from ``src/repro_torch/kernels/csrc`` with nvcc
     into ``build/kernels/`` (one nvcc per source, all at once), and one
     line per kernel of registers and stack/spill bytes from ptxas, with
     the dynamic shared memory of the wgmma flash bodies (and their key
     tile and K/V stages: ``flash_wgmma_ws`` at hd 64 and 80,
     ``flash_wgmma`` at 128 and 256) and of the two WKV passes; neither
     wgmma body may spill;
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
 14. after freeing qwen2-moe-a2.7b, the flash kernel held against its plain
     version (bf16, as in 6, two runs bit-identical) at the new served
     shapes: chatglm3-6b's heads (H 32 over Kh 2, 16 query heads a KV
     head), llava-next-mistral-7b's (32 over 8) and qwen2-72b's (64 over
     8), hd 128, causal, B 2 x S 4608; whisper-tiny's encoder (H = Kh = 6,
     hd 64, S 1536, not causal: the plain version with the causal mask must
     fail the check) and decoder (S 64, causal), each beside
     scaled_dot_product_attention; and whisper's heads at S 1500 (a ragged
     last query tile), causal and not;
 15. chatglm3-6b (28 layers, bf16, ~12.5 GB) at full width and depth: f32
     parity at 4 layers (the kernel against the plain attention on the
     prefill's logits and caches and one decode step, rtol = atol = 1e-4);
     the kernel on the served layer-0 q, k, v; 3 prefills of 2 x 4608
     tokens with 28 flash launches each; one prefill and one decode step
     profiled (``[lm-profile]``); ``LMEngine`` 16 greedy tokens twice,
     identical; ``[glm-*]`` lines;
 16. llava-next-mistral-7b (32 layers, bf16) at full width and depth: f32
     parity at 4 layers with the patch prefix; each request 2880 random
     patch embeddings (1024 wide) and 1728 text tokens:
     ``transformer.prefill(frontend_embeds=...)`` into 4864 positions (32
     flash launches) and 16 greedy steps through ``steps.make_serve_step``,
     twice, identical; one ``LMEngine.generate`` on the text prompts alone,
     as the reference's engine serves the vlm family; ``[llava-*]`` lines;
 17. qwen2-72b at full width, depth cut to 32 of its 80 layers (61.2 GB of
     bf16 weights; 80 layers are 145 GB): f32 parity at 2 layers, then as
     15 (32 flash launches a prefill); ``[qwen72-*]`` lines;
 18. whisper-tiny (4 encoder + 4 decoder layers) at full width and depth:
     ``api.forward`` on random (2, 1536, 80) frames and 64-token prompts,
     f32 through the kernel against the plain attention (1e-4), bf16 with
     4 non-causal and 4 causal flash launches; ``LMEngine`` 2 x 64-token
     prompts and 16 tokens, twice, identical, as the reference serves the
     audio family (zero cross K/V, prompt fed token by token);
     ``[whisper-*]`` lines;
 19. after freeing whisper-tiny, the hybrid family: (a) the flash kernel
     held against its plain version at zamba2-2.7b's served shape (B 2,
     S 4608, H = Kh = 32, hd 80 on the ``mma.sync`` body, causal) in bf16
     as in 6, beside scaled_dot_product_attention, and in f32 at S 1024
     (rtol = atol = 1e-5), and at the smoke configs' hd 8 (zero-padded to
     16) in f32 and bf16 at the serve CLI's shape (4 x 8 tokens, H 8 over
     Kh 2); (b) ``launch/serve.py --smoke`` on the card for chatglm3-6b,
     qwen2-72b, llava-next-mistral-7b and granite-moe-3b-a800m (hd 8: one
     flash launch a layer each); (c) zamba2-2.7b at full width in f32,
     depth cut to 12 layers (2 shared invocations): the forward on 2 x
     4608 tokens through the kernel against the plain attention (logits,
     K/V, SSD states; 1e-4), and 128 tokens a row decoded one at a time
     against the forward (atol 2e-3, the reference's); (d) the full
     54-layer model in bf16 (4.84 GB): 3 prefills of 2 x 4608 tokens
     through ``make_prefill_step`` (9 flash launches each), one profiled
     (GEMMs, the SSD chunk loop, flash, the rest), ``LMEngine`` on 2 x
     64-token prompts fed token by token and 16 greedy tokens, twice,
     identical, one decode step profiled; ``[zamba2-*]`` lines;
 20. training, after zamba2-2.7b and outside ``torch.no_grad()``: (a) each
     body of the flash kernel asked for each row's log-sum-exp (hd 64 and
     80 on the warp-specialised wgmma body, one of them with a window and
     a softcap, 32 on mma.sync, 128 and 256 on wgmma in bf16, 64, 80 and
     the padded 8 in f32): lse against the plain version's, the output
     bit-identical to a serving call's; the CPU model of the hd 64/80
     body's tile walk (``ref.flash_attention_tiled_ref``) run on the card
     against the kernel at hd 64 and hd 80 (output at the flash tolerance,
     lse at 1e-3); (b) ``ops.FlashAttentionFn``'s gradients at
     granite-moe-3b-a800m's train shape (B 1, S 4096, H 24 over Kh 8, hd
     64, bf16; relative Frobenius 2e-2) and in f32 at S 1024 (1e-4)
     against autograd through the plain attention, and the row
     ``flash_attention/granite_train_lse`` (the kernel with lse beside
     its plain version and SDPA, the plain backward beside SDPA's forward
     and backward); (c) granite-moe at full width and 2 layers: a train
     step through the kernel against one through the plain attention
     (loss 1e-3, grad_norm 1e-2), and ``launch/train.py``'s loop saving
     after step 2, that checkpoint restored bit for bit, a resumed run's
     step 3 within 1e-6 of the uninterrupted state's; (d) one train step
     of every LM family's smoke config (B6 for rwkv6, the padded hd 8);
     (e) the full 32-layer granite-moe-3b-a800m (3.3 B parameters, f32
     masters and AdamW state on the card) through ``launch/train.py``'s
     loop: 4 steps of 2 x 4096 tokens in 2 microbatches, remat "full"
     (128 flash launches a step), step p50 after the first, tokens/s,
     peak memory, the flop bound, one more step profiled (GEMMs, flash
     forward, the plain flash backward, the MoE dispatch forward and
     backward, the optimizer, the rest); ``[train*]`` lines;
 13b. ``[members-serve]`` (after qwen2-moe-a2.7b is freed; the one-device
     f32 logits of phase 12 and bf16 last-position logits and tokens of
     phase 13 kept on the host): the flash kernel held at a member's head
     shape (B 2, S 4608, H 8 over Kh 8, hd 128, causal, bf16; row
     ``flash_attention/qwen2moe_members_heads``), then two processes on
     this card over gloo with CUDA tensors (``chip_smoke.py --member``;
     NCCL refuses two ranks on one device), each on a (1, 2) mesh under
     ``arch_rules`` (heads, MLP, vocab and experts over ``model``): f32
     parity at 2 layers against one device (1e-4), an a2a-dispatch
     prefill (S 4608 in 2 slices) against the gather one at capacity
     factor 8 (1e-4), a2a decode raising; the full 24-layer bf16 model,
     each member drawing the one-device weights and keeping its blocks
     (15.15 GB): a prefill with 24 flash launches at the member's shape
     and its collectives counted, last-position logits within relative
     Frobenius 5e-2 of one device's, 3 prefills timed, one profiled (the
     collectives' host time and device work), ``LMEngine`` twice,
     identical, on both members;
 11b. ``[members-ssm]`` (after rwkv6-1.6b is freed): the WKV kernel held
     against its plain version at a member's shape (B 2, S 4096, H 16,
     f32; row ``rwkv6_wkv/rwkv6_members_heads``); the one-device values:
     f32 at 4 layers (the last position's logits, and the 8th prompt token
     fed through decode_step), bf16 at full depth through the kernel and
     through the plain WKV (their relative Frobenius distance x 3 is the
     members' gate), ``LMEngine`` tokens; then two processes over gloo, as
     13b, on a (1, 2) mesh (16 of 32 heads, half the channel mix and the
     vocab): f32 parity at 1e-4, the full 24-layer bf16 model (1.72 GB a
     member): a 2 x 4096 prefill launching the kernel 24 times at (2,
     4096, 16) with 49 all_reduce and 1 all_gather, its logits within the
     gate, a warm prefill timed, one profiled, ``LMEngine`` twice,
     identical;
 19e. ``[members-hybrid]`` (after zamba2-2.7b is freed): the flash kernel
     held at a member's heads (B 2, S 4608, H 16 = Kh 16, hd 80, causal,
     bf16; row ``flash_attention/zamba2_members_heads``) beside
     scaled_dot_product_attention; then as 11b for zamba2-2.7b (f32 at 12
     layers; 40 of 80 Mamba-2 heads, their z / x / dt columns, B and C
     whole; the shared block's 16 heads, half its MLP, half the vocab;
     2.44 GB a member): a 2 x 4608 prefill launching flash 9 times at
     (16, 16, 80) with 127 all_reduce (wo and down a shared invocation,
     out_proj and the gate_norm statistic a mamba layer, the embedding)
     and 1 all_gather, ``LMEngine`` once;
 20f. ``[members-train]``: granite-moe-3b-a800m at full width, 8 of 32
     layers: one step on one device, then on two members a data-parallel
     step ((2, 1) mesh, a row each) and a tensor-parallel one ((1, 2)
     mesh) against it (loss 1e-3, grad_norm 1e-2 relative), and
     ``compressed_psum`` of the largest leaf (the stacked expert gate,
     1.0 GB f32) bit for bit against an f32 model of its int8 sum; then
     the same two steps, each against one device's, for rwkv6-1.6b at 8
     of 24 layers in f32 (B6 under autograd), zamba2-2.7b at 12 of 54
     layers (B5 under autograd at a member's heads) and whisper-tiny
     whole (data-parallel, and replicated on the (1, 2) mesh);
 20g. ``[members-elastic]``: ``ElasticRunner`` on the granite smoke config,
     data-parallel over two members, a checkpoint every 2 steps; a
     ``NodeFailure`` at step 3 leaves rank 0, which restores step 2 onto
     one member and replays; its final state within 1e-6 of an
     uninterrupted one-device run;
 21. one JSON line of kernel numbers, the card's name and power limit, and
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


KERNEL_NAMES = re.compile(r"(flash_wgmma_ws|flash_wgmma|flash_bf16|"
                          r"flash_f32|wkv_state_pass|wkv_output_pass|"
                          r"bag_pool_f32|"
                          r"dot_interaction_f32|"
                          r"dot_interaction_empty_kernel)((?:I?Li\d+E)*)")
# the wgmma flash bodies keep their accumulators (128 registers at hd 256;
# scores, P and output beside a producer warp at hd 64/80) only if nothing
# spills, and the bag keeps two batches of rows in flight in registers:
# their reports must show no stack and no spill stores
NO_SPILL = ("flash_wgmma", "flash_wgmma_ws", "bag_pool_f32")


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
    from ptxas, the dynamic shared memory of the wgmma flash bodies and the
    two WKV passes, and the flash tiling; fails if a wgmma body or the bag
    spills."""
    from repro_torch.kernels import _build

    for src, text in logs.items():
        lib = _build.library(src)
        for name, arg, used, stack, spill in ptxas_report(text):
            extra = ""
            if name in ("flash_wgmma", "flash_wgmma_ws"):
                bk, st, sm = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int())
                lib.flash_attention_tiling(int(arg.split(",")[0]),
                                           ctypes.byref(bk),
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


def range_kernels(prof, name: str) -> list:
    """(kernel name, device us) of each kernel and copy launched inside the
    profiler range ``name``, the range's own span on the device left
    out."""
    out = []
    stack = [e for e in prof.events() if e.name == name
             and e.device_type != torch.autograd.DeviceType.CUDA]
    while stack:
        e = stack.pop()
        out += [(k.name, k.duration) for k in e.kernels if k.name != name]
        stack.extend(e.cpu_children)
    return out


def range_device_us(prof, name: str):
    """(device us, device operations) of :func:`range_kernels`; (nan, 0)
    without a trace."""
    if prof is None:
        return float("nan"), 0
    work = range_kernels(prof, name)
    return sum(us for _, us in work), len(work)


def admitted_pairs(s: int, window: int, causal: bool = True) -> int:
    """(query, key) pairs a layer of length s admits: causal (and within
    the window), or every pair without the causal mask (and no window)."""
    if not causal:
        if window:
            raise ValueError("no window without the causal mask")
        return s * s
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


def flash_row(name, gen, dev, b, s, h, kh, hd, *, window=0, cap=0.0,
              causal=True, dtype=torch.bfloat16):
    """One flash-kernel row: q (at FLASH_Q_SCALE), k, v of shape (b, s,
    heads, hd) in ``dtype`` from ``gen``, the kernel held against its plain
    version and timed (check_kernel; bf16 at FLASH_TOL and FLASH_REL on the
    tensor cores' peak, f32 at TOL on the CUDA cores'), beside
    scaled_dot_product_attention where one PyTorch call computes the
    function (no softcap, no window); the plain version without the
    softcap, without the window and, for a non-causal row, with the causal
    mask must fail the check.  Returns (row, launch key)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    q, k, v = ((torch.randn((b, s, n, hd), generator=gen, device=dev)
                * scale).to(dtype)
               for n, scale in ((h, FLASH_Q_SCALE), (kh, 1.0), (kh, 1.0)))
    f32 = dtype == torch.float32
    kw = {"causal": causal, "window": window, "softcap": cap}
    library = None
    if not cap and not window:
        # one PyTorch call computes this layer's function (no softcap):
        # the yardstick, used nowhere in the port
        def library(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True).transpose(1, 2)
    row = check_kernel(
        name, "src/repro/kernels/flash_attention.py:97",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        lambda: fa.flash_attention(q, k, v, **kw),
        lambda: ref.flash_attention_ref(q, k, v, **kw),
        library, n_bytes=q.element_size() * (2 * q.numel() + 2 * k.numel()),
        flops=4 * hd * admitted_pairs(s, window, causal) * b * h, flush=None,
        tol=TOL if f32 else FLASH_TOL, rel=None if f32 else FLASH_REL,
        peak_flops=F32_FLOPS if f32 else BF16_FLOPS)
    if row["library_ms"] is not None:
        log(f"[kernel] {name}: kernel {row['ms']:.4f} ms beside "
            f"scaled_dot_product_attention {row['library_ms']:.4f} ms in "
            f"this run ({row['ms'] / row['library_ms']:.2f}x)")
    # the check sees each branch: a kernel that dropped the softcap or the
    # window, or masked a non-causal layer, would fail it
    plain = ref.flash_attention_ref(q, k, v, **kw)
    branches = []
    if cap:
        branches.append(("without the softcap", dict(kw, softcap=0.0)))
    if window:
        branches.append(("without the window", dict(kw, window=0)))
    if not causal:
        branches.append(("with the causal mask", dict(kw, causal=True)))
    for branch, bkw in branches:
        wrong = ref.flash_attention_ref(q, k, v, **bkw)
        if torch.allclose(wrong, plain, **FLASH_TOL):
            raise AssertionError(f"{name}: the plain version {branch} "
                                 f"passes the check")
        err, fro, _ = errors(wrong, plain, FLASH_TOL["rtol"])
        log(f"[kernel] {name}: the plain version {branch} fails the check "
            f"(max_abs_err {err:.3e}, relative Frobenius error {fro:.3e})")
        del wrong
    del q, k, v, library, plain
    torch.cuda.empty_cache()
    return row, fa.launch_key(h, kh, hd, window, causal)


def flash_phase(dev):
    """Phase 6: the flash kernel against its plain version at the served
    layer shapes, in bf16, timed warm (q, k, v are written just before it
    on the prefill path).  Returns (row, launch key) pairs."""
    from repro_torch.configs.gemma2_9b import CONFIG as GEMMA
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2MOE
    from repro_torch.configs.qwen3_14b import CONFIG as QWEN

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = []
    for label, cfg, window in (
            ("gemma2_local", GEMMA, GEMMA.sliding_window),
            ("gemma2_global", GEMMA, 0),
            ("qwen3_heads", QWEN, 0),
            ("qwen2moe_heads", QWEN2MOE, 0)):
        rows.append(flash_row(
            f"flash_attention/{label}", gen, dev, LM_BATCH, LM_PROMPT,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, window=window,
            cap=cfg.attn_logit_softcap))
    return rows


def lm_prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(SEED).integers(
        0, vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)


def lm_parity_phase(dev):
    """Phase 7: full-width gemma2-9b in f32, depth cut to 4 layers (one
    local and one global group): prefill through the kernel against the
    plain attention, and one (plain) decode step from each one's cache."""
    from repro_torch.configs.gemma2_9b import CONFIG as GEMMA

    cfg = GEMMA.replace(n_layers=PARITY_LAYERS, dtype="float32")
    toks = torch.from_numpy(lm_prompts(cfg.vocab_size)).to(dev)
    family_parity("lm-parity", "gemma2-9b", cfg, toks, dev,
                  full_depth=GEMMA.n_layers)
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


def served_layers_check(params, cfg, toks, frontend_embeds=None):
    """The kernel against its plain version on the q, k and v the served
    model computes for the prompts (behind ``frontend_embeds``, for a VLM)
    at the first layer of each kind in its pattern (group 0 of each
    sublayer), at the tolerance of phase 6."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    x = T.embed_inputs(params, cfg, toks, frontend_embeds)
    positions = torch.arange(x.shape[1], device=toks.device)[None, :]
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
    n_bytes = weight_bytes(params)
    log(f"[lm-init] gemma2-9b {cfg.n_layers} layers, {cfg.dtype}, "
        f"{n_bytes / 1e9:.3f} GB of weights in "
        f"{time.perf_counter() - t0:.2f} s")
    prompts = lm_prompts(cfg.vocab_size)
    toks = torch.from_numpy(prompts).to(dev)
    served_layers_check(params, cfg, toks)
    prefill_ms = prefill_runs(params, cfg, toks)
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
    check_generated(first, second, cfg.vocab_size)
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
        f"launches by (H, Kh, hd, window, causal) {by_key}")
    log(f"[lm-serve] decode weight-read bound {n_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms/token ({n_bytes / 1e9:.3f} GB at 3.35 TB/s)")
    return launches, by_key


def wkv_inputs(b, s, gen, dev, *, regime="default", h=WKV_HEADS):
    """Seeded WKV inputs at H ``h``, K = V = 64: r, k, v ~ N(0,1); logw =
    -exp(N(0,1)) (default), -exp(N(-4,1)) (long memory) or -50 (each
    token's state dies at the next); u ~ 0.5 N(0,1); state0 ~ 0.1 N(0,1)."""
    kk = 64
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


def wkv_row(name, x, max_abs_err):
    """The kernel row of the WKV inputs ``x``, held already: the kernel's
    and the plain chunked version's times (the plain one over 3 runs: it
    walks the chunks from Python) and the byte bound (r, k, v, logw, out
    and u read or written once, the state in and out)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wk

    b, s, h, _ = x[0].shape
    n_bytes = 5 * x[0].numel() * 4 + x[4].numel() * 4 + 2 * x[5].numel() * 4
    flops = 4 * 64 * 64 * b * s * h
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
           "replaces": "src/repro/kernels/rwkv6_wkv.py:94",
           "launches": 0, "max_abs_err": max_abs_err,
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
    return row


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
        row = wkv_row(name, x, max(err, s_err))
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
                              wkv_impl="interpret")
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

    cfg = QWEN2MOE.replace(n_layers=MOE_PARITY_LAYERS, dtype="float32")
    toks = torch.from_numpy(lm_prompts(cfg.vocab_size)).to(dev)
    params = family_parity("moe-parity", "qwen2-moe-a2.7b", cfg, toks, dev,
                           full_depth=QWEN2MOE.n_layers)
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
    del sub, h
    # the one-device values the members' f32 parity is held against
    p1 = members_parity_logits(params, cfg, toks)
    del params
    torch.cuda.empty_cache()
    return p1


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
    n_bytes = weight_bytes(params)
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
    prefill_ms = prefill_runs(params, cfg, toks)
    prefill_peak = torch.cuda.max_memory_allocated()
    # the one-device last-position logits the members are held against,
    # and how far the plain attention moves them: the full-depth model's
    # own sensitivity to a rounding-level change in every layer
    p1_last = T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN)[0].float().cpu()
    p1_plain = T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN,
                         attn_impl="ref")[0].float().cpu()
    plain_rel = rel_fro(p1_plain.numpy(), p1_last.numpy())
    log(f"[moe-serve] bf16 last-position logits with the plain attention "
        f"vs the kernel: relative Frobenius {plain_rel:.3e}, argmax equal "
        f"{bool((p1_plain.argmax(-1) == p1_last.argmax(-1)).all())}")
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
    check_generated(first, second, cfg.vocab_size)
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
        f"launches by (H, Kh, hd, window, causal) {by_key}")
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
    return by_key, {"bf16_last": p1_last.numpy(), "bf16_tokens": first,
                    "bf16_plain_rel": np.float64(plain_rel)}


# ---------------------------------------------------------------------------
# the LM over members: P = 2 as two processes on this one card, over gloo
# with CUDA tensors (NCCL refuses two ranks on one device).  Gloo stages
# every collective through host memory, so these runs check correctness
# and the layout on the card; their times measure that staging, not
# scaling.
# ---------------------------------------------------------------------------

MEMBERS = 2
MEMBERS_TIMEOUT = 900
MEMBERS_DIR = ROOT / "build" / "members"
# how a member process is started, and the device its work runs on
MEMBER_ARGV = [sys.executable, str(ROOT / "chip_smoke.py")]
MEMBER_DEVICE = "cuda"
# bf16, P = 2 against P = 1: each row-parallel product's two halves are
# rounded to bf16 and summed by the all_reduce where one device keeps the
# whole sum in the GEMM's f32 accumulator (one more bf16 rounding a
# product, 2 a layer), and routing near-ties may flip.  At 2 layers the
# last-position logits are held at MEMBERS_BF16_CUT_REL (relative
# Frobenius); at full depth such rounding-level changes grow through 24
# layers, so the gate is MEMBERS_BF16_FACTOR times what swapping the
# kernel for the plain attention moves one device's logits (phase 13)
MEMBERS_BF16_CUT_REL = 3e-2
MEMBERS_BF16_FACTOR = 3.0
# the a2a prefill against the gather one at f32 and 2 layers, both at a
# capacity factor where nothing drops (the two modes drop other slots at
# the config's 1.25: capacity is per member's slice in a2a)
MEMBERS_A2A_CF = 8.0
MEMBERS_COLLECTIVES = ("all_reduce", "all_gather", "all_to_all_single")
COLLECTIVE_RANGE = "members.collective"
# [members-train]: granite-moe-3b-a800m at full width, depth cut to 4 of
# its 32 layers (8, whose f32 masters, m and v took 10.7 GB at P = 1,
# until the rwkv6, zamba2 and whisper steps joined the phase; a data
# member holds all of it, a tensor member ~half) on the train phase's
# batch
MEMBERS_TRAIN_LAYERS = 4
# [members-elastic]: the granite smoke config, 2 x 64-token batches, a
# checkpoint every 2 steps, the failure at step 3 (rank 1 leaves)
ELASTIC_STEPS, ELASTIC_FAIL_AT, ELASTIC_CKPT_EVERY = 6, 3, 2
ELASTIC_BATCH, ELASTIC_SEQ, ELASTIC_TOL = 2, 64, 1e-6
# the last checkpoint before the failure
ELASTIC_CKPT = (ELASTIC_FAIL_AT - 1) - (ELASTIC_FAIL_AT - 1) % \
    ELASTIC_CKPT_EVERY


def members_parity_logits(params, cfg, toks):
    """(last-position prefill logits, the first decode step's logits) of
    ``cfg`` on ``toks`` in f32, and the last-position logits of the same
    draws in bf16, on the host."""
    from repro_torch.models import transformer as T

    last, cache = T.prefill(params, cfg, toks, pad_to=toks.shape[1] + 1)
    step, _ = T.decode_step(params, cfg, toks[:, -1:], cache)
    out = {"f32_last": last.cpu().numpy(), "f32_decode": step.cpu().numpy()}
    del last, cache, step
    b16 = cfg.replace(dtype="bfloat16")
    pb = T.init_lm(SEED, b16, toks.device, layout=params_layout(b16))
    out["bf16_cut_last"] = T.prefill(pb, b16, toks, pad_to=toks.shape[1])[
        0].float().cpu().numpy()
    return out


def params_layout(cfg):
    """This member's parameter layout under the ambient mesh (None
    without one)."""
    from repro_torch.models import api
    from repro_torch.sharding import partition

    return api.param_layout(cfg) if partition.current_mesh() else None


def rel_fro(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_members(task, inputs: dict):
    """Run MEMBERS processes of ``task`` (``chip_smoke.py --member``) on
    this card over gloo, ``inputs`` saved beside them; relay member 0's
    lines; -> each member's result.  A member that fails fails the
    phase, with both logs."""
    import shutil

    d = MEMBERS_DIR / task
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    np.savez(d / "inputs.npz", **inputs)
    port = free_port()
    logs = [open(d / f"log_{r}.txt", "w") for r in range(MEMBERS)]
    procs = [subprocess.Popen(
        MEMBER_ARGV + ["--member", task, str(r), str(MEMBERS), str(port),
                       str(d)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(MEMBERS)]
    try:
        rcs = [p.wait(timeout=MEMBERS_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = [(d / f"log_{r}.txt").read_text() for r in range(MEMBERS)]
    for line in texts[0].splitlines():
        if line.startswith("[members-"):
            log(line)
    if any(rcs):
        for r, t in enumerate(texts):
            log(f"[{task}] member {r} exited {rcs[r]}:\n{t}")
        raise AssertionError(f"members of {task!r} exited {rcs}")
    return [json.loads((d / f"result_{r}.json").read_text())
            for r in range(MEMBERS)]


def member_main(argv) -> int:
    """``chip_smoke.py --member <task> <rank> <world> <port> <dir>``: one
    member process of a members phase."""
    import torch.distributed as dist

    task, rank, world, port, d = (argv[0], int(argv[1]), int(argv[2]),
                                  int(argv[3]), Path(argv[4]))
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if MEMBER_DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        inputs = dict(np.load(d / "inputs.npz"))
        result = MEMBER_TASKS[task](rank, world, d, inputs)
    finally:
        dist.destroy_process_group()
    (d / f"result_{rank}.json").write_text(json.dumps(result))
    return 0


def members_profile(fn):
    """One call of ``fn`` under the profiler with every collective inside a
    ``COLLECTIVE_RANGE`` range and timed on the host: -> wall ms, device
    busy ms, device ms inside the collectives (gloo's staging copies),
    host ms inside the collectives, their calls."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function

    orig = {k: getattr(dist, k) for k in MEMBERS_COLLECTIVES}
    host = {"s": 0.0, "n": 0}

    def ranged(f):
        def call(*a, **kw):
            t0 = time.perf_counter()
            with record_function(COLLECTIVE_RANGE):
                out = f(*a, **kw)
            host["s"] += time.perf_counter() - t0
            host["n"] += 1
            return out
        return call

    for k, f in orig.items():
        setattr(dist, k, ranged(f))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for k, f in orig.items():
            setattr(dist, k, f)
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != COLLECTIVE_RANGE)
    coll_us, coll_ops = range_device_us(prof, COLLECTIVE_RANGE)
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e3,
            "collective_device_ms": coll_us / 1e3,
            "collective_device_ops": coll_ops,
            "collective_host_ms": host["s"] * 1e3,
            "collective_calls": host["n"]}


def member_serve(rank, world, d, inputs):
    """[members-serve], one member: qwen2-moe-a2.7b over a (1, world) mesh
    under ``arch_rules`` (heads, MLP, vocab and experts over ``model``):
    f32 parity at MOE_PARITY_LAYERS against P = 1, the a2a prefill against
    the gather one, then the full bf16 model: a prefill with its flash
    launches and collectives counted and its logits against P = 1,
    prefills timed, one profiled, LMEngine twice."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import LMEngine
    from repro_torch.sharding import partition

    dev = torch.device(MEMBER_DEVICE)
    cfg = CONFIG
    mesh = mesh_mod.make_host_mesh(model=world)
    rules = specs.arch_rules(cfg, mesh, ShapeConfig(
        "prefill", "prefill", LM_PROMPT, LM_BATCH))
    prompts = lm_prompts(cfg.vocab_size)
    toks = torch.from_numpy(prompts).to(dev)
    res = {}
    with partition.axis_rules(mesh, rules), torch.no_grad():
        c2 = cfg.replace(n_layers=MOE_PARITY_LAYERS, dtype="float32")
        params = T.init_lm(SEED, c2, dev, layout=api.param_layout(c2))
        got = members_parity_logits(params, c2, toks)
        for k in ("f32_last", "f32_decode"):
            torch.testing.assert_close(torch.from_numpy(got[k]),
                                       torch.from_numpy(inputs[k]), **LM_TOL)
            res[k] = float(np.abs(got[k] - inputs[k]).max())
        res["bf16_cut_rel"] = rel_fro(got["bf16_cut_last"],
                                      inputs["bf16_cut_last"])
        if res["bf16_cut_rel"] > MEMBERS_BF16_CUT_REL:
            raise AssertionError(f"bf16 at {MOE_PARITY_LAYERS} layers over "
                                 f"members: relative Frobenius "
                                 f"{res['bf16_cut_rel']:.3e} > "
                                 f"{MEMBERS_BF16_CUT_REL}")
        by_mode = {}
        for mode in ("gather", "a2a"):
            cx = c2.replace(moe=dataclasses.replace(
                c2.moe, capacity_factor=MEMBERS_A2A_CF, dispatch=mode))
            by_mode[mode] = T.prefill(params, cx, toks,
                                      pad_to=LM_PROMPT)[0].float()
        torch.testing.assert_close(by_mode["a2a"], by_mode["gather"],
                                   **LM_TOL)
        res["a2a_vs_gather"] = (by_mode["a2a"] -
                                by_mode["gather"]).abs().max().item()
        try:
            T.decode_step(params, cx, toks[:, -1:],
                          T.make_cache(cx, LM_BATCH, 8, device=dev))
            raise AssertionError("a2a decode (S = 1) did not raise")
        except ValueError as e:
            res["a2a_decode"] = str(e)
        del params, by_mode, got
        torch.cuda.empty_cache()
        log(f"[members-serve] rank {rank}: qwen2-moe-a2.7b f32 at "
            f"{MOE_PARITY_LAYERS} layers over {world} members vs one "
            f"device: prefill logits max_abs_err {res['f32_last']:.3e}, "
            f"decode {res['f32_decode']:.3e} (rtol = atol = 1e-4); bf16 "
            f"last-position logits relative Frobenius "
            f"{res['bf16_cut_rel']:.3e} (gate {MEMBERS_BF16_CUT_REL}); a2a "
            f"prefill (S {LM_PROMPT} in {world} slices) vs gather at "
            f"capacity factor {MEMBERS_A2A_CF} max_abs_err "
            f"{res['a2a_vs_gather']:.3e}; a2a decode raises: "
            f"{res['a2a_decode']!r}")

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        layout = api.param_layout(cfg)
        params = T.init_lm(SEED, cfg, dev, layout=layout)
        torch.cuda.synchronize()
        res["init_s"] = time.perf_counter() - t0
        res["weight_gb"] = weight_bytes(params) / 1e9
        ops.reset_launches()
        with count_collectives() as calls:
            last, cache = T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN)
            torch.cuda.synchronize()
        launches = {k: v.launches for k, v in ops.kernels().items()}
        by_key = dict(fa.FLASH.by_key)
        key = fa.launch_key(cfg.n_heads // world, cfg.n_kv_heads // world,
                            cfg.head_dim, 0)
        if launches["flash_attention"] != cfg.n_layers or \
                by_key != {key: cfg.n_layers}:
            raise AssertionError(f"member prefill launched {launches}, by "
                                 f"key {by_key}, not {cfg.n_layers} at {key}")
        res["launches"] = launches["flash_attention"]
        res["key"] = list(key)
        res["calls"] = {k: v for k, v in calls.items() if v}
        res["cache_gb"] = sum(cache[k].numel() * cache[k].element_size()
                              for k in ("k", "v")) / 1e9
        want = inputs["bf16_last"]
        mine = last.float().cpu().numpy()
        if not np.isfinite(mine).all():
            raise AssertionError("bf16 logits over members not finite")
        res["bf16_rel"] = rel_fro(mine, want)
        res["bf16_max_abs"] = float(np.abs(mine - want).max())
        res["argmax_equal"] = bool((mine.argmax(-1) ==
                                    want.argmax(-1)).all())
        del last, cache
        res["prefill_ms"] = prefill_runs(params, cfg, toks)
        res["profile"] = members_profile(
            lambda: T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN))
        eng = LMEngine(params, cfg, max_len=LM_MAX_LEN, device=dev)
        first = eng.generate(prompts, LM_NEW)
        eng.monitor.reset()
        second = eng.generate(prompts, LM_NEW)
        check_generated(first, second, cfg.vocab_size)
        res["decode_p50_ms"] = eng.monitor.percentile(0.5) * 1e3
        res["decode_p99_ms"] = eng.monitor.percentile(0.99) * 1e3
        res["tokens_row0"] = first[0].tolist()
        res["tokens_match_p1"] = float((first == inputs["bf16_tokens"])
                                       .mean())
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def member_train(rank, world, d, inputs):
    """[members-train], one member: granite-moe-3b-a800m at full width and
    MEMBERS_TRAIN_LAYERS layers, one data-parallel step ((world, 1) mesh,
    each member one of the batch's rows) and one tensor-parallel step ((1,
    world) mesh, the whole batch in the config's microbatches) from the
    same draws; then ``compressed_psum`` on the model's largest leaf
    against an f32 model of the same int8 sum."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs
    from repro_torch.models import api
    from repro_torch.sharding import partition
    from repro_torch.train import grad_compression as GC
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_mod

    dev = torch.device(MEMBER_DEVICE)
    cfg = GRANITE.replace(n_layers=MEMBERS_TRAIN_LAYERS)
    batch = train_batch(cfg, dev)
    res = {}
    for name, model in (("dp", 1), ("tp", world)):
        mesh = mesh_mod.make_host_mesh(model=model)
        rules = specs.arch_rules(cfg, mesh, ShapeConfig(
            "train", "train", TRAIN_SEQ, TRAIN_BATCH))
        accum = cfg.train_accum // mesh.shape["data"]
        torch.cuda.reset_peak_memory_stats()
        with partition.axis_rules(mesh, rules):
            params = api.init(SEED, cfg, dev, n_shards=1, dtype="float32",
                              layout=api.param_layout(cfg))
            step = steps_mod.make_train_step(cfg, accum_steps=accum)
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, opt.adamw_init(params), batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        r = {k: float(v) for k, v in m.items()}
        r.update(step_s=dt, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 by_key={str(k): v for k, v in fa.FLASH.by_key.items()},
                 mesh=[mesh.shape["data"], mesh.shape["model"]],
                 accum=accum)
        for key, rel in (("loss", TRAIN_LOSS_REL),
                         ("grad_norm", TRAIN_GNORM_REL)):
            want = float(inputs[key])
            if not (np.isfinite(r[key]) and
                    abs(r[key] - want) <= rel * abs(want)):
                raise AssertionError(f"{name} step {key} {r[key]!r} vs one "
                                     f"device {want!r} (relative {rel})")
        if not ops.kernels()["flash_attention"].launches:
            raise AssertionError(f"{name} step launched no flash kernel")
        res[name] = r
        log(f"[members-train] rank {rank} {name} step on a "
            f"{tuple(r['mesh'])} mesh ({accum} microbatches): loss "
            f"{r['loss']!r} grad_norm {r['grad_norm']!r} vs one device "
            f"{float(inputs['loss'])!r} / {float(inputs['grad_norm'])!r}; "
            f"{dt:.2f} s, peak {r['peak_gb']:.2f} GB, flash by key "
            f"{r['by_key']}")
        if name == "dp":       # whole leaves: the largest one's name, shape
            big = max(zip(_paths(params), opt.leaves(params)),
                      key=lambda kv: kv[1].numel())
            leaf, full_shape = big[0], tuple(big[1].shape)
            del big
        del params, state, step
        torch.cuda.empty_cache()
    # compressed_psum on the largest leaf of the cut model, seeded per rank
    gen = torch.Generator(device=dev).manual_seed(SEED + rank)
    x = torch.randn(full_shape, generator=gen, device=dev)
    GC.compressed_psum(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = GC.compressed_psum(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    scale = torch.clamp(torch.stack([p.abs().max() for p in parts]).max()
                        / 127.0, min=1e-12)
    total = sum(torch.clamp(torch.round(p / scale), -127, 127)
                .to(torch.int32) for p in parts)
    model = total.float() * scale
    if not torch.equal(out, model):
        raise AssertionError("compressed_psum differs from the f32 model of "
                             "its int8 sum")
    res["psum"] = {"leaf": leaf, "shape": list(full_shape),
                   "ms": statistics.median(times),
                   "max_abs_vs_exact": (out - sum(parts)).abs().max().item()}
    log(f"[members-train] rank {rank} compressed_psum of {leaf} "
        f"{full_shape} f32 ({x.numel() * 4 / 1e9:.3f} GB) over {world} "
        f"members: bit-identical to the f32 model of its int8 sum; "
        f"{res['psum']['ms']:.1f} ms (median of 3), max |int8 sum - f32 "
        f"sum| {res['psum']['max_abs_vs_exact']:.3e}")
    del x, out, parts, total, model
    torch.cuda.empty_cache()
    for arch, layers in MEMBERS_FAMILY_TRAIN:
        res[arch] = member_family_steps(arch, layers, world, inputs)
    return res


def member_family_steps(arch, layers, world, inputs):
    """One member's data-parallel ((world, 1) mesh, a row each) and
    tensor-parallel ((1, world) mesh; whisper's rules are all None, so it
    runs replicated) steps of ``arch`` at full width and ``layers`` layers,
    each against the one-device step in ``inputs``: B6 under
    autograd for rwkv6, B5 for zamba2 (at the member's heads on the
    tensor-parallel mesh) and whisper."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs
    from repro_torch.models import api
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_mod

    dev = torch.device(MEMBER_DEVICE)
    cfg = family_train_config(arch, layers)
    batch = train_batch(cfg, dev)
    kernel = "rwkv6_wkv" if cfg.family == "ssm" else "flash_attention"
    out = {}
    for name, model in (("dp", 1), ("tp", world)):
        mesh = mesh_mod.make_host_mesh(model=model)
        rules = specs.arch_rules(cfg, mesh, ShapeConfig(
            "train", "train", TRAIN_SEQ, TRAIN_BATCH))
        accum = MEMBERS_FAMILY_ACCUM // mesh.shape["data"]
        torch.cuda.reset_peak_memory_stats()
        with partition.axis_rules(mesh, rules):
            params = api.init(SEED, cfg, dev, dtype="float32",
                              layout=api.param_layout(cfg))
            step = steps_mod.make_train_step(cfg, accum_steps=accum)
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, opt.adamw_init(params), batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        r = {k: float(v) for k, v in m.items()}
        r.update(step_s=dt, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches=ops.kernels()[kernel].launches,
                 by_key={str(k): v for k, v in fa.FLASH.by_key.items()},
                 mesh=[mesh.shape["data"], mesh.shape["model"]], accum=accum)
        for key, rel in (("loss", TRAIN_LOSS_REL),
                         ("grad_norm", TRAIN_GNORM_REL)):
            want = float(inputs[f"{arch}/{key}"])
            if not (np.isfinite(r[key]) and
                    abs(r[key] - want) <= rel * abs(want)):
                raise AssertionError(f"{arch} {name} step {key} {r[key]!r} "
                                     f"vs one device {want!r} (relative "
                                     f"{rel})")
        if not r["launches"]:
            raise AssertionError(f"{arch} {name} step launched no {kernel}")
        out[name] = r
        log(f"[members-train] {arch} {name} step on a {tuple(r['mesh'])} mesh "
            f"({accum} microbatches): loss {r['loss']!r} grad_norm "
            f"{r['grad_norm']!r} vs one device "
            f"{float(inputs[f'{arch}/loss'])!r} / "
            f"{float(inputs[f'{arch}/grad_norm'])!r}; {dt:.2f} s, peak "
            f"{r['peak_gb']:.2f} GB, {kernel} launches {r['launches']}"
            + (f" by key {r['by_key']}" if r["by_key"] else ""))
        del params, state, step
        torch.cuda.empty_cache()
    return out


def member_elastic(rank, world, d, inputs):
    """[members-elastic], one member: ``ElasticRunner`` on the granite smoke
    config, data-parallel over ``world`` members; at ELASTIC_FAIL_AT a
    ``NodeFailure`` leaves rank 0, which restores the last checkpoint onto
    a one-member mesh and replays.  Each step accumulates over the batch's
    rows as the members split them (the same capacity per microbatch)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.granite_moe_3b_a800m import \
        smoke as granite_smoke
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs
    from repro_torch.models import api
    from repro_torch.runtime import elastic
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_mod

    dev = torch.device(MEMBER_DEVICE)
    cfg = granite_smoke()
    batches = [train_batch(cfg, dev, i, ELASTIC_BATCH, ELASTIC_SEQ)
               for i in range(ELASTIC_STEPS)]
    events = {"failed": False, "steps": []}

    def rules(m):
        return specs.arch_rules(cfg, m, ShapeConfig(
            "train", "train", ELASTIC_SEQ, ELASTIC_BATCH))

    def layout_of(m):
        with partition.axis_rules(m, rules(m)):
            lay = api.param_layout(cfg)
        return partition.Layout(m, (lay.specs, opt.adamw_layout(lay).specs))

    def step_fn(state, batch, m):
        accum = ELASTIC_BATCH // m.shape["data"]
        with partition.axis_rules(m, rules(m)):
            p, s, _ = steps_mod.make_train_step(cfg, accum_steps=accum)(
                *state, batch)
        events["steps"].append((int(s["count"]) - 1, m.size))
        return (p, s)

    def fault(i):
        if i == ELASTIC_FAIL_AT and not events["failed"]:
            events["failed"] = True
            events["t_fail"] = time.perf_counter()
            raise elastic.NodeFailure([0])

    mesh = mesh_mod.make_host_mesh(model=1)
    params = api.init(SEED, cfg, dev, n_shards=1, dtype="float32")
    runner = elastic.ElasticRunner(make_shardings=layout_of,
                                   ckpt_dir=str(d / "ckpt"))
    try:
        (params, _), new_mesh, rec = runner.run(
            (params, opt.adamw_init(params)), lambda s: iter(batches[s:]),
            step_fn, mesh, fault=fault, ckpt_every=ELASTIC_CKPT_EVERY)
    except elastic.Evicted:
        log(f"[members-elastic] rank {rank} evicted at step "
            f"{ELASTIC_FAIL_AT}")
        return {"evicted": True}
    np.savez(d / "final.npz", **{k: v.cpu().numpy() for k, v in zip(
        _paths(params), opt.leaves(params))})
    return {"evicted": False, "recoveries": rec, "steps": events["steps"],
            "mesh": [new_mesh.shape["data"], new_mesh.shape["model"]]}


def _paths(tree, prefix=""):
    """Leaf paths of a tree of dicts in ``optimizer.leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                         f"{prefix}/{k}")]
    return [prefix]


def members_serve_phase(dev, card, p1):
    """[members-serve]: full-width, full-depth qwen2-moe-a2.7b at P = 2 as
    two processes on this card over gloo (``member_serve``), the flash
    kernel held at the member's head shape first; -> that kernel row,
    its launches the first member's served prefill's."""
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as cfg

    gen = torch.Generator(device=dev).manual_seed(SEED)
    row, _ = flash_row("flash_attention/qwen2moe_members_heads", gen, dev,
                       LM_BATCH, LM_PROMPT, cfg.n_heads // MEMBERS,
                       cfg.n_kv_heads // MEMBERS, cfg.head_dim)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_members("serve", p1)
    wall_s = time.perf_counter() - t0
    if res[0]["tokens_row0"] != res[1]["tokens_row0"]:
        raise AssertionError("the members generated different tokens")
    row["launches"] = res[0]["launches"]
    calls = res[0]["calls"]
    gate = MEMBERS_BF16_FACTOR * float(p1["bf16_plain_rel"])
    for r, x in enumerate(res):
        pr, warm = x["profile"], statistics.median(x["prefill_ms"][1:])
        log(f"[members-serve] member {r} of {MEMBERS} (gloo, CUDA tensors, "
            f"one card): qwen2-moe-a2.7b {cfg.n_layers} layers bf16, "
            f"{x['weight_gb']:.3f} GB of weights (init {x['init_s']:.1f} s), "
            f"cache {x['cache_gb']:.3f} GB; B {LM_BATCH} x prompt "
            f"{LM_PROMPT}: prefill ms {x['prefill_ms'][0]:.1f} first, "
            f"{warm:.1f} warm; decode ms/token p50 {x['decode_p50_ms']:.3f} "
            f"p99 {x['decode_p99_ms']:.3f}; max_memory_allocated "
            f"{x['peak_gb']:.3f} GB; flash launches a prefill "
            f"{x['launches']} at (H, Kh, hd, window, causal) {x['key']}")
        device = (f"device busy {pr['busy_ms']:.1f} ms "
                  f"({100 * pr['busy_ms'] / pr['wall_ms']:.1f}% of wall), "
                  f"{pr['collective_device_ms']:.1f} ms of it inside the "
                  f"collectives ({pr['collective_device_ops']} staging ops, "
                  f"{100 * pr['collective_device_ms'] / pr['busy_ms']:.1f}%)"
                  if pr["busy_ms"] else "the profiler saw no device "
                  "activity: device time not measured")
        log(f"[members-serve] member {r} profiled prefill: wall "
            f"{pr['wall_ms']:.1f} ms; {pr['collective_calls']} collectives "
            f"took {pr['collective_host_ms']:.1f} ms on the host "
            f"({100 * pr['collective_host_ms'] / pr['wall_ms']:.1f}% of "
            f"wall); {device}")
    x = res[0]
    log(f"[members-serve] bf16 full depth over {MEMBERS} members vs one "
        f"device: last-position logits relative Frobenius "
        f"{x['bf16_rel']:.3e} (gate {gate:.3e}: {MEMBERS_BF16_FACTOR} x the "
        f"plain attention's {float(p1['bf16_plain_rel']):.3e}), max_abs "
        f"{x['bf16_max_abs']:.3e}, argmax equal {x['argmax_equal']}; "
        f"generated tokens equal to one device's {100 * x['tokens_match_p1']:.1f}%"
        f"; collective calls a prefill {calls} ({cfg.n_layers} layers: "
        f"attention's wo and the MoE FFN (routed and shared experts) one "
        f"all_reduce each, the embedding one, the head one all_gather); "
        f"phase wall "
        f"{wall_s:.1f} s; card {card!r}")
    if x["bf16_rel"] > gate:
        raise AssertionError(f"bf16 full depth over members: relative "
                             f"Frobenius {x['bf16_rel']:.3e} > {gate:.3e}")
    return row


def members_train_phase(dev, card):
    """[members-train]: the one-device steps of granite-moe-3b-a800m at
    MEMBERS_TRAIN_LAYERS layers and of MEMBERS_FAMILY_TRAIN, then
    ``member_train`` on 2 members."""
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_mod

    cfg = GRANITE.replace(n_layers=MEMBERS_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = api.init(SEED, cfg, dev, n_shards=1, dtype="float32")
    step = steps_mod.make_train_step(cfg, accum_steps=cfg.train_accum)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state, m = step(params, opt.adamw_init(params), train_batch(cfg, dev))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    p1 = {k: float(v) for k, v in m.items()}
    log(f"[members-train] one device: {TRAIN_ARCH} full width, depth cut to "
        f"{MEMBERS_TRAIN_LAYERS} of {GRANITE.n_layers} layers, B "
        f"{TRAIN_BATCH} x S {TRAIN_SEQ} in {cfg.train_accum} microbatches: "
        f"loss {p1['loss']!r} grad_norm {p1['grad_norm']!r}, {dt:.2f} s, "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params, state, step
    torch.cuda.empty_cache()
    one = {}
    for arch, layers in MEMBERS_FAMILY_TRAIN:
        fcfg = family_train_config(arch, layers)
        batch = train_batch(fcfg, dev)
        plain_kw = {"wkv_impl": "interpret"} if fcfg.family == "ssm" else \
            {"attn_impl": "ref"}
        # the kernel's step (the members' reference), then the plain
        # version's: how far a rounding-level change moves one device
        for kw in ({}, plain_kw):
            torch.cuda.reset_peak_memory_stats()
            params = api.init(SEED, fcfg, dev, dtype="float32")
            step = steps_mod.make_train_step(
                fcfg, accum_steps=MEMBERS_FAMILY_ACCUM, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, m = step(params, opt.adamw_init(params), batch)
            torch.cuda.synchronize()
            if not kw:
                one[arch] = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 1e9
            for k, v in m.items():
                p1[f"{arch}/{'plain_' if kw else ''}{k}"] = float(v)
            del params, state, step
            torch.cuda.empty_cache()
        plain_rel = abs(p1[f"{arch}/plain_grad_norm"] -
                        p1[f"{arch}/grad_norm"]) / p1[f"{arch}/grad_norm"]
        depth = family_train_config(arch, None).n_layers
        log(f"[members-train] one device: {arch} full width, "
            f"{fcfg.n_layers} of {depth} layers, {fcfg.dtype}, batch "
            f"{tuple(batch['tokens'].shape)} tokens"
            + (f" and {tuple(batch['frames'].shape)} frames"
               if "frames" in batch else "")
            + f" in {MEMBERS_FAMILY_ACCUM} microbatches: loss "
            f"{p1[f'{arch}/loss']!r} grad_norm {p1[f'{arch}/grad_norm']!r},"
            f" {one[arch]:.2f} s, peak {peak:.2f} GB; the plain version "
            f"({plain_kw}) in place of the kernel: grad_norm "
            f"{p1[f'{arch}/plain_grad_norm']!r} (relative {plain_rel:.3e}; "
            f"the members' gate {TRAIN_GNORM_REL})")
        del batch
    res = run_members("train", p1)
    for name in ("dp", "tp"):
        a, b = res[0][name], res[1][name]
        if (a["loss"], a["grad_norm"]) != (b["loss"], b["grad_norm"]):
            raise AssertionError(f"{name}: the members' metrics differ")
    log(f"[members-train] dp step {res[0]['dp']['step_s']:.2f} s, tp step "
        f"{res[0]['tp']['step_s']:.2f} s, one device {dt:.2f} s (gloo "
        f"stages every all_reduce through host memory); peak per member dp "
        f"{[x['dp']['peak_gb'] for x in res]} GB, tp "
        f"{[x['tp']['peak_gb'] for x in res]} GB; compressed_psum "
        f"{res[0]['psum']['ms']:.1f} ms; card {card!r}")
    for arch, _ in MEMBERS_FAMILY_TRAIN:
        for name in ("dp", "tp"):
            a, b = res[0][arch][name], res[1][arch][name]
            if (a["loss"], a["grad_norm"]) != (b["loss"], b["grad_norm"]):
                raise AssertionError(f"{arch} {name}: the members' metrics "
                                     "differ")
        log(f"[members-train] {arch}: dp step "
            f"{res[0][arch]['dp']['step_s']:.2f} s, tp step "
            f"{res[0][arch]['tp']['step_s']:.2f} s, one device "
            f"{one[arch]:.2f} s; peak per member dp "
            f"{[x[arch]['dp']['peak_gb'] for x in res]} GB, tp "
            f"{[x[arch]['tp']['peak_gb'] for x in res]} GB; card {card!r}")


def members_elastic_phase(dev, card):
    """[members-elastic]: the uninterrupted one-device run, then
    ``member_elastic`` on 2 members; rank 0's final parameters within
    ELASTIC_TOL of the uninterrupted run's."""
    from repro_torch.configs.granite_moe_3b_a800m import \
        smoke as granite_smoke
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_mod

    cfg = granite_smoke()
    params = api.init(SEED, cfg, dev, n_shards=1, dtype="float32")
    state = opt.adamw_init(params)
    step = steps_mod.make_train_step(cfg, accum_steps=ELASTIC_BATCH)
    for i in range(ELASTIC_STEPS):
        params, state, _ = step(params, state, train_batch(
            cfg, dev, i, ELASTIC_BATCH, ELASTIC_SEQ))
    want = dict(zip(_paths(params), (x.cpu().numpy()
                                     for x in opt.leaves(params))))
    t0 = time.perf_counter()
    res = run_members("elastic", {})
    wall_s = time.perf_counter() - t0
    r0 = res[0]
    if r0["evicted"] or not res[1]["evicted"] or r0["recoveries"] != 1 or \
            r0["mesh"] != [1, 1]:
        raise AssertionError(f"elastic run: {res}")
    ran = [tuple(s) for s in r0["steps"]]
    expect = [(i, MEMBERS) for i in range(ELASTIC_FAIL_AT)] + \
        [(i, 1) for i in range(ELASTIC_CKPT + 1, ELASTIC_STEPS)]
    if ran != expect:
        raise AssertionError(f"steps (count, mesh size) {ran}, not {expect}")
    final = dict(np.load(MEMBERS_DIR / "elastic" / "final.npz"))
    err = max(float(np.abs(final[k] - v).max()) for k, v in want.items())
    if err > ELASTIC_TOL:
        raise AssertionError(f"elastic final state {err:.3e} from the "
                             f"uninterrupted run (gate {ELASTIC_TOL})")
    log(f"[members-elastic] granite smoke, {ELASTIC_STEPS} steps "
        f"data-parallel over {MEMBERS} members, a checkpoint every "
        f"{ELASTIC_CKPT_EVERY}: rank 1 leaves at step {ELASTIC_FAIL_AT}, "
        f"rank 0 restores step {ELASTIC_CKPT} "
        f"onto one member and replays; steps (step, members) {ran}; final "
        f"parameters max_abs {err:.3e} from the uninterrupted one-device "
        f"run (gate {ELASTIC_TOL}); phase wall {wall_s:.1f} s; card {card!r}")


# [members-ssm] and [members-hybrid]: rwkv6-1.6b and zamba2-2.7b at full
# width and depth on a (1, 2) mesh under arch_rules (time mix and channel
# mix cut; Mamba-2 heads, the shared block's heads and MLP, the vocab
# cut), each member drawing the one-device weights and keeping its
# blocks.  The one-device values each is held against are computed in the
# phase, before the members start: f32 at the parity depth (the last
# position's logits, and the MEMBERS_DECODE_FED-th prompt token fed
# through decode_step from an empty cache), bf16 at the parity depth and
# at full depth, each through the kernel and through the plain version
# (their distance sets the gate, as in [members-serve]), and LMEngine's
# tokens.  At full depth that gate bounds rounding grown through the
# layers (rwkv6: ~0.9 relative Frobenius) and cannot see a layout fault;
# the parity depth's f32 (1e-4) and bf16 gates can
MEMBERS_SSM_PROMPT = 4096
MEMBERS_DECODE_FED = 8
MEMBERS_GEN_PROMPT = 64
# [members-train] for the other families, each at full width in its
# configured bf16: rwkv6 cut to 2 of its 24 layers and zamba2 to 12 of 54
# (two shared invocations), whisper whole; the train phase's batch
# (whisper: 2 x 4096 frames and 1024 tokens) in two microbatches of one
# row on one device and on a (1, 2) mesh, one row a member on a (2, 1)
# mesh.  rwkv6's bf16 gradient on 4096 tokens is rounding-dominated past a
# few layers (src/repro_torch/tools/tp_grad_diff.py on an H100: at 8
# layers one device's is 37-282% from its f32 twin leaf by leaf and its
# norm 45% above; at 4 layers a tensor-parallel step's norm is 4.8% from
# one device's; at 2 layers 3e-5), so a 1e-2 gate holds at 2 layers
MEMBERS_FAMILY_TRAIN = (("rwkv6-1.6b", 2), ("zamba2-2.7b", 12),
                        ("whisper-tiny", None))
MEMBERS_FAMILY_ACCUM = 2


def recurrent_parity_logits(params, cfg, toks):
    """The last position's forward logits and the logits of the
    MEMBERS_DECODE_FED-th prompt token fed one at a time through
    ``api.decode_step`` from an empty cache, on the host."""
    from repro_torch.models import api

    last, _ = api.forward(params, cfg, {"tokens": toks}, remat=False,
                          last_only=True)
    cache = api.make_cache(cfg, toks.shape[0], MEMBERS_DECODE_FED,
                           device=toks.device)
    for t in range(MEMBERS_DECODE_FED):
        step, cache = api.decode_step(params, cfg, toks[:, t:t + 1], cache)
    return {"f32_last": last.float().cpu().numpy(),
            "f32_decode": step.float().cpu().numpy()}


def bf16_cut_logits(cfg, parity_layers, toks, dev, **kw):
    """The last position's forward logits of ``cfg`` (bf16) at
    ``parity_layers`` layers, laid out under the ambient mesh, on the
    host."""
    from repro_torch.models import api

    c = cfg.replace(n_layers=parity_layers)
    params = api.init(SEED, c, dev, layout=params_layout(c))
    last = api.forward(params, c, {"tokens": toks}, remat=False,
                       last_only=True, **kw)[0]
    return last.float().cpu().numpy()


def members_gen_prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(SEED + 1).integers(
        0, vocab, (LM_BATCH, MEMBERS_GEN_PROMPT)).astype(np.int32)


def family_one_device(tag, cfg, toks, parity_layers, plain_kw, dev):
    """The one-device values a members phase of ``cfg`` is held against
    (see above); -> a dict for ``run_members``."""
    from repro_torch.models import api
    from repro_torch.serving.engine import LMEngine

    c = cfg.replace(n_layers=parity_layers, dtype="float32")
    params = api.init(SEED, c, dev)
    out = recurrent_parity_logits(params, c, toks)
    del params
    out["bf16_cut_last"] = bf16_cut_logits(cfg, parity_layers, toks, dev)
    out["bf16_cut_plain_rel"] = rel_fro(bf16_cut_logits(
        cfg, parity_layers, toks, dev, **plain_kw), out["bf16_cut_last"])
    torch.cuda.empty_cache()
    params = api.init(SEED, cfg, dev)
    batch = {"tokens": toks}
    kern = api.forward(params, cfg, batch, remat=False, last_only=True)[0]
    plain = api.forward(params, cfg, batch, remat=False, last_only=True,
                        **plain_kw)[0]
    out["bf16_last"] = kern.float().cpu().numpy()
    out["bf16_plain_rel"] = rel_fro(plain.float().cpu().numpy(),
                                    out["bf16_last"])
    del kern, plain
    torch.cuda.empty_cache()
    eng = LMEngine(params, cfg, max_len=MEMBERS_GEN_PROMPT + LM_NEW,
                   device=dev)
    out["bf16_tokens"] = eng.generate(members_gen_prompts(cfg.vocab_size),
                                      LM_NEW)
    out["decode_p50_ms"] = eng.monitor.percentile(0.5) * 1e3
    out.update(prompts=toks.cpu().numpy(), parity_layers=parity_layers)
    log(f"{tag} one device: {cfg.name} bf16, B {LM_BATCH} x "
        f"{toks.shape[1]} tokens: the plain version in place of the kernel "
        f"moves the last-position logits by {out['bf16_plain_rel']:.3e} "
        f"at full depth, {out['bf16_cut_plain_rel']:.3e} at "
        f"{parity_layers} layers (relative Frobenius); LMEngine decode "
        f"ms/token p50 {out['decode_p50_ms']:.3f}")
    del params, eng
    torch.cuda.empty_cache()
    return out


def member_family(rank, world, d, inputs):
    """[members-ssm] / [members-hybrid], one member: rwkv6-1.6b or
    zamba2-2.7b (``inputs["arch"]``) over a (1, world) mesh under
    ``arch_rules``: f32 parity at the cut depth against one device, then
    the full bf16 model: a prefill with its kernel launches (B6 at the
    member's heads, or B5 once a shared invocation) and collectives
    counted and its logits against one device's, a second (warm) prefill
    profiled, ``LMEngine`` (twice, identical, for rwkv6)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wk
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs
    from repro_torch.models import api
    from repro_torch.models import zamba2 as Z
    from repro_torch.serving.engine import LMEngine
    from repro_torch.sharding import partition
    from repro_torch.train import steps as steps_mod

    dev = torch.device(MEMBER_DEVICE)
    cfg = get_arch(str(inputs["arch"])).config
    ssm = cfg.family == "ssm"
    tag = "[members-ssm]" if ssm else "[members-hybrid]"
    toks = torch.from_numpy(inputs["prompts"]).to(dev)
    b, s = toks.shape
    mesh = mesh_mod.make_host_mesh(model=world)
    rules = specs.arch_rules(cfg, mesh, ShapeConfig("prefill", "prefill", s,
                                                    b))
    res = {}
    with partition.axis_rules(mesh, rules), torch.no_grad():
        c = cfg.replace(n_layers=int(inputs["parity_layers"]),
                        dtype="float32")
        params = api.init(SEED, c, dev, layout=api.param_layout(c))
        got = recurrent_parity_logits(params, c, toks)
        for k in ("f32_last", "f32_decode"):
            torch.testing.assert_close(torch.from_numpy(got[k]),
                                       torch.from_numpy(inputs[k]), **LM_TOL)
            res[k] = float(np.abs(got[k] - inputs[k]).max())
        del params, got
        res["bf16_cut_rel"] = rel_fro(
            bf16_cut_logits(cfg, c.n_layers, toks, dev),
            inputs["bf16_cut_last"])
        cut_gate = max(MEMBERS_BF16_CUT_REL, MEMBERS_BF16_FACTOR *
                       float(inputs["bf16_cut_plain_rel"]))
        if res["bf16_cut_rel"] > cut_gate:
            raise AssertionError(f"{tag} bf16 at {c.n_layers} layers over "
                                 f"members: relative Frobenius "
                                 f"{res['bf16_cut_rel']:.3e} > {cut_gate:.3e}")
        torch.cuda.empty_cache()
        log(f"{tag} rank {rank}: {cfg.name} f32 at {c.n_layers} layers over "
            f"{world} members vs one device: last-position logits "
            f"max_abs_err {res['f32_last']:.3e}, the "
            f"{MEMBERS_DECODE_FED}th prompt token fed through decode_step "
            f"{res['f32_decode']:.3e} (rtol = atol = 1e-4); bf16 at "
            f"{c.n_layers} layers: last-position logits relative Frobenius "
            f"{res['bf16_cut_rel']:.3e} (gate {cut_gate:.3e}: the larger of "
            f"{MEMBERS_BF16_CUT_REL} and {MEMBERS_BF16_FACTOR} x one "
            f"device's kernel-vs-plain distance there)")

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init(SEED, cfg, dev, layout=api.param_layout(cfg))
        torch.cuda.synchronize()
        res["init_s"] = time.perf_counter() - t0
        res["weight_gb"] = weight_bytes(params) / 1e9
        step = steps_mod.make_prefill_step(cfg)
        batch = {"tokens": toks}
        ops.reset_launches()
        with count_collectives() as calls:
            t0 = time.perf_counter()
            last = step(params, batch)
            torch.cuda.synchronize()
            times = [(time.perf_counter() - t0) * 1e3]
        if ssm:
            key, n = wk.launch_key(b, s, cfg.d_model // 64 // world), \
                cfg.n_layers
            by_key = dict(wk.WKV.by_key)
        else:
            key, n = fa.launch_key(cfg.n_heads // world,
                                   cfg.n_kv_heads // world, cfg.head_dim,
                                   0), Z.n_groups(cfg)
            by_key = dict(fa.FLASH.by_key)
        if by_key != {key: n}:
            raise AssertionError(f"member prefill launched {by_key}, not "
                                 f"{n} at {key}")
        # row-parallel sums: rwkv6's wo and cm_v a layer; zamba2's wo and
        # MLP down a shared invocation, out_proj and the gate_norm
        # statistic a mamba layer; the embedding's one; the head's gather
        reduces = 2 * cfg.n_layers + 1 + (0 if ssm else 2 * n)
        want_calls = {"all_reduce": reduces, "all_gather": 1}
        res.update(launches=n, key=list(key),
                   calls={k: v for k, v in calls.items() if v})
        if res["calls"] != want_calls:
            raise AssertionError(f"member prefill made {res['calls']}, not "
                                 f"{want_calls}")
        mine = last.float().cpu().numpy()
        if not np.isfinite(mine).all():
            raise AssertionError("bf16 logits over members not finite")
        want = inputs["bf16_last"]
        res["bf16_rel"] = rel_fro(mine, want)
        res["bf16_max_abs"] = float(np.abs(mine - want).max())
        res["argmax_equal"] = bool((mine.argmax(-1) ==
                                    want.argmax(-1)).all())
        del last
        res["profile"] = members_profile(lambda: step(params, batch))
        res["prefill_ms"] = times + [res["profile"]["wall_ms"]]
        prompts = members_gen_prompts(cfg.vocab_size)
        eng = LMEngine(params, cfg, max_len=MEMBERS_GEN_PROMPT + LM_NEW,
                       device=dev)
        first = eng.generate(prompts, LM_NEW)
        if ssm:
            eng.monitor.reset()
            check_generated(first, eng.generate(prompts, LM_NEW),
                            cfg.vocab_size)
        res["decode_p50_ms"] = eng.monitor.percentile(0.5) * 1e3
        res["decode_p99_ms"] = eng.monitor.percentile(0.99) * 1e3
        res["tokens_row0"] = first[0].tolist()
        res["tokens_match_p1"] = float((first == inputs["bf16_tokens"])
                                       .mean())
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def members_family_phase(tag, task, cfg, row, p1, card, what):
    """Run ``member_family`` on MEMBERS members; log each member's lines
    and hold the bf16 full-depth logits within MEMBERS_BF16_FACTOR x the
    plain version's distance of one device's; -> ``row`` with member 0's
    launches."""
    t0 = time.perf_counter()
    res = run_members(task, dict(p1, arch=cfg.name))
    wall_s = time.perf_counter() - t0
    if res[0]["tokens_row0"] != res[1]["tokens_row0"]:
        raise AssertionError("the members generated different tokens")
    row["launches"] = res[0]["launches"]
    gate = MEMBERS_BF16_FACTOR * float(p1["bf16_plain_rel"])
    for r, x in enumerate(res):
        pr, warm = x["profile"], x["prefill_ms"][1]
        log(f"{tag} member {r} of {MEMBERS} (gloo, CUDA tensors, one card): "
            f"{cfg.name} {cfg.n_layers} layers bf16, {x['weight_gb']:.3f} GB "
            f"of weights (init {x['init_s']:.1f} s); B {LM_BATCH} x prompt "
            f"{p1['prompts'].shape[1]}: prefill ms {x['prefill_ms'][0]:.1f} "
            f"first, {warm:.1f} warm (profiled); LMEngine B {LM_BATCH} x prompt "
            f"{MEMBERS_GEN_PROMPT} (fed token by token): decode ms/token p50 "
            f"{x['decode_p50_ms']:.3f} p99 {x['decode_p99_ms']:.3f} (one "
            f"device p50 {float(p1['decode_p50_ms']):.3f}); "
            f"max_memory_allocated {x['peak_gb']:.3f} GB; {what} launches a "
            f"prefill {x['launches']} at {x['key']}")
        device = (f"device busy {pr['busy_ms']:.1f} ms "
                  f"({100 * pr['busy_ms'] / pr['wall_ms']:.1f}% of wall), "
                  f"{pr['collective_device_ms']:.1f} ms of it inside the "
                  f"collectives ({pr['collective_device_ops']} staging ops)"
                  if pr["busy_ms"] else "the profiler saw no device "
                  "activity: device time not measured")
        log(f"{tag} member {r} profiled prefill: wall {pr['wall_ms']:.1f} "
            f"ms; {pr['collective_calls']} collectives took "
            f"{pr['collective_host_ms']:.1f} ms on the host "
            f"({100 * pr['collective_host_ms'] / pr['wall_ms']:.1f}% of "
            f"wall); {device}")
    x = res[0]
    log(f"{tag} bf16 full depth over {MEMBERS} members vs one device: "
        f"last-position logits relative Frobenius {x['bf16_rel']:.3e} (gate "
        f"{gate:.3e}: {MEMBERS_BF16_FACTOR} x the plain version's "
        f"{float(p1['bf16_plain_rel']):.3e}; a bound on the rounding at "
        f"full depth, too loose to see a layout fault: the f32 parity at "
        f"{int(p1['parity_layers'])} layers is that check), max_abs "
        f"{x['bf16_max_abs']:.3e}"
        f", argmax equal {x['argmax_equal']}; generated tokens equal to one "
        f"device's {100 * x['tokens_match_p1']:.1f}%; collective calls a "
        f"prefill {x['calls']}; phase wall {wall_s:.1f} s; card {card!r}")
    if x["bf16_rel"] > gate:
        raise AssertionError(f"{tag} bf16 full depth over members: relative "
                             f"Frobenius {x['bf16_rel']:.3e} > {gate:.3e}")
    return row


def members_ssm_phase(dev, card):
    """[members-ssm]: B6 held against its plain version at a member's shape
    (B 2, S MEMBERS_SSM_PROMPT, H 16, f32), the one-device values, then
    ``member_family`` for rwkv6-1.6b on 2 members; -> the B6 row."""
    from repro_torch.configs.rwkv6_1_6b import CONFIG as cfg
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wk

    name = "rwkv6_wkv/rwkv6_members_heads"
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = wkv_inputs(LM_BATCH, MEMBERS_SSM_PROMPT, gen, dev,
                   h=cfg.d_model // 64 // MEMBERS)
    out, again = wk.rwkv6_wkv(*x), wk.rwkv6_wkv(*x)
    plain = ref.rwkv6_wkv_chunked_ref(*x)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(out, again)):
        raise AssertionError(f"{name}: two kernel runs differ")
    (err, fro, need), (s_err, s_fro, _) = hold_wkv(name, out, plain)
    log(f"[kernel] {name}: out max_abs_err {err:.3e}, relative Frobenius "
        f"error {fro:.3e}, least atol {need:.3e}; final state max_abs_err "
        f"{s_err:.3e}, relative Frobenius error {s_fro:.3e}")
    row = wkv_row(name, x, max(err, s_err))
    del x, out, again, plain
    torch.cuda.empty_cache()
    toks = torch.from_numpy(rwkv_prompt(cfg.vocab_size, LM_BATCH,
                                        MEMBERS_SSM_PROMPT)).to(dev)
    p1 = family_one_device("[members-ssm]", cfg, toks, RWKV_PARITY_LAYERS,
                           {"wkv_impl": "interpret"}, dev)
    return members_family_phase("[members-ssm]", "family", cfg, row, p1,
                                card, "WKV (B, S, H)")


def members_hybrid_phase(dev, card):
    """[members-hybrid]: B5 held at a member's heads of zamba2-2.7b (B 2,
    S LM_PROMPT, H 16 = Kh 16, hd 80, causal, bf16) beside SDPA, the
    one-device values, then ``member_family`` for zamba2-2.7b on 2
    members; -> the B5 row."""
    from repro_torch.configs.zamba2_2_7b import CONFIG as cfg

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    row, _ = flash_row("flash_attention/zamba2_members_heads", gen, dev,
                       LM_BATCH, LM_PROMPT, cfg.n_heads // MEMBERS,
                       cfg.n_kv_heads // MEMBERS, cfg.head_dim)
    toks = torch.from_numpy(lm_prompts(cfg.vocab_size)).to(dev)
    p1 = family_one_device("[members-hybrid]", cfg, toks,
                           ZAMBA_PARITY_LAYERS, {"attn_impl": "ref"}, dev)
    return members_family_phase("[members-hybrid]", "family", cfg, row, p1,
                                card, "flash (H, Kh, hd, window, causal)")


def family_train_config(arch, layers):
    """``arch``'s config at ``layers`` layers (all where None)."""
    from repro_torch.configs.base import get_arch

    cfg = get_arch(arch).config
    return cfg.replace(n_layers=layers or cfg.n_layers)


MEMBER_TASKS = {"serve": member_serve, "train": member_train,
                "elastic": member_elastic, "family": member_family}


# the phases of the rest of the attention families, after the MoE ones:
# chatglm3-6b and llava-next-mistral-7b at full width and depth, qwen2-72b
# at full width and QWEN72_LAYERS of its 80 layers (80 layers of bf16
# weights are 145 GB, more than the card holds; 32 are 61.2 GB), whisper-
# tiny at full width and depth.  Traffic is the gemma2 phase's; a llava
# request carries LLAVA_PATCHES patch embeddings and LLAVA_TEXT text
# tokens, so its attention spans LM_PROMPT positions as the others'.  The
# f32 parity runs at FAMILY_PARITY_LAYERS layers on the full prompts, and
# qwen2-72b's at QWEN72_PARITY_LAYERS (~17 GB of f32 weights; the plain
# attention's (B, H, S, S) f32 scores take 10.9 GB at H 64).  whisper: 2
# requests of WHISPER_FRAMES frames and WHISPER_PROMPT decoder tokens, the
# encoder's kernel also held at WHISPER_ODD_FRAMES (1500 = 23 x 64 + 28,
# not a whole number of the hd-64 body's 64-query tiles)
FAMILY_PARITY_LAYERS = 4
QWEN72_LAYERS, QWEN72_PARITY_LAYERS = 32, 2
LLAVA_PATCHES = 2880
LLAVA_TEXT = LM_PROMPT - LLAVA_PATCHES
WHISPER_FRAMES, WHISPER_ODD_FRAMES, WHISPER_PROMPT = 1536, 1500, 64
WHISPER_MAX_LEN = WHISPER_PROMPT + LM_NEW


def families_flash_phase(dev):
    """Phase 14: the flash kernel against its plain version (bf16, as phase
    6) at the new served shapes: chatglm3-6b's heads (H 32 over Kh 2: 16
    query heads a KV head), llava's (32 over 8) and qwen2-72b's (64 over
    8), hd 128, causal, S LM_PROMPT; whisper-tiny's encoder (H = Kh = 6,
    hd 64, S WHISPER_FRAMES, not causal) and decoder (S WHISPER_PROMPT,
    causal); and the encoder's shape at WHISPER_ODD_FRAMES.  Returns (row,
    launch key) pairs."""
    from repro_torch.configs.chatglm3_6b import CONFIG as GLM
    from repro_torch.configs.llava_next_mistral_7b import CONFIG as LLAVA
    from repro_torch.configs.qwen2_72b import CONFIG as QWEN72
    from repro_torch.configs.whisper_tiny import CONFIG as WHISPER
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    rows = [flash_row(f"flash_attention/{label}", gen, dev, LM_BATCH,
                      LM_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
            for label, cfg in (("chatglm3_heads", GLM),
                               ("llava_heads", LLAVA),
                               ("qwen2_72b_heads", QWEN72))]
    w = WHISPER
    for label, s, causal in (("whisper_encoder", WHISPER_FRAMES, False),
                             ("whisper_decoder", WHISPER_PROMPT, True)):
        rows.append(flash_row(f"flash_attention/{label}", gen, dev, LM_BATCH,
                              s, w.n_heads, w.n_kv_heads, w.head_dim,
                              causal=causal))
    q, k, v = (torch.randn((LM_BATCH, WHISPER_ODD_FRAMES, w.n_heads,
                            w.head_dim), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    for causal in (False, True):
        out = fa.flash_attention(q, k, v, causal=causal)
        again = fa.flash_attention(q, k, v, causal=causal)
        if not torch.equal(out, again):
            raise AssertionError("two kernel runs differ at S "
                                 f"{WHISPER_ODD_FRAMES}")
        err, fro, _ = hold(f"S {WHISPER_ODD_FRAMES}", out,
                           ref.flash_attention_ref(q, k, v, causal=causal),
                           FLASH_TOL, FLASH_REL)
        log(f"[kernel] flash_attention whisper heads at S "
            f"{WHISPER_ODD_FRAMES} (a ragged last query tile), causal "
            f"{causal}: max_abs_err {err:.3e}, relative Frobenius error "
            f"{fro:.3e}; two runs bit-identical")
    del q, k, v, out, again
    torch.cuda.empty_cache()
    return rows


def dense_prefill_flops(cfg, b: int, s: int, n_front: int = 0) -> int:
    """Multiply-add flops (x2) of one prefill of ``b`` sequences of ``s``
    positions as the dense path computes it: q/k/v/o projections, causal
    attention (4 hd a pair), the GLU MLP, the frontend projection of
    ``n_front`` positions, the LM head on the last positions."""
    d, hd, h, kh = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    t = b * s
    per_layer = (2 * t * d * (2 * h * hd + 2 * kh * hd)
                 + 4 * hd * admitted_pairs(s, 0) * b * h
                 + 6 * t * d * cfg.d_ff)
    return (cfg.n_layers * per_layer + 2 * b * n_front * cfg.d_frontend * d
            + 2 * b * d * cfg.vocab_size)


def weight_bytes(params) -> int:
    return sum(a.numel() * a.element_size() for a in _leaves(params))


def patches_for(cfg, dev, dtype):
    """(LM_BATCH, n_frontend_tokens, d_frontend) random patch embeddings
    from the seed, as a vision tower's output would arrive."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    return torch.randn((LM_BATCH, cfg.n_frontend_tokens, cfg.d_frontend),
                       generator=gen, device=dev).to(dtype)


def family_parity(tag, name, cfg, toks, dev, patches=None, *,
                  full_depth=None):
    """``cfg`` (f32, cut from ``full_depth`` layers) prefilled through the
    kernel and through the plain attention, and one decode step from each
    cache: logits, caches and the decode logits within LM_TOL.  Returns
    the parameters."""
    from repro_torch.models import transformer as T

    params = T.init_lm(SEED, cfg, dev)
    fe = None if patches is None else patches.float()
    n = cache_positions(toks, fe)
    out = {}
    for impl in ("auto", "ref"):
        logits, cache = T.prefill(params, cfg, toks, fe, pad_to=n + 1,
                                  attn_impl=impl)
        step, _ = T.decode_step(params, cfg, toks[:, -1:], cache)
        out[impl] = (logits, cache, step)
    (la, ca, da), (lr, cr, dr) = out["auto"], out["ref"]
    pairs = ((la, lr), (ca["k"], cr["k"]), (ca["v"], cr["v"]), (da, dr))
    for a, r in pairs:
        torch.testing.assert_close(a, r, **LM_TOL)
    errs = [(a - r).abs().max().item() for a, r in pairs]
    depth = f"{cfg.n_layers} layers" if full_depth is None else \
        f"depth cut {full_depth} -> {cfg.n_layers} layers"
    seq = f"{n} positions" if fe is None else \
        f"{n} positions ({fe.shape[1]} patches + {toks.shape[1]} tokens)"
    log(f"[{tag}] {name} full width, f32, {depth}, B {toks.shape[0]} x "
        f"{seq}: kernel vs plain attention max_abs_err prefill logits "
        f"{errs[0]:.3e}, cache k {errs[1]:.3e} v {errs[2]:.3e}, decode "
        f"logits {errs[3]:.3e} (rtol = atol = 1e-4)")
    del out, la, ca, da, lr, cr, dr, pairs
    torch.cuda.empty_cache()
    return params


def cache_positions(toks, frontend_embeds=None) -> int:
    return toks.shape[1] + (0 if frontend_embeds is None
                            else frontend_embeds.shape[1])


def prefill_runs(params, cfg, toks, patches=None, n=3):
    """``n`` prefills into a cache of LM_MAX_LEN positions, each launching
    the flash kernel once per layer; -> their wall times in ms."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    times = []
    for _ in range(n):
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, toks, patches,
                                  pad_to=LM_MAX_LEN)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if ops.kernels()["flash_attention"].launches != cfg.n_layers:
            raise AssertionError(
                f"prefill launched the flash kernel "
                f"{ops.kernels()['flash_attention'].launches} times, not "
                f"{cfg.n_layers}")
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits not finite")
        del logits, cache
    return times


def check_generated(first, second, vocab):
    if first.shape != (LM_BATCH, LM_NEW):
        raise AssertionError(f"generated shape {first.shape}")
    if not ((first >= 0) & (first < vocab)).all():
        raise AssertionError("generated tokens out of range")
    if not np.array_equal(first, second):
        raise AssertionError("two generate runs differ")


def log_family_serve(tag, name, cfg, n_bytes, prefill_ms, monitor, gen_s,
                     read, flops, card, extra=""):
    """One line of a served family: weights, prefill ms and tokens/s
    against the prefill's flop bound, decode ms/token p50/p99 (the
    monitor's) against the weight-read bound, peak memory."""
    steps = sorted(monitor.lat)
    warm = statistics.median(prefill_ms[1:])
    pct = lambda q: monitor.percentile(q) * 1e3
    log(f"[{tag}] {name} ({cfg.n_layers} layers, {n_bytes / 1e9:.3f} GB of "
        f"bf16 weights) B {LM_BATCH} x {LM_PROMPT} positions{extra}, "
        f"{LM_NEW} greedy tokens, cache {LM_MAX_LEN}: prefill ms "
        f"{prefill_ms[0]:.1f} first, {warm:.1f} warm "
        f"({LM_BATCH * LM_PROMPT / warm * 1e3:.0f} prefill tokens/s) against "
        f"a {flops / BF16_FLOPS * 1e3:.3f} ms bound ({flops / 1e12:.3f} "
        f"TFLOP at 989 TFLOP/s); decode ms/token p50 {pct(0.5):.3f} p99 "
        f"{pct(0.99):.3f} min {steps[0] * 1e3:.3f} against a "
        f"{read / HBM_BYTES_PER_S * 1e3:.3f} ms weight-read bound "
        f"({read / 1e9:.3f} GB a step at 3.35 TB/s); generated tokens/s "
        f"{LM_BATCH * LM_NEW / sum(steps):.1f} (decode steps only), "
        f"generate wall {gen_s * 1e3:.1f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; card {card!r}")


def dense_family_phase(tag, full, dev, card, *, n_layers=None,
                       parity_layers=FAMILY_PARITY_LAYERS):
    """Phase 15 (chatglm3-6b) and 17 (qwen2-72b): the config ``full``, its
    depth cut to ``n_layers`` if given; f32 parity at ``parity_layers``,
    then the config in bf16 served by LMEngine: the kernel held on the
    served layer-0 q, k, v, 3 prefills with one flash launch a layer, one
    prefill and one decode step profiled, 2 generate runs identical.
    Returns the flash launches of one generate run by launch key."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import LMEngine
    from repro_torch.train import steps as steps_mod

    name = full.name
    cfg = full if n_layers is None else full.replace(n_layers=n_layers)
    cut = "" if n_layers is None else \
        f" (depth cut from {full.n_layers}: {full.n_layers} layers of " \
        f"{cfg.dtype} weights exceed the card's memory)"
    prompts = lm_prompts(cfg.vocab_size)
    toks = torch.from_numpy(prompts).to(dev)
    family_parity(f"{tag}-parity", name,
                  full.replace(n_layers=parity_layers, dtype="float32"),
                  toks, dev, full_depth=full.n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_lm(SEED, cfg, dev)
    torch.cuda.synchronize()
    n_bytes = weight_bytes(params)
    log(f"[{tag}-init] {name} {cfg.n_layers} layers{cut}, {cfg.dtype}, "
        f"{n_bytes / 1e9:.3f} GB of weights in "
        f"{time.perf_counter() - t0:.2f} s")
    served_layers_check(params, cfg, toks)
    prefill_ms = prefill_runs(params, cfg, toks)
    profile_device(f"{name} one prefill",
                   lambda: T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN))
    eng = LMEngine(params, cfg, max_len=LM_MAX_LEN, device=dev)
    ops.reset_launches()
    first = eng.generate(prompts, LM_NEW)
    by_key = dict(fa.FLASH.by_key)
    eng.monitor.reset()
    t0 = time.perf_counter()
    second = eng.generate(prompts, LM_NEW)
    gen_s = time.perf_counter() - t0
    check_generated(first, second, cfg.vocab_size)
    want = {fa.launch_key(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0):
            cfg.n_layers}
    if by_key != want:
        raise AssertionError(f"generate launched flash {by_key}, not {want}")
    step = steps_mod.make_serve_step(cfg)
    _, cache = T.prefill(params, cfg, toks, pad_to=LM_MAX_LEN)
    profile_device(f"{name} one decode step",
                   lambda: step(params, toks[:, -1:], cache)[0].cpu())
    del cache
    emb = params["embed"]["table"]
    log_family_serve(f"{tag}-serve", name, cfg, n_bytes, prefill_ms,
                     eng.monitor, gen_s,
                     n_bytes - emb.numel() * emb.element_size(),
                     dense_prefill_flops(cfg, LM_BATCH, LM_PROMPT), card)
    log(f"[{tag}-serve] tokens identical across two runs; first row "
        f"{first[0].tolist()}; flash launches by (H, Kh, hd, window, "
        f"causal) {by_key}")
    del params, eng
    torch.cuda.empty_cache()
    return by_key


def llava_phase(dev, card):
    """Phase 16: llava-next-mistral-7b (32 layers, bf16).  f32 parity at
    FAMILY_PARITY_LAYERS with the patch prefix; then each request carries
    LLAVA_PATCHES random patch embeddings and LLAVA_TEXT text tokens:
    ``transformer.prefill(frontend_embeds=...)`` into LM_MAX_LEN positions
    and LM_NEW greedy steps through ``steps.make_serve_step`` (the loop
    LMEngine runs), twice, identical; one ``LMEngine.generate`` on the
    text prompts alone, as the reference's engine serves the vlm family.
    Returns the flash launches of one patch-prefixed prefill by key."""
    from repro_torch.configs.llava_next_mistral_7b import CONFIG as LLAVA
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime.straggler import StragglerMonitor
    from repro_torch.serving.engine import LMEngine
    from repro_torch.train import steps as steps_mod

    cfg, name = LLAVA, "llava-next-mistral-7b"
    if cfg.n_frontend_tokens != LLAVA_PATCHES:
        raise AssertionError(f"llava has {cfg.n_frontend_tokens} patches")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LLAVA_TEXT)).astype(np.int32)
    toks = torch.from_numpy(prompts).to(dev)
    patches = patches_for(cfg, dev, torch.float32)
    family_parity("llava-parity", name,
                  cfg.replace(n_layers=FAMILY_PARITY_LAYERS,
                              dtype="float32"), toks, dev, patches,
                  full_depth=cfg.n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_lm(SEED, cfg, dev)
    torch.cuda.synchronize()
    n_bytes = weight_bytes(params)
    log(f"[llava-init] {name} {cfg.n_layers} layers, {cfg.dtype}, "
        f"{n_bytes / 1e9:.3f} GB of weights in "
        f"{time.perf_counter() - t0:.2f} s")
    patches = patches.to(torch.bfloat16)
    served_layers_check(params, cfg, toks, patches)
    prefill_ms = prefill_runs(params, cfg, toks, patches)
    profile_device(f"{name} one prefill with patches",
                   lambda: T.prefill(params, cfg, toks, patches,
                                     pad_to=LM_MAX_LEN))
    step = steps_mod.make_serve_step(cfg)
    monitor = StragglerMonitor()
    runs, by_key = [], None
    for run in range(2):
        ops.reset_launches()
        t_run = time.perf_counter()
        _, cache = T.prefill(params, cfg, toks, patches, pad_to=LM_MAX_LEN)
        if run == 0:
            by_key = dict(fa.FLASH.by_key)
        if cache["pos"] != LM_PROMPT:
            raise AssertionError(f"cache pos {cache['pos']}")
        tok, outs = toks[:, -1:], []
        for _ in range(LM_NEW):
            t0 = time.perf_counter()
            tok, cache = step(params, tok, cache)
            outs.append(tok.cpu().numpy())
            if run:
                monitor.observe(time.perf_counter() - t0)
        runs.append(np.concatenate(outs, axis=1))
        gen_s = time.perf_counter() - t_run
        del cache
    check_generated(runs[0], runs[1], cfg.vocab_size)
    want = {fa.launch_key(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0):
            cfg.n_layers}
    if by_key != want:
        raise AssertionError(f"the patch prefill launched flash {by_key}, "
                             f"not {want}")
    _, cache = T.prefill(params, cfg, toks, patches, pad_to=LM_MAX_LEN)
    profile_device(f"{name} one decode step",
                   lambda: step(params, toks[:, -1:], cache)[0].cpu())
    del cache
    emb = params["embed"]["table"]
    log_family_serve("llava-serve", name, cfg, n_bytes, prefill_ms, monitor,
                     gen_s, n_bytes - emb.numel() * emb.element_size(),
                     dense_prefill_flops(cfg, LM_BATCH, LM_PROMPT,
                                         LLAVA_PATCHES), card,
                     extra=f" ({LLAVA_PATCHES} patches + {LLAVA_TEXT} text "
                           "tokens)")
    log(f"[llava-serve] prefill + make_serve_step loop: tokens identical "
        f"across two runs; first row {runs[0][0].tolist()}; flash launches "
        f"of one prefill by (H, Kh, hd, window, causal) {by_key}")
    eng = LMEngine(params, cfg, max_len=LM_MAX_LEN, device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    text = eng.generate(prompts, LM_NEW)
    text_s = time.perf_counter() - t0
    if text.shape != (LM_BATCH, LM_NEW) or \
            fa.FLASH.launches != cfg.n_layers:
        raise AssertionError(f"text-only generate: shape {text.shape}, "
                             f"{fa.FLASH.launches} flash launches")
    log(f"[llava-serve] LMEngine.generate on the {LLAVA_TEXT}-token text "
        f"prompts alone (the reference's engine passes no patches): "
        f"{text_s * 1e3:.1f} ms, decode ms/token p50 "
        f"{eng.monitor.percentile(0.5) * 1e3:.3f}; first row "
        f"{text[0].tolist()}; the patches change the continuation: "
        f"{not np.array_equal(text, runs[0])}")
    del params, eng, patches
    torch.cuda.empty_cache()
    return by_key


def whisper_phase(dev, card):
    """Phase 18: whisper-tiny (4 encoder + 4 decoder layers).  In f32,
    ``api.forward`` on random (LM_BATCH, WHISPER_FRAMES, 80) frames and
    WHISPER_PROMPT-token prompts through the kernel against the plain
    attention (LM_TOL); in bf16, the same forward (finite logits; 4
    non-causal and 4 causal flash launches), then ``LMEngine.generate`` of
    the prompts and LM_NEW tokens, twice, identical (zero cross K/V, the
    prompt fed token by token, as the reference serves the audio family).
    Returns the flash launches of one bf16 forward by key."""
    from repro_torch.configs.whisper_tiny import CONFIG as WHISPER
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving.engine import LMEngine

    cfg = WHISPER
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    frames = torch.randn((LM_BATCH, WHISPER_FRAMES, cfg.d_frontend),
                         generator=gen, device=dev)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, WHISPER_PROMPT)).astype(np.int32)
    toks = torch.from_numpy(prompts).to(dev)
    f32 = cfg.replace(dtype="float32")
    params = api.init(SEED, f32, dev)
    batch = {"tokens": toks, "frames": frames}
    la, _ = api.forward(params, f32, batch)
    lr, _ = api.forward(params, f32, batch, attn_impl="ref")
    torch.testing.assert_close(la, lr, **LM_TOL)
    log(f"[whisper-parity] whisper-tiny full width and depth, f32, B "
        f"{LM_BATCH} x {WHISPER_FRAMES} frames, {WHISPER_PROMPT} decoder "
        f"tokens: kernel vs plain attention max_abs_err logits "
        f"{(la - lr).abs().max().item():.3e} (rtol = atol = 1e-4)")
    del params, la, lr
    params = api.init(SEED, cfg, dev)
    n_bytes = weight_bytes(params)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, _ = api.forward(params, cfg, batch)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    by_key = dict(fa.FLASH.by_key)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0)
    want = {fa.launch_key(*heads, False): cfg.n_encoder_layers,
            fa.launch_key(*heads, True): cfg.n_layers}
    if by_key != want:
        raise AssertionError(f"api.forward launched flash {by_key}, not "
                             f"{want}")
    if logits.shape != (LM_BATCH, WHISPER_PROMPT, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"forward logits {tuple(logits.shape)}, not "
                             "finite or misshapen")
    del logits
    eng = LMEngine(params, cfg, max_len=WHISPER_MAX_LEN, device=dev)
    first = eng.generate(prompts, LM_NEW)
    eng.monitor.reset()
    t0 = time.perf_counter()
    second = eng.generate(prompts, LM_NEW)
    gen_s = time.perf_counter() - t0
    check_generated(first, second, cfg.vocab_size)
    cache = api.make_cache(cfg, LM_BATCH, WHISPER_MAX_LEN, device=dev)
    log(f"[whisper-serve] whisper-tiny ({n_bytes / 1e6:.1f} MB of bf16 "
        f"weights): api.forward of B {LM_BATCH} x {WHISPER_FRAMES} frames "
        f"and {WHISPER_PROMPT} tokens {fwd_ms:.1f} ms (first call), flash "
        f"launches by (H, Kh, hd, window, causal) {by_key}; LMEngine "
        f"{WHISPER_PROMPT}-token prompts fed token by token + {LM_NEW} "
        f"greedy tokens (cross K/V over {cache['cross_k'].shape[2]} zero "
        f"frames): generate wall {gen_s * 1e3:.1f} ms, decode ms/token p50 "
        f"{eng.monitor.percentile(0.5) * 1e3:.3f} p99 "
        f"{eng.monitor.percentile(0.99) * 1e3:.3f}; tokens identical across "
        f"two runs; first row {first[0].tolist()}; card {card!r}")
    del params, eng, cache, frames
    torch.cuda.empty_cache()
    return by_key


# phase 19: the hybrid family, after whisper-tiny.  The flash kernel at
# zamba2-2.7b's served shape (hd 80) in bf16 and, at ZAMBA_F32_S, in f32;
# the smoke configs' hd 8 at the serve CLI's shape (SMOKE_B prompts of
# SMOKE_S tokens) and ``launch/serve.py --smoke`` on the card for the four
# archs whose smoke configs have it.  zamba2-2.7b at full width: f32
# parity at ZAMBA_PARITY_LAYERS (2 groups of 6 mamba layers) on the LM
# prompts (the plain attention's (B, H, S, S) f32 scores take 5.4 GB), and
# ZAMBA_DECODE_PROMPT tokens a row decoded one at a time against the same
# model's forward at the reference's 2e-3; bf16 at full depth: prefills of
# the LM prompts, then LMEngine on ZAMBA_GEN_PROMPT-token prompts fed token
# by token, as the reference's engine serves the hybrid family
ZAMBA_F32_S = 1024
ZAMBA_PARITY_LAYERS = 12
ZAMBA_DECODE_PROMPT = 128
ZAMBA_DECODE_TOL = {"rtol": 0.0, "atol": 2e-3}
ZAMBA_GEN_PROMPT = 64
SMOKE_ARCHS = ("chatglm3-6b", "qwen2-72b", "llava-next-mistral-7b",
               "granite-moe-3b-a800m")
SMOKE_B, SMOKE_S, SMOKE_HEADS = 4, 8, (8, 2, 8)
SSD_RANGE = "ssd.chunked"


def hybrid_flash_phase(dev):
    """Phase 19a: the flash kernel against its plain version at zamba2-2.7b's
    served shape (H = Kh = 32, hd 80, causal, B 2 x S LM_PROMPT) in bf16
    beside scaled_dot_product_attention, and in f32 at S ZAMBA_F32_S; at the
    smoke configs' hd 8 (zero-padded to 16 for the kernel) in f32 (the
    smoke configs' type: a row) and in bf16 (held, logged).  Returns the
    rows: (bf16 at hd 80, f32 at hd 80, f32 at hd 8), each with its launch
    key."""
    from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    heads = (ZAMBA.n_heads, ZAMBA.n_kv_heads, ZAMBA.head_dim)
    log(f"[zamba2-flash] device memory allocated at the phase's start "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    rows = [flash_row("flash_attention/zamba2_heads", gen, dev, LM_BATCH,
                      LM_PROMPT, *heads),
            flash_row("flash_attention/zamba2_heads_f32", gen, dev, LM_BATCH,
                      ZAMBA_F32_S, *heads, dtype=torch.float32),
            flash_row("flash_attention/smoke_hd8_f32", gen, dev, SMOKE_B,
                      SMOKE_S, *SMOKE_HEADS, dtype=torch.float32)]
    h, kh, hd = SMOKE_HEADS
    q, k, v = (torch.randn((SMOKE_B, SMOKE_S, n, hd), generator=gen,
                           device=dev).to(torch.bfloat16)
               for n in (h, kh, kh))
    out, again = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
    if not torch.equal(out, again):
        raise AssertionError("two bf16 hd-8 kernel runs differ")
    err, fro, _ = hold("bf16 hd 8", out, ref.flash_attention_ref(q, k, v),
                       FLASH_TOL, FLASH_REL)
    log(f"[kernel] flash_attention bf16 at hd 8 (padded to 16), B {SMOKE_B} "
        f"x S {SMOKE_S}, H {h} over Kh {kh}: max_abs_err {err:.3e}, relative "
        f"Frobenius error {fro:.3e}; two runs bit-identical")
    del q, k, v, out, again
    torch.cuda.empty_cache()
    return rows


def smoke_serve_phase():
    """Phase 19b: ``launch/serve.py --arch <arch> --smoke`` on the card (f32
    smoke configs, hd 8: each prefill launches the kernel once a layer)
    for SMOKE_ARCHS; returns the flash launches of the four runs by key."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    by_key: dict = {}
    for arch in SMOKE_ARCHS:
        cfg = get_arch(arch).smoke()
        if cfg.head_dim != 8:
            raise AssertionError(f"{arch}'s smoke config has hd "
                                 f"{cfg.head_dim}, not 8")
        ops.reset_launches()
        serve.main(["--arch", arch, "--smoke", "--tokens", "4"])
        want = {fa.launch_key(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0):
                cfg.n_layers}
        if dict(fa.FLASH.by_key) != want:
            raise AssertionError(f"{arch} --smoke launched flash "
                                 f"{dict(fa.FLASH.by_key)}, not {want}")
        for key, n in fa.FLASH.by_key.items():
            by_key[key] = by_key.get(key, 0) + n
    log(f"[zamba2-smoke] serve --smoke on the card ({', '.join(SMOKE_ARCHS)}"
        f"): hd 8, flash launches by (H, Kh, hd, window, causal) {by_key}")
    return by_key


def zamba2_parity_phase(dev):
    """Phase 19c: zamba2-2.7b at full width in f32, depth cut to
    ZAMBA_PARITY_LAYERS: the forward on the LM prompts through the kernel
    against the plain attention (logits, each shared invocation's K/V and
    each mamba layer's SSD state at LM_TOL); then ZAMBA_DECODE_PROMPT tokens
    a row decoded one at a time (``conv_step``/``ssd_recurrent``) against
    the same model's forward (``conv_full``/``ssd_chunked``) at the
    reference's 2e-3."""
    from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA
    from repro_torch.models import api
    from repro_torch.models import zamba2 as Z

    cfg = ZAMBA.replace(n_layers=ZAMBA_PARITY_LAYERS, dtype="float32")
    params = api.init(SEED, cfg, dev)
    toks = torch.from_numpy(lm_prompts(cfg.vocab_size)).to(dev)
    out = {}
    for impl in ("auto", "ref"):
        logits, _, ((k, v), st) = Z.forward(params, cfg, toks,
                                            collect_cache=True,
                                            attn_impl=impl)
        out[impl] = (logits, k, v, st["ssd"])
        del logits, k, v, st
        torch.cuda.empty_cache()
    errs = []
    for a, r in zip(out["auto"], out["ref"]):
        torch.testing.assert_close(a, r, **LM_TOL)
        errs.append((a - r).abs().max().item())
    log(f"[zamba2-parity] zamba2-2.7b full width, f32, depth cut "
        f"{ZAMBA.n_layers} -> {cfg.n_layers} layers ({Z.n_groups(cfg)} "
        f"shared invocations), B {LM_BATCH} x {LM_PROMPT} tokens: kernel vs "
        f"plain attention max_abs_err logits {errs[0]:.3e}, K {errs[1]:.3e}, "
        f"V {errs[2]:.3e}, SSD states {errs[3]:.3e} (rtol = atol = 1e-4)")
    del out
    torch.cuda.empty_cache()
    short = toks[:, :ZAMBA_DECODE_PROMPT]
    full, _ = api.forward(params, cfg, {"tokens": short})
    cache = api.make_cache(cfg, LM_BATCH, ZAMBA_DECODE_PROMPT, device=dev)
    outs = []
    for t in range(ZAMBA_DECODE_PROMPT):
        lg, cache = api.decode_step(params, cfg, short[:, t:t + 1], cache)
        outs.append(lg)
    dec = torch.cat(outs, 1)
    torch.testing.assert_close(dec, full, **ZAMBA_DECODE_TOL)
    log(f"[zamba2-parity] {ZAMBA_DECODE_PROMPT} tokens a row decoded one at "
        f"a time vs the forward (chunked SSD, {ZAMBA_DECODE_PROMPT // cfg.ssm.chunk}"
        f" chunk a row): max_abs_err {(dec - full).abs().max().item():.3e} "
        f"(atol 2e-3, the reference's), max |logit| "
        f"{full.abs().max().item():.3e}")
    del params, full, dec, outs, cache
    torch.cuda.empty_cache()


def hybrid_prefill_flops(cfg, b: int, s: int) -> dict:
    """Multiply-add flops (x2) of one prefill of ``b`` sequences of ``s``
    tokens as the hybrid path computes it, by kind: the bf16 GEMMs (each
    mamba layer's in/out projections, the shared block's q/k/v/o and GLU
    MLP at each of its invocations, the LM head on the last positions),
    the f32 SSD einsums of the chunk loop, and flash (4 hd a causal
    pair)."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import zamba2 as Z

    d, hd, h = cfg.d_model, cfg.head_dim, cfg.n_heads
    d_inner, nh, _ = M2.dims(cfg)
    n, p, c = cfg.ssm.d_state, cfg.ssm.head_dim, cfg.ssm.chunk
    t, g = b * s, Z.n_groups(cfg)
    d_in_proj = 2 * d_inner + 2 * n + nh
    mamba = 2 * t * d * d_in_proj + 2 * t * d_inner * d
    shared = 2 * t * d * (2 * h * hd + 2 * cfg.n_kv_heads * hd) + \
        6 * t * d * cfg.d_ff
    chunk = 2 * b * c * c * n + 2 * b * c * c * nh * p + \
        4 * b * c * n * nh * p
    return {"gemm": cfg.n_layers * mamba + g * shared
            + 2 * b * d * cfg.vocab_size,
            "ssd": cfg.n_layers * (s // c) * chunk,
            "flash": g * 4 * hd * admitted_pairs(s, 0) * b * h}


def zamba2_profile(label, fn):
    """One call of ``fn`` under the profiler, with the SSD chunk loop
    (``mamba2.ssd_chunked``) inside a range: device time split into the
    GEMMs outside the loop, the loop, flash and the rest, and the card's
    active share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import mamba2 as M2

    chunked = M2.ssd_chunked

    def ranged(*a, **kw):
        with record_function(SSD_RANGE):
            return chunked(*a, **kw)

    M2.ssd_chunked = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        M2.ssd_chunked = chunked
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.name != SSD_RANGE:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if not by_name:
        log(f"[zamba2-profile] {label}: the profiler saw no device activity:"
            " device time not measured")
        return
    busy = sum(by_name.values())
    in_ssd: dict = {}
    for name, us in range_kernels(prof, SSD_RANGE):
        in_ssd[name] = in_ssd.get(name, 0.0) + us
    ssd_us = sum(in_ssd.values())
    split = device_split({n: us - in_ssd.get(n, 0.0)
                          for n, us in by_name.items()})
    flash = sum(us for n, us in by_name.items() if "flash_" in n)
    log(f"[zamba2-profile] {label}: wall {wall_us:.0f} us, device activity "
        f"{busy:.0f} us ({100 * busy / wall_us:.1f}% of wall); GEMMs outside "
        f"the SSD loop {split['gemm']:.1f} us, SSD chunk loop {ssd_us:.1f} us "
        f"({len(in_ssd)} kernel names), flash {flash:.1f} us, the "
        f"rest {split['other'] - flash:.1f} us")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[zamba2-profile]   {us:10.1f} us  {name[:90]}")


def zamba2_serve_phase(dev, card):
    """Phase 19d: zamba2-2.7b (54 layers, bf16) at full width and depth:
    ``steps.make_prefill_step`` (``api.forward``) on the LM prompts, 3
    runs, each launching the flash kernel once per shared invocation (9);
    one prefill profiled; then ``LMEngine.generate`` of ZAMBA_GEN_PROMPT-
    token prompts (fed token by token) and LM_NEW tokens, twice,
    identical; one decode step profiled.  Returns the flash launches of
    one prefill by key."""
    from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models import zamba2 as Z
    from repro_torch.serving.engine import LMEngine
    from repro_torch.train import steps as steps_mod

    cfg = ZAMBA
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(SEED, cfg, dev)
    torch.cuda.synchronize()
    n_bytes = weight_bytes(params)
    log(f"[zamba2-init] zamba2-2.7b {cfg.n_layers} mamba layers + 1 shared "
        f"block x {Z.n_groups(cfg)} invocations, {cfg.dtype}, "
        f"{n_bytes / 1e9:.3f} GB of weights "
        f"({sum(a.numel() for a in _leaves(params)) / 1e9:.3f} B parameters)"
        f" in {time.perf_counter() - t0:.2f} s")
    batch = {"tokens": torch.from_numpy(lm_prompts(cfg.vocab_size)).to(dev)}
    step = steps_mod.make_prefill_step(cfg)
    want = {fa.launch_key(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0):
            Z.n_groups(cfg)}
    prefill_ms, by_key = [], None
    for _ in range(3):
        ops.reset_launches()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        by_key = dict(fa.FLASH.by_key)
        if fa.FLASH.launches != Z.n_groups(cfg) or by_key != want:
            raise AssertionError(f"prefill launched flash {by_key}, not "
                                 f"{want}")
        if logits.shape != (LM_BATCH, 1, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                                 "finite or of the wrong shape")
        del logits
    prefill_peak = torch.cuda.max_memory_allocated()
    zamba2_profile("one prefill", lambda: step(params, batch))

    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (LM_BATCH, ZAMBA_GEN_PROMPT)).astype(np.int32)
    eng = LMEngine(params, cfg, max_len=LM_MAX_LEN, device=dev)
    ops.reset_launches()
    first = eng.generate(prompts, LM_NEW)
    gen_launches = {k: v.launches for k, v in ops.kernels().items()}
    eng.monitor.reset()
    t0 = time.perf_counter()
    second = eng.generate(prompts, LM_NEW)
    gen_s = time.perf_counter() - t0
    check_generated(first, second, cfg.vocab_size)
    if any(gen_launches.values()):
        raise AssertionError(f"token-by-token decode launched {gen_launches}"
                             ": decode attention and the SSD recurrence are "
                             "plain, as in the reference")
    serve = steps_mod.make_serve_step(cfg)
    cache = api.make_cache(cfg, LM_BATCH, LM_MAX_LEN, device=dev)
    state_bytes = sum(cache[k].numel() * cache[k].element_size()
                      for k in ("conv", "ssd"))
    kv_bytes = sum(cache[k].numel() * cache[k].element_size()
                   for k in ("attn_k", "attn_v"))
    last = torch.from_numpy(prompts[:, -1:]).to(dev)
    profile_device("one zamba2-2.7b decode step",
                   lambda: serve(params, last, cache)[0].cpu(),
                   tag="zamba2-profile")
    del cache
    steps = sorted(eng.monitor.lat)
    warm = statistics.median(prefill_ms[1:])
    fl = hybrid_prefill_flops(cfg, LM_BATCH, LM_PROMPT)
    bound_ms = {"gemm": fl["gemm"] / BF16_FLOPS * 1e3,
                "ssd": fl["ssd"] / F32_FLOPS * 1e3,
                "flash": fl["flash"] / BF16_FLOPS * 1e3}
    emb = params["embed"]["table"]
    read = n_bytes - emb.numel() * emb.element_size()
    pct = lambda q: eng.monitor.percentile(q) * 1e3
    log(f"[zamba2-serve] zamba2-2.7b B {LM_BATCH} x {LM_PROMPT} tokens "
        f"(make_prefill_step): prefill ms {prefill_ms[0]:.1f} first, "
        f"{warm:.1f} warm ({LM_BATCH * LM_PROMPT / warm * 1e3:.0f} prefill "
        f"tokens/s) against a {sum(bound_ms.values()):.3f} ms bound (bf16 "
        f"GEMMs {bound_ms['gemm']:.3f} ms, {fl['gemm'] / 1e12:.3f} TFLOP at "
        f"989 TFLOP/s; f32 SSD einsums {bound_ms['ssd']:.3f} ms, "
        f"{fl['ssd'] / 1e12:.3f} TFLOP at 67 TFLOP/s; flash "
        f"{bound_ms['flash']:.3f} ms), {Z.n_groups(cfg)} flash launches "
        f"each, max_memory_allocated {prefill_peak / 1e9:.3f} GB; card "
        f"{card!r}")
    log(f"[zamba2-serve] LMEngine B {LM_BATCH} x prompt {ZAMBA_GEN_PROMPT} "
        f"(fed token by token), {LM_NEW} greedy tokens, cache {LM_MAX_LEN}: "
        f"decode ms/token p50 {pct(0.5):.3f} p99 {pct(0.99):.3f} min "
        f"{steps[0] * 1e3:.3f}; generated tokens/s "
        f"{LM_BATCH * LM_NEW / sum(steps):.1f} (decode steps only), generate "
        f"wall {gen_s * 1e3:.1f} ms (prompt {(gen_s - sum(steps)) * 1e3:.1f} "
        f"ms); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log(f"[zamba2-serve] tokens identical across two runs; first row "
        f"{first[0].tolist()}; kernel launches per generate {gen_launches}; "
        f"flash launches of one prefill by (H, Kh, hd, window, causal) "
        f"{by_key}")
    log(f"[zamba2-serve] decode weight-read bound "
        f"{read / HBM_BYTES_PER_S * 1e3:.3f} ms/token ({read / 1e9:.3f} GB "
        f"of weights a step at 3.35 TB/s; with the conv and SSD states read "
        f"and written, {2 * state_bytes / 1e9:.3f} GB, "
        f"{(read + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3:.3f} ms); the "
        f"cache's K/V {kv_bytes / 1e9:.3f} GB, SSD and conv states "
        f"{state_bytes / 1e6:.1f} MB")
    del params, eng
    torch.cuda.empty_cache()
    return by_key


# phase 20: training, after zamba2-2.7b, outside torch.no_grad().  The
# train_4k cell's sequence; its global batch of 256 cut to 2 (granite's
# train_accum of 2: two microbatches of 1); one warm-up step and three
# timed ones
TRAIN_ARCH = "granite-moe-3b-a800m"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 4
# the flash kernel's launches a full-depth step: 32 layers x 2 microbatches
# x (the forward and its remat recompute in the backward)
TRAIN_FLASH_PER_STEP = 128
# full width, depth cut: the kernel-vs-plain step and the checkpoint gate
# (2 layers: 3.3 GB of f32 state; the full 39.6 GB of params, m and v
# would take ~75 s a write at the 0.55 GB/s np.savez measured beside an
# H100 80GB HBM3)
TRAIN_CUT_LAYERS = 2
TRAIN_LOSS_REL, TRAIN_GNORM_REL = 1e-3, 1e-2
# the MoE backward scatters with accumulation, which may be atomic on the
# card: two runs of one step need not agree bit for bit
TRAIN_RESUME_REL = 1e-6
# the Function's gradients against autograd through the plain attention:
# bf16 operands and the bf16 rounding of p and ds (2^-8 relative each)
TRAIN_GRAD_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# lse against the plain version: f32 at 1e-5; bf16 (operands rounded
# alike, the kernel's ex2/tanh approximations) at 1e-3
LSE_TOL = {torch.bfloat16: {"rtol": 0.0, "atol": 1e-3},
           torch.float32: {"rtol": 0.0, "atol": 1e-5}}
# each body of B5: (label, B, S, H, Kh, hd, type, window, softcap, causal)
LSE_CASES = (
    ("wgmma_ws hd 64", 1, TRAIN_SEQ, 24, 8, 64, torch.bfloat16, 0, 0.0, True),
    ("wgmma_ws hd 80", 2, 1000, 8, 8, 80, torch.bfloat16, 0, 0.0, True),
    ("wgmma_ws hd 80, window, softcap", 1, 1100, 8, 2, 80, torch.bfloat16,
     300, 50.0, True),
    ("mma.sync hd 32", 2, 600, 4, 2, 32, torch.bfloat16, 0, 0.0, True),
    ("wgmma hd 128", 1, 1100, 16, 8, 128, torch.bfloat16, 0, 0.0, True),
    ("wgmma hd 256, window, softcap", 1, 1100, 16, 8, 256, torch.bfloat16,
     300, 50.0, True),
    ("f32 hd 64", 1, 1024, 24, 8, 64, torch.float32, 0, 0.0, True),
    ("f32 hd 80, window, softcap", 2, 500, 4, 2, 80, torch.float32, 64,
     30.0, True),
    ("f32 hd 8 padded", 4, 8, 8, 2, 8, torch.float32, 0, 0.0, True))
TRAIN_PROFILE = ("train.flash_bwd", "train.optimizer", "moe.experts",
                 "moe.dispatch")
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"


def plain_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Attention in f32 out of place (autograd through it is the yardstick
    of the Function's gradients): the function of ``ref.flash_attention_
    ref`` without its in-place steps."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kh, h // kh, hd)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * hd ** -0.5
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= (qi - kj) < window
    p = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, hd)


def lse_phase(dev):
    """Phase 20a: each body of B5 asked for lse: lse against the plain
    version's, and the output bit-identical to a serving call's (null lse)
    on the same inputs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    for label, b, s, h, kh, hd, dt, window, cap, causal in LSE_CASES:
        q, k, v = ((torch.randn((b, s, n, hd), generator=gen, device=dev)
                    * sc).to(dt)
                   for n, sc in ((h, FLASH_Q_SCALE), (kh, 1.0), (kh, 1.0)))
        kw = {"causal": causal, "window": window, "softcap": cap}
        served = fa.attend(q, k, v, **kw)
        out, lse = fa.attend(q, k, v, return_lse=True, **kw)
        plain, plain_lse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                                   **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, served):
            raise AssertionError(f"lse {label}: the output with lse differs "
                                 f"from the serving call's")
        err, _, _ = hold(f"lse {label}", lse, plain_lse, LSE_TOL[dt])
        out_err = (out.float() - plain.float()).abs().max().item()
        log(f"[train-lse] {label}: B {b} S {s} H {h} over Kh {kh}, {dt}, "
            f"window {window}, softcap {cap}: lse max_abs_err {err:.3e} "
            f"(atol {LSE_TOL[dt]['atol']}), output bit-identical to the "
            f"null-lse call, output vs plain {out_err:.3e}")
        del q, k, v, served, out, lse, plain, plain_lse
    torch.cuda.empty_cache()


# the CPU model of the hd 64/80 body's tile walk held against the kernel on
# the card: (label, B, S, H, Kh, hd, window, causal)
TILED_CASES = (("hd 64", 1, TRAIN_SEQ, 24, 8, 64, 0, True),
               ("hd 80, window 300", 2, 1000, 8, 8, 80, 300, True))


def tiled_model_phase(dev):
    """Phase 20a': ``ref.flash_attention_tiled_ref`` (the hd 64/80 body's
    tile walk: 128 x 128 tiles from the window's start rounded down, f32
    running max and sum, the scale folded into exp2, P rounded to bf16
    before P V, hd 80's P V in columns 0-63 and 64-79) run on the card
    against the kernel in bf16, output at FLASH_TOL and FLASH_REL and lse
    at LSE_TOL, beside the plain version's distance from the kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    for label, b, s, h, kh, hd, window, causal in TILED_CASES:
        q, k, v = ((torch.randn((b, s, n, hd), generator=gen, device=dev)
                    * sc).to(torch.bfloat16)
                   for n, sc in ((h, FLASH_Q_SCALE), (kh, 1.0), (kh, 1.0)))
        kw = {"causal": causal, "window": window}
        out, lse = fa.attend(q, k, v, return_lse=True, **kw)
        model, model_lse = ref.flash_attention_tiled_ref(
            q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        err, fro, _ = hold(f"tiled model {label}", out, model, FLASH_TOL,
                           FLASH_REL)
        lse_err, _, _ = hold(f"tiled model {label} lse", lse, model_lse,
                             LSE_TOL[torch.bfloat16])
        _, plain_fro, _ = errors(out, ref.flash_attention_ref(q, k, v, **kw),
                                 FLASH_TOL["rtol"])
        log(f"[train-lse] tiled model {label}: B {b} S {s} H {h} over Kh "
            f"{kh}, bf16: kernel vs model max_abs_err {err:.3e}, relative "
            f"Frobenius error {fro:.3e} (the plain version's {plain_fro:.3e})"
            f", lse max_abs_err {lse_err:.3e}")
        del q, k, v, out, lse, model, model_lse
    torch.cuda.empty_cache()


def flash_grads(q, k, v, dout):
    """(the Function's dq, dk, dv; autograd through the plain attention's),
    both from one cotangent."""
    from repro_torch.kernels import ops

    qs = [x.detach().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention_op(*qs), qs, dout)
    ps = [x.detach().float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(plain_attention(*ps), ps, dout.float())
    return got, want


def train_flash_phase(dev):
    """Phase 20b: FlashAttentionFn's gradients at granite's train shape (B
    1, S 4096, H 24 over Kh 8, hd 64, bf16) and in f32 at S 1024 against
    autograd through the plain attention; the kernel with lse timed at the
    train shape beside its plain version and SDPA, the plain backward
    beside SDPA's forward and backward.  Returns the row."""
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    h, kh, hd = GRANITE.n_heads, GRANITE.n_kv_heads, GRANITE.head_dim
    for s, dt in ((TRAIN_SEQ, torch.bfloat16), (1024, torch.float32)):
        q, k, v = ((torch.randn((1, s, n, hd), generator=gen, device=dev)
                    * sc).to(dt)
                   for n, sc in ((h, FLASH_Q_SCALE), (kh, 1.0), (kh, 1.0)))
        dout = torch.randn((1, s, h, hd), generator=gen, device=dev).to(dt)
        got, want = flash_grads(q, k, v, dout)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            if a.dtype != dt or a.shape != w.shape:
                raise AssertionError(f"{name}: {a.dtype} {tuple(a.shape)}")
            fro = ((a.float() - w).norm() / w.norm()).item()
            if not fro <= TRAIN_GRAD_REL[dt]:
                raise AssertionError(f"FlashAttentionFn {name} at S {s} "
                                     f"{dt}: relative Frobenius error "
                                     f"{fro:.3e} > {TRAIN_GRAD_REL[dt]}")
            log(f"[train-flash] FlashAttentionFn {name} at B 1 S {s} H {h} "
                f"over Kh {kh} hd {hd} {dt}: relative Frobenius error "
                f"{fro:.3e} (gate {TRAIN_GRAD_REL[dt]}) against autograd "
                f"through the plain attention")
        del q, k, v, dout, got, want
        torch.cuda.empty_cache()

    # the train row: the kernel asked for lse, at the train shape
    q, k, v = ((torch.randn((1, TRAIN_SEQ, n, hd), generator=gen,
                            device=dev) * sc).to(torch.bfloat16)
               for n, sc in ((h, FLASH_Q_SCALE), (kh, 1.0), (kh, 1.0)))
    dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)

    def sdpa(q=q, k=k, v=v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    row = check_kernel(
        "flash_attention/granite_train_lse",
        "src/repro/kernels/flash_attention.py:97",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        lambda: fa.attend(q, k, v, return_lse=True)[0],
        lambda: ref.flash_attention_ref(q, k, v), sdpa,
        n_bytes=q.element_size() * (2 * q.numel() + 2 * k.numel())
        + 4 * q.shape[0] * h * TRAIN_SEQ,
        flops=4 * hd * admitted_pairs(TRAIN_SEQ, 0) * h, flush=None,
        tol=FLASH_TOL, rel=FLASH_REL, peak_flops=BF16_FLOPS)
    row["serving_ms"] = time_ms(lambda: fa.attend(q, k, v))
    out, lse = fa.attend(q, k, v, return_lse=True)
    row["plain_bwd_ms"] = time_ms(
        lambda: flash_attention_bwd(q, k, v, out, lse, dout), reps=5,
        warmup=1)
    qs = [x.detach().requires_grad_() for x in (q, k, v)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(
            qs[0].transpose(1, 2), qs[1].transpose(1, 2),
            qs[2].transpose(1, 2), is_causal=True,
            enable_gqa=True).transpose(1, 2)
        torch.autograd.grad(o, qs, dout)

    row["library_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
    row["shape"] = (f"B 1, S {TRAIN_SEQ}, H {h} over Kh {kh}, hd {hd}, "
                    f"causal, bf16, with lse")
    log(f"[train-flash] {row['name']}: kernel with lse {row['ms']:.4f} ms "
        f"(null lse {row['serving_ms']:.4f} ms), "
        f"SDPA forward {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms; plain backward (chunks of 1024, f32 "
        f"sums) {row['plain_bwd_ms']:.4f} ms beside SDPA forward + backward "
        f"{row['library_fwd_bwd_ms']:.4f} ms")
    del q, k, v, dout, out, lse, qs
    torch.cuda.empty_cache()
    return row


def train_batch(cfg, dev, index=0, batch=None, seq=None):
    """Batch ``index`` of ``launch/train.py``'s seeded stream, on ``dev``
    (TRAIN_BATCH x TRAIN_SEQ unless given)."""
    from repro_torch.launch import train as train_mod

    data = train_mod.synthetic_batches(cfg, batch or TRAIN_BATCH,
                                       seq or TRAIN_SEQ, index + 1, SEED)
    return {k: v.to(dev) for k, v in list(data)[index].items()}


def train_cut_phase(dev):
    """Phase 20c: granite-moe-3b-a800m at full width, depth cut to
    TRAIN_CUT_LAYERS: one train step with the kernel against one with the
    plain attention from the same parameters (loss 1e-3, grad_norm 1e-2
    relative); then ``launch/train.py``'s loop for 3 steps saving its
    checkpoint after step 2, that checkpoint restored bit for bit, and a
    run resumed from it whose step 3 matches step 3 of the uninterrupted
    state (1e-6 relative)."""
    import shutil

    from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE
    from repro_torch.launch import train as train_mod
    from repro_torch.models import api
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_mod

    cfg = GRANITE.replace(n_layers=TRAIN_CUT_LAYERS)
    batch = train_batch(cfg, dev)
    metrics = {}
    for impl in ("auto", "ref"):
        params = api.init(SEED, cfg, dev, n_shards=1, dtype="float32")
        step = steps_mod.make_train_step(cfg, accum_steps=cfg.train_accum,
                                         attn_impl=impl)
        _, state, m = step(params, opt.adamw_init(params), batch)
        metrics[impl] = {k: float(v) for k, v in m.items()}
        del params, state
        torch.cuda.empty_cache()
    for key, rel in (("loss", TRAIN_LOSS_REL), ("grad_norm",
                                               TRAIN_GNORM_REL)):
        a, b = metrics["auto"][key], metrics["ref"][key]
        if not (np.isfinite(a) and abs(a - b) <= rel * abs(b)):
            raise AssertionError(f"cut-depth step {key}: kernel {a} vs plain "
                                 f"{b} (relative gate {rel})")
    log(f"[train-cut] {TRAIN_ARCH} at {TRAIN_CUT_LAYERS} layers, full width, "
        f"B {TRAIN_BATCH} x S {TRAIN_SEQ} in {cfg.train_accum} microbatches: "
        f"kernel step {metrics['auto']} vs plain attention {metrics['ref']}")

    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    quiet = lambda *a: None  # noqa: E731
    t0 = time.perf_counter()
    first = train_mod.train(cfg, steps=3, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                            ckpt_dir=str(TRAIN_CKPT_DIR), device=dev,
                            log=quiet)
    save_s = time.perf_counter() - t0
    state = (first.params, first.opt_state)
    n_bytes = sum(x.numel() * x.element_size() for x in opt.leaves(state))
    if ckpt.latest_step(str(TRAIN_CKPT_DIR)) != 2 or \
            int(first.opt_state["count"]) != 3:
        raise AssertionError("the 3-step run did not leave step 2's "
                             "checkpoint")
    t0 = time.perf_counter()
    resumed = train_mod.train(cfg, steps=4, batch=TRAIN_BATCH,
                              seq=TRAIN_SEQ, ckpt_dir=str(TRAIN_CKPT_DIR),
                              device=dev, log=log)
    resume_s = time.perf_counter() - t0
    if resumed.start != 3 or [h[0] for h in resumed.history] != [3]:
        raise AssertionError(f"resumed at {resumed.start}: "
                             f"{resumed.history}")
    resumed.params = resumed.opt_state = None
    restored, step_no = ckpt.restore(str(TRAIN_CKPT_DIR), state, step=2)
    for a, b in zip(opt.leaves(restored), opt.leaves(state)):
        if not torch.equal(a, b):
            raise AssertionError("step 2's checkpoint does not restore bit "
                                 "for bit")
    del restored
    step = steps_mod.make_train_step(cfg, accum_steps=cfg.train_accum)
    _, _, m = step(first.params, first.opt_state, train_batch(cfg, dev, 3))
    want, got = float(m["loss"]), resumed.history[0][1]
    if not abs(got - want) <= TRAIN_RESUME_REL * abs(want):
        raise AssertionError(f"resumed step 3 loss {got!r} vs uninterrupted "
                             f"{want!r}")
    log(f"[train-ckpt] {TRAIN_ARCH} at {TRAIN_CUT_LAYERS} layers: "
        f"{n_bytes / 1e9:.3f} GB of f32 state; 3 steps with the save after "
        f"step 2 {save_s:.1f} s, the resumed run (restore, step 3, save) "
        f"{resume_s:.1f} s; step 2 restored bit for bit; step 3 loss resumed "
        f"{got!r} vs uninterrupted {want!r} "
        f"(relative {abs(got - want) / abs(want):.2e}, gate "
        f"{TRAIN_RESUME_REL})")
    del first, state
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


def train_smoke_phase(dev):
    """Phase 20d: one train step of every LM family's smoke config on the
    card (f32): B5 (hd 8 padded for most) and, for rwkv6, B6 under
    autograd; loss and grad_norm finite, the kernels launched."""
    from repro_torch.configs.base import get_arch, list_archs
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_mod

    lines = []
    for arch in [a for a in list_archs() if not a.startswith("dlrm")]:
        cfg = get_arch(arch).smoke()
        params = api.init(SEED, cfg, dev, n_shards=1, dtype="float32")
        batch = train_batch(cfg, dev, batch=2, seq=32)
        ops.reset_launches()
        _, state, m = steps_mod.make_train_step(cfg)(
            params, opt.adamw_init(params), batch)
        launches = {k: v.launches for k, v in ops.kernels().items()
                    if v.launches}
        want = "rwkv6_wkv" if cfg.family == "ssm" else "flash_attention"
        if not (np.isfinite(float(m["loss"])) and
                np.isfinite(float(m["grad_norm"])) and launches.get(want)):
            raise AssertionError(f"{arch} smoke step: {m}, launches "
                                 f"{launches}")
        lines.append(f"{arch} (hd {cfg.head_dim}) loss "
                     f"{float(m['loss']):.4f} launches {launches}")
        del params, state
    log("[train-smoke] one step each on the card: " + "; ".join(lines))
    torch.cuda.empty_cache()


def train_profile(label, fn):
    """One call of ``fn`` under the profiler with ranges around the plain
    flash backward, the optimizer (clip and AdamW), the MoE dispatch and
    the expert GEMMs; the MoE ops' backward kernels are found through the
    autograd nodes' sequence numbers.  Returns device us by class and the
    wall us."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops
    from repro_torch.models import moe as M
    from repro_torch.train import optimizer as opt

    saved = {(ops, "flash_attention_bwd"): TRAIN_PROFILE[0],
             (opt, "clip_by_global_norm"): TRAIN_PROFILE[1],
             (opt, "adamw_update"): TRAIN_PROFILE[1],
             (M, "_expert_mlp"): TRAIN_PROFILE[2],
             (M, "_moe_local"): TRAIN_PROFILE[3]}
    real = {key: getattr(*key) for key in saved}

    def ranged(name, fn_):
        def call(*a, **kw):
            with record_function(name):
                return fn_(*a, **kw)
        return call

    for (mod, attr), name in saved.items():
        setattr(mod, attr, ranged(name, real[(mod, attr)]))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for (mod, attr), f in real.items():
            setattr(mod, attr, f)
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type != cuda]

    def walk(e):
        stack = [e]
        while stack:
            x = stack.pop()
            yield x
            stack.extend(x.cpu_children)

    def is_gemm(name):
        low = name.lower()
        return any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma",
                                      "sm90_"))

    # each range's kernels (the profiler's per-op kernel records), once:
    # the first range that claims an op keeps it (experts inside dispatch)
    claimed, fwd = set(), {TRAIN_PROFILE[2]: set(), TRAIN_PROFILE[3]: set()}
    work = {name: [] for name in TRAIN_PROFILE}
    for name in TRAIN_PROFILE:
        for r in (e for e in events if e.name == name):
            for x in walk(r):
                if id(x) in claimed:
                    continue
                claimed.add(id(x))
                work[name] += [(k.name, k.duration) for k in x.kernels
                               if k.name not in TRAIN_PROFILE]
                if name in fwd and x.sequence_nr >= 0:
                    fwd[name].add((x.thread, x.sequence_nr))
    # the backward of the MoE ops: autograd nodes whose sequence numbers
    # are those of the forward ops inside the ranges
    for e in events:
        if not e.name.startswith("autograd::engine::evaluate_function"):
            continue
        name = next((n for n in fwd
                     if (e.fwd_thread, e.sequence_nr) in fwd[n]), None)
        if name is None:
            continue
        for x in walk(e):
            if id(x) not in claimed:
                claimed.add(id(x))
                work[name] += [(k.name, k.duration) for k in x.kernels]
    split = {"gemm": 0.0, "flash_fwd": 0.0,
             "flash_bwd": sum(us for _, us in work[TRAIN_PROFILE[0]]),
             "moe_dispatch": sum(us for _, us in work[TRAIN_PROFILE[3]]),
             "expert_gemm": sum(us for _, us in work[TRAIN_PROFILE[2]]),
             "optimizer": sum(us for _, us in work[TRAIN_PROFILE[1]]),
             "other": 0.0}
    ranged_gemm = sum(us for name in TRAIN_PROFILE for k, us in work[name]
                      if is_gemm(k))
    busy, n_kernels = 0.0, 0
    for e in prof.events():
        if e.device_type != cuda or e.name in TRAIN_PROFILE:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        n_kernels += 1
        if "flash_" in e.name:
            split["flash_fwd"] += us
        elif is_gemm(e.name):
            split["gemm"] += us
    split["gemm"] -= ranged_gemm
    split["other"] = busy - sum(split.values())
    if not busy:
        log(f"[train-profile] {label}: the profiler saw no device activity: "
            "device time not measured")
        return None, wall_us
    log(f"[train-profile] {label}: wall {wall_us:.0f} us under the "
        f"profiler, device activity {busy:.0f} us ({100 * busy / wall_us:.1f}"
        f"% of that wall), {n_kernels} device operations; by class (us): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + "; gemm is outside the ranges (expert_gemm: the experts' batched "
        "products forward, recompute and backward)")
    return split, busy


def train_flops(cfg, tokens: int, b: int, s: int) -> dict:
    """The step's flop bound's terms: 8 flops a matmul parameter a token
    (forward, remat recompute, backward) over the active parameters (the
    attention projections, the router and experts_per_token experts a
    layer, the tied LM head), and 4 hd flops an admitted pair x (1 + 1 +
    2.5) for attention."""
    moe = cfg.moe
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * (2 * cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd)
    experts = moe.experts_per_token * 3 * d * moe.d_expert
    active = cfg.n_layers * (attn + d * moe.n_experts + experts) \
        + cfg.vocab_size * d
    pairs = admitted_pairs(s, 0) * b * cfg.n_heads * cfg.n_layers
    return {"active_params": active,
            "matmul": 8 * active * tokens,
            "attention": 4 * hd * pairs * (1 + 1 + 2.5)}


def train_full_phase(dev, card):
    """Phase 20e: full-width, full-depth granite-moe-3b-a800m through
    ``launch/train.py``'s loop: TRAIN_STEPS steps of B TRAIN_BATCH x S
    TRAIN_SEQ in 2 microbatches, f32 masters and AdamW on the card.  Loss
    and grad_norm finite, count equal to the steps, parameters moved, the
    flash kernel launched TRAIN_FLASH_PER_STEP times a step; step p50 over
    the steps after the first, tokens/s, peak memory, one more step
    profiled.  Returns the flash launches a step."""
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_mod

    cfg = GRANITE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(SEED, cfg, dev, n_shards=1, dtype="float32")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in opt.leaves(params))
    init_s = time.perf_counter() - t0
    probe = {"embed": params["embed"]["table"][:4].clone(),
             "gate": params["layers"]["sub0"]["ffn"]["gate"][0, 0, :4]
             .clone()}
    key = fa.launch_key(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0, True)
    ops.reset_launches()
    run = train_mod.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, device=dev, params=params, log=log)
    launches = {k: v.launches for k, v in ops.kernels().items()}
    by_key = dict(fa.FLASH.by_key)
    peak = torch.cuda.max_memory_allocated()
    if by_key != {key: TRAIN_FLASH_PER_STEP * TRAIN_STEPS} or \
            launches["flash_attention"] != TRAIN_FLASH_PER_STEP * TRAIN_STEPS:
        raise AssertionError(f"{TRAIN_STEPS} steps launched {launches}, "
                             f"flash by key {by_key}: not "
                             f"{TRAIN_FLASH_PER_STEP} a step")
    losses = [h[1] for h in run.history]
    norms = [h[2] for h in run.history]
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    if int(run.opt_state["count"]) != TRAIN_STEPS:
        raise AssertionError(f"count {int(run.opt_state['count'])}")
    if torch.equal(run.params["embed"]["table"][:4], probe["embed"]) or \
            torch.equal(run.params["layers"]["sub0"]["ffn"]["gate"][0, 0, :4],
                        probe["gate"]):
        raise AssertionError("the parameters did not move")
    times = [h[4] for h in run.history]
    p50 = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fl = train_flops(cfg, tokens, TRAIN_BATCH, TRAIN_SEQ)
    bound_ms = (fl["matmul"] + fl["attention"]) / BF16_FLOPS * 1e3
    log(f"[train] {TRAIN_ARCH} full width and depth ({cfg.n_layers} layers, "
        f"{n_params:,} parameters in f32, init {init_s:.1f} s), B "
        f"{TRAIN_BATCH} x S {TRAIN_SEQ} in {cfg.train_accum} microbatches, "
        f"remat {cfg.remat}, {TRAIN_STEPS} steps: losses {losses}, grad norms "
        f"{norms}, lr {[h[3] for h in run.history]}; step s "
        f"{[round(t, 4) for t in times]}; p50 of steps 1-{TRAIN_STEPS - 1} "
        f"{p50 * 1e3:.1f} ms, {tokens / p50:.0f} tokens/s; "
        f"max_memory_allocated {peak / 1e9:.3f} GB; card {card!r}")
    log(f"[train] flash launches by (H, Kh, hd, window, causal) {by_key} = "
        f"{TRAIN_FLASH_PER_STEP} a step; launches {launches}")
    log(f"[train] flop bound: {fl['active_params']:,} active matmul "
        f"parameters ({cfg.moe.experts_per_token} of {cfg.moe.n_experts} "
        f"experts of d_expert "
        f"{cfg.moe.d_expert}, the tied head), 8 x that x {tokens} tokens = "
        f"{fl['matmul'] / 1e12:.2f} TFLOP, attention {fl['attention'] / 1e12:.3f}"
        f" TFLOP: {bound_ms:.2f} ms at 989 TFLOP/s; the p50 step is "
        f"{p50 * 1e3 / bound_ms:.1f}x it")
    step = steps_mod.make_train_step(cfg, accum_steps=cfg.train_accum)
    batch = train_batch(cfg, dev, TRAIN_STEPS)
    state = [run.params, run.opt_state]

    def one_step():
        state[0], state[1], m = step(state[0], state[1], batch)
        float(m["loss"])

    split, busy = train_profile("one step", one_step)
    if split is not None:
        log("[train-profile] shares of the device time: " + ", ".join(
            f"{k} {100 * v / busy:.1f}%" for k, v in split.items())
            + f"; device activity {busy / 1e3:.1f} ms against the "
            f"unprofiled step p50 {p50 * 1e3:.1f} ms "
            f"({100 * busy / 1e3 / (p50 * 1e3):.1f}%)")
    del run, state, params
    torch.cuda.empty_cache()
    return TRAIN_FLASH_PER_STEP


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
    if sys.argv[1:2] == ["--member"]:
        return member_main(sys.argv[2:])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.chatglm3_6b import CONFIG as GLM
    from repro_torch.configs.dlrm_kaggle import CONFIG
    from repro_torch.configs.qwen2_72b import CONFIG as QWEN72
    from repro_torch.kernels import _build
    from repro_torch.models.dlrm import init_dlrm

    t_start = time.perf_counter()

    def lap(what):
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

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
        lap("dlrm")
        # the LM phases need the card's memory: drop the 7.33 GB stack
        del params
        torch.cuda.empty_cache()
        flash_rows = flash_phase(dev)
        lm_parity_phase(dev)
        _, by_key = lm_serve_phase(dev, card)
        lap("gemma2")
        # the rwkv6 phases need the card's memory: gemma2-9b went with
        # lm_serve_phase's frame
        torch.cuda.empty_cache()
        wkv_rows = wkv_phase(dev)
        rwkv_parity_phase(dev)
        wkv_by_key = rwkv_serve_phase(dev, card)
        lap("rwkv6")
        # rwkv6-1.6b over 2 members on this card: the one-device model went
        # with rwkv_serve_phase's frame
        torch.cuda.empty_cache()
        ssm_row = members_ssm_phase(dev, card)
        lap("members-ssm")
        # the qwen2-moe phases need the card's memory
        torch.cuda.empty_cache()
        p1 = moe_parity_phase(dev)
        moe_by_key, p1_serve = moe_serve_phase(dev, card)
        p1.update(p1_serve)
        lap("qwen2-moe")
        # qwen2-moe-a2.7b over 2 members on this card (two processes over
        # gloo): the one-device model went with moe_serve_phase's frame
        torch.cuda.empty_cache()
        members_row = members_serve_phase(dev, card, p1)
        lap("members-serve")
        del p1, p1_serve
        # the rest of the attention families, one model on the card at a
        # time: qwen2-moe-a2.7b went with moe_serve_phase's frame
        torch.cuda.empty_cache()
        family_rows = families_flash_phase(dev)
        glm_by_key = dense_family_phase("glm", GLM, dev, card)
        lap("chatglm3")
        llava_by_key = llava_phase(dev, card)
        lap("llava")
        q72_by_key = dense_family_phase(
            "qwen72", QWEN72, dev, card, n_layers=QWEN72_LAYERS,
            parity_layers=QWEN72_PARITY_LAYERS)
        lap("qwen2-72b")
        whisper_by_key = whisper_phase(dev, card)
        # the hybrid family, one model on the card at a time: whisper-tiny
        # went with whisper_phase's frame
        torch.cuda.empty_cache()
        (zamba_row, zkey), (zamba_f32_row, _), (hd8_row, hd8_key) = \
            hybrid_flash_phase(dev)
        smoke_by_key = smoke_serve_phase()
        zamba2_parity_phase(dev)
        zamba_by_key = zamba2_serve_phase(dev, card)
        lap("whisper, zamba2")
        # zamba2-2.7b over 2 members on this card: the one-device model
        # went with zamba2_serve_phase's frame
        torch.cuda.empty_cache()
        hybrid_row = members_hybrid_phase(dev, card)
        lap("members-hybrid")
        # the training phases need the card's memory
        torch.cuda.empty_cache()
        lse_phase(dev)
        tiled_model_phase(dev)
    # training runs with grad enabled
    train_row = train_flash_phase(dev)
    train_cut_phase(dev)
    train_smoke_phase(dev)
    train_row["launches"] = train_full_phase(dev, card)
    lap("train")
    # the training phases over members (two processes on this card)
    torch.cuda.empty_cache()
    members_train_phase(dev, card)
    lap("members-train")
    members_elastic_phase(dev, card)
    # each flash or WKV row takes the served launches of its own shape:
    # qwen3's heads and the B 8 WKV shape are timed but not served, so
    # their rows read 0; each new family's row its phase's run (one
    # generate for chatglm3 and qwen2-72b, one patch-prefixed prefill for
    # llava, one api.forward for whisper's encoder and decoder)
    served = (by_key, moe_by_key, glm_by_key, llava_by_key, q72_by_key,
              whisper_by_key)
    for row, key in flash_rows + family_rows:
        row["launches"] = sum(k.get(key, 0) for k in served)
        rows.append(row)
    # launch keys carry no type: zamba2's bf16 row reads one served
    # prefill, its f32 row 0 (the served model is bf16), the hd-8 row the
    # four f32 smoke serves
    zamba_row["launches"] = zamba_by_key.get(zkey, 0)
    hd8_row["launches"] = smoke_by_key.get(hd8_key, 0)
    rows += [zamba_row, zamba_f32_row, hd8_row, train_row, members_row,
             hybrid_row, ssm_row]
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
