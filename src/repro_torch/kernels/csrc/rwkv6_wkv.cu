// RWKV-6 WKV with data-dependent decay, written by hand for Hopper (sm_90a).
//
// Replaces B6, the Pallas kernel _kernel (:34) of
// src/repro/kernels/rwkv6_wkv.py (pallas_call at :94, wkv_chunked_pallas).
// For r, k, logw (B, S, H, K), v (B, S, H, V), u (H, K) and state0
// (B, H, K, V), all float32 with K = V = 64 and logw <= 0, every (b, h)
// runs the recurrence
//   out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//   S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,   S_{-1} = state0,
// and the kernel returns out (B, S, H, V) and S_{S-1} (B, H, K, V).
//
// What bounds it on the H100: bytes.  At the served rwkv6-1.6b prefill
// (B 1, S 32768, H 32) the function reads r, k, v and logw and writes out
// once: 1.34 GB, 0.40 ms at 3.35 TB/s, against about 4 K V flops per token
// and head, 0.26 ms of the f32 pipes.  The TPU kernel walked the chunks of
// a (b, h) as its sequential grid axis, carried the (K, V) state in VMEM
// scratch, and built the (C, C, K) in-chunk decay in VMEM.
//
// Design: two passes over chunks of C = 32 tokens, split along what is
// truly sequential.  With L_t the inclusive cumulative log-decay of a chunk
// (base 2 inside the kernel):
//   pass 1, the state pass, grid (b, h, 16-column value slice), walks the
//     chunks in order and carries only the recurrence
//       S <- diag(2^L_{C-1}) S + sum_s (k_s * 2^(L_{C-1} - L_s)) v_s^T,
//     writing the state at the start of every chunk to a scratch tensor
//     (B, H, n_chunks, K, V) and the final state to the output.  No
//     pairwise score is formed there: a chunk is one rank-C update.  Warps
//     0-3 apply chunk c's update while warps 4-7 form chunk c + 1's decayed
//     keys, and a loader warp keeps up to five chunks' rows in flight by
//     TMA, so one barrier a chunk is the whole sequential chain.
//   pass 2, the output pass, grid (chunk, b * h), fully parallel (32,768
//     blocks at the served prefill): each block forms its chunk's 32 x 32
//     pairwise scores once for all 64 value columns (in 2 x 2 blocks, two
//     threads to a block over the halves of k) and writes
//       out_t = (r_t * 2^L_{t-1}) . S_c + sum_{s<t} score_ts v_s
//               + (r_t . (u * k_t)) v_t
//     from the chunk-start state S_c, each thread accumulating four rows
//     of two value columns.
// Rows arrive by TMA (one instruction a tile; cp.async of 16 bytes a
// thread spent more issue slots on the copies than the products took);
// the output pass's rows land 128-byte swizzled, so the scores' reads of
// eight rows at one column lie in distinct banks.  The scratch costs
// B H S/C K V 4 bytes (537 MB at the served prefill), written once and
// read once: 0.32 ms of traffic beside the function's own bytes.  C = 64
// would halve it but double the pairs per chunk of the output pass, whose
// exponentials already take longer than its bytes; C = 32 is kept.
// What bounds it now (H100 SXM, found by removing one part at a time):
// the state pass's 1,024-step chain, about 1,400 cycles a chunk, of which
// the row loads and the barrier alone take a third (four slice blocks of a
// head each load its k and w), the decay of the next chunk's keys most of
// the rest; in the output pass, the 32 x 32 x 64 exponentials and their
// operand loads take 0.48 of its 1.13 ms at the served prefill and the
// cross term 0.24.  Neither pass is near the function's 0.40 ms of bytes.
// Every exponent is a difference of cumulative log-decays L_a - L_s with
// s <= a, so it is <= 0 and nothing overflows, however fast the decay: the
// pairwise decay is exponentiated per (t, s, k) and never factorised into
// 2^L_t 2^-L_s.  Products run on the CUDA cores in float32 FMA.  No
// atomics: one thread owns each output, state and scratch element, so two
// runs give the same bits.  Any S >= 1: the tensor maps zero-fill rows
// past S of each sequence (r = k = v = logw = 0 leaves the state as it
// is), and those rows are not written.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 64;                  // key width (head size)
constexpr int kV = 64;                  // value width
constexpr int kC = 32;                  // tokens per chunk
constexpr int kThreads = 256;         // the output pass
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed; a
// wait that never ends (a fault of the pipeline) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint32_t spins = 0;
  do {
    if (++spins == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map (cols, H, S, B) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// pass 1: the chunk-start states
// ---------------------------------------------------------------------------

constexpr int kVS = 16;                 // value columns per block
constexpr int kSlices = kV / kVS;
constexpr int kKR = 2, kCV = 4;         // keys x columns per update thread
constexpr int kUpdateThreads = (kK / kKR) * (kVS / kCV);
constexpr int kDecayWarps = 4;          // decay warps
constexpr int kStateThreads = kUpdateThreads + 32 * kDecayWarps;
constexpr int kStateBlock = kStateThreads + 32;   // and the loader warp
constexpr int kBufs = 5;                // chunk j in buffer j % kBufs

struct alignas(128) StateSmem {
  float k[kBufs][kC][kK];               // dense rows, as TMA writes them
  float w[kBufs][kC][kK];
  float v[kBufs][kC][kVS];
  float kd[2][kC][kK];                  // k_s * 2^(L_{C-1} - L_s)
  float etot[2][kK];                    // 2^L_{C-1}
  float later[kK];                      // the second half's log-decay sums
  uint64_t full[kBufs];                 // chunk rows landed
  uint64_t done[kBufs];                 // every warp is done with them
};

// The decay warps (4-7): chunk c's decayed keys and total decay from its
// staged k and w.  A dense TMA row puts column j in bank j % 32 whatever
// the row, so each warp reads 32 columns of one row at a time: warp 4 + q
// owns columns 32 (q & 1) .. + 31 over tokens 16 (q >> 1) .. + 15.  The
// suffix sums sum_{t' > t} logw_t' run backwards; the first half of the
// tokens adds the second half's total, passed through shared memory.
__device__ __forceinline__ void decay_keys(StateSmem& sm, int buf, int out,
                                           int tid) {
  const int q = (tid - kUpdateThreads) >> 5;
  const int j = 32 * (q & 1) + (tid & 31), half = q >> 1, tb = 16 * half;
  float wv[16], sfx[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) wv[i] = sm.w[buf][tb + i][j];
  float acc = 0.0f;
#pragma unroll
  for (int i = 15; i >= 0; --i) {
    sfx[i] = acc;
    acc += wv[i];
  }
  if (half) sm.later[j] = acc;
  // the four decay warps only
  asm volatile("bar.sync 2, %0;\n" ::"n"(32 * kDecayWarps) : "memory");
  const float add = half ? 0.0f : sm.later[j];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    sm.kd[out][tb + i][j] =
        sm.k[buf][tb + i][j] * ex2((sfx[i] + add) * kLog2e);
  if (!half) sm.etot[out][j] = ex2((acc + add) * kLog2e);
}

__global__ void __launch_bounds__(kStateBlock)
wkv_state_pass(const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ s0, float* __restrict__ starts,
               float* __restrict__ sout, int s, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  StateSmem& sm = *reinterpret_cast<StateSmem*>(
      smem_raw + (((raw + 127) & ~127u) - raw));
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / kSlices;
  const int v0 = (blockIdx.x % kSlices) * kVS;
  const int b = bh / h, hh = bh % h;
  const int n_chunks = (s + kC - 1) / kC;
  constexpr int kBytes = (2 * kK + kVS) * kC * 4;

  // the loader warp's lane 0 fetches chunk c's rows into buffer c % kBufs
  // once every compute warp is done with the chunk it held
  auto load = [&](int c) {
    const int buf = c % kBufs;
    const uint32_t bar = smem_addr(&sm.full[buf]);
    mbar_wait(smem_addr(&sm.done[buf]), ((c / kBufs) & 1) ^ 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, kBytes);
    tma_load(&sm.k[buf][0][0], &tk, bar, 0, hh, c * kC, b);
    tma_load(&sm.w[buf][0][0], &tw, bar, 0, hh, c * kC, b);
    tma_load(&sm.v[buf][0][0], &tv, bar, v0, hh, c * kC, b);
  };
  auto wait_rows = [&](int c) {
    mbar_wait(smem_addr(&sm.full[c % kBufs]), (c / kBufs) & 1);
  };
  // the compute warps' barrier (the loader warp runs on its own)
  auto sync_compute = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kStateThreads) : "memory");
  };
  if (tid == 0) {
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(smem_addr(&sm.full[i]), 1);
      mbar_init(smem_addr(&sm.done[i]), kStateThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kStateThreads) {
    if (tid == kStateThreads)
      for (int c = 0; c < n_chunks; ++c) load(c);
    return;
  }

  // the update warps own the state: key rows kr .. kr + kKR - 1 and
  // columns cv .. cv + kCV - 1
  const int kr = (tid / (kVS / kCV)) * kKR, cv = (tid % (kVS / kCV)) * kCV;
  float st[kKR][kCV];
  float* const s_row =
      starts + ((int64_t)bh * n_chunks * kK + kr) * kV + v0 + cv;
  const bool updater = tid < kUpdateThreads;
  if (updater) {
#pragma unroll
    for (int r = 0; r < kKR; ++r)
#pragma unroll
      for (int i = 0; i < kCV; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(
            s0 + ((int64_t)bh * kK + kr + r) * kV + v0 + cv + i);
        st[r][i] = a.x; st[r][i + 1] = a.y; st[r][i + 2] = a.z;
        st[r][i + 3] = a.w;
      }
  }
  wait_rows(0);
  if (!updater) decay_keys(sm, 0, 0, tid);

  for (int c = 0; c < n_chunks; ++c) {
    // chunk c + 1's rows have landed; chunk c's decayed keys are written;
    // every read of the buffer refilled below (chunk c - 1's) is done
    if (c + 1 < n_chunks) wait_rows(c + 1);
    sync_compute();
    if (updater) {
      float* out = s_row + (int64_t)c * kK * kV;
      const int buf = c % kBufs, kb = c & 1;
#pragma unroll
      for (int r = 0; r < kKR; ++r) {
#pragma unroll
        for (int i = 0; i < kCV; i += 4)
          *reinterpret_cast<float4*>(out + r * kV + i) =
              make_float4(st[r][i], st[r][i + 1], st[r][i + 2], st[r][i + 3]);
        const float e = sm.etot[kb][kr + r];
#pragma unroll
        for (int i = 0; i < kCV; ++i) st[r][i] *= e;
      }
      // eight tokens' operands are loaded before their products, so the
      // shared-memory latency is paid once per eight
#pragma unroll
      for (int sp0 = 0; sp0 < kC; sp0 += 8) {
        float kk[8][kKR], vv[8][kCV];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* kp = &sm.kd[kb][sp0 + j][kr];
          if constexpr (kKR == 1) {
            kk[j][0] = kp[0];
          } else if constexpr (kKR == 2) {
            const float2 x = *reinterpret_cast<const float2*>(kp);
            kk[j][0] = x.x; kk[j][1] = x.y;
          } else {
            const float4 x = *reinterpret_cast<const float4*>(kp);
            kk[j][0] = x.x; kk[j][1] = x.y; kk[j][2] = x.z; kk[j][3] = x.w;
          }
#pragma unroll
          for (int i = 0; i < kCV; i += 4) {
            const float4 x = *reinterpret_cast<const float4*>(
                &sm.v[buf][sp0 + j][cv + i]);
            vv[j][i] = x.x; vv[j][i + 1] = x.y; vv[j][i + 2] = x.z;
            vv[j][i + 3] = x.w;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < kKR; ++r)
#pragma unroll
            for (int i = 0; i < kCV; ++i)
              st[r][i] = fmaf(kk[j][r], vv[j][i], st[r][i]);
      }
    } else if (c + 1 < n_chunks) {
      decay_keys(sm, (c + 1) % kBufs, (c + 1) & 1, tid);
    }
    // chunk c's rows are read: v by this chunk's update, k and w by the
    // last iteration's decay
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(smem_addr(&sm.done[c % kBufs]));
  }

  if (updater) {
#pragma unroll
    for (int r = 0; r < kKR; ++r)
#pragma unroll
      for (int i = 0; i < kCV; i += 4)
        *reinterpret_cast<float4*>(sout + ((int64_t)bh * kK + kr + r) * kV +
                                   v0 + cv + i) =
            make_float4(st[r][i], st[r][i + 1], st[r][i + 2], st[r][i + 3]);
  }
}

// ---------------------------------------------------------------------------
// pass 2: every chunk's outputs from its chunk-start state
// ---------------------------------------------------------------------------

// A chunk tile of 32 rows x 64 columns as TMA writes it with the 128-byte
// swizzle: two boxes of 32 columns, each row 128 bytes whose 16-byte
// pieces are permuted by the row's low three bits.
constexpr int kTileFloats = kC * kK;

__device__ __forceinline__ int sw(int t, int j) {
  return (j >> 5) * (kC * 32) + t * 32 + ((((j & 31) >> 2) ^ (t & 7)) << 2) +
         (j & 3);
}

// Row t of a tile (1024-aligned) as a key for lds4: its shared address
// with the row's swizzle already folded into bits 4-6.
__device__ __forceinline__ uint32_t row_key(const float* tile, int t) {
  return (smem_addr(tile) + t * 128) ^ ((t & 7) << 4);
}

// columns 4 q .. 4 q + 3 of the row given by row_key: one xor with a
// constant once q is unrolled
__device__ __forceinline__ float4 lds4(uint32_t key, int q) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"((key ^ ((q & 7) << 4)) + (q >> 3) * (kC * 128)));
  return v;
}

struct alignas(1024) OutSmem {
  float r[kTileFloats];
  union {
    float k[kTileFloats];
    float at[kK][kC];                   // after the scores: (r_t 2^L_{t-1})^T
  };
  float lin[kTileFloats];               // logw, then L_t (base 2)
  float v[kTileFloats];
  float state[kK][kV];                  // the chunk-start state
  float mix[kC][kC + 4];                // [s][t]: score_ts for s < t, the u
                                        // bonus for s = t, 0 for s > t
  float u[kK];
  float bonus[kC];
  uint64_t full;
};

// The strict lower triangle of the 32 x 32 scores: the 120 2 x 2 blocks
// below the diagonal (rows 2a, 2a + 1 against columns 2b, 2b + 1, b < a),
// each shared by two threads over a half of k, and the 16 scores
// (2a + 1, 2a) on it, one thread each over all of k: 256 threads.
constexpr int kOffBlocks = (kC / 2) * (kC / 2 - 1) / 2;

__device__ __forceinline__ void off_block(int i, int* a, int* b) {
  int row = 1;
  while ((row + 1) * row / 2 <= i) ++row;
  *a = row;
  *b = i - row * (row - 1) / 2;
}

// acc + the sum over four k of r_k k_k 2^(la_k - l_k)
__device__ __forceinline__ float score4(float acc, float4 r, float4 la,
                                        float4 k, float4 l) {
  acc = fmaf(r.x * k.x, ex2(la.x - l.x), acc);
  acc = fmaf(r.y * k.y, ex2(la.y - l.y), acc);
  acc = fmaf(r.z * k.z, ex2(la.z - l.z), acc);
  return fmaf(r.w * k.w, ex2(la.w - l.w), acc);
}

__global__ void __launch_bounds__(kThreads, 4)
wkv_output_pass(const __grid_constant__ CUtensorMap tr,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ u, const float* __restrict__ starts,
                float* __restrict__ out, int s, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern follows address bits, so the tiles sit 1024-aligned
  const uint32_t raw = smem_addr(smem_raw);
  OutSmem& sm = *reinterpret_cast<OutSmem*>(
      smem_raw + (((raw + 1023) & ~1023u) - raw));
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int n_chunks = gridDim.x;
  const int b = bh / h, hh = bh % h;
  const int64_t stride = (int64_t)h * kK;
  const int64_t row0 = (int64_t)b * s * stride + (int64_t)hh * kK;
  const int t0 = c * kC;

  const uint32_t bar = smem_addr(&sm.full);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar, 4 * kTileFloats * 4 + kK * kV * 4 + kK * 4);
    const CUtensorMap* maps[4] = {&tr, &tk, &tw, &tv};
    float* tiles[4] = {sm.r, sm.k, sm.lin, sm.v};
    for (int i = 0; i < 4; ++i)
      for (int half = 0; half < 2; ++half)
        tma_load(tiles[i] + half * kC * 32, maps[i], bar, 32 * half, hh, t0,
                 b);
    bulk_load(&sm.state[0][0], starts + ((int64_t)bh * n_chunks + c) * kK * kV,
              kK * kV * 4, bar);
    bulk_load(sm.u, u + hh * kK, kK * 4, bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);

  // 1. warps 0-3: L_t in place of logw (lane l of warp q owns column
  //    16 q + (l & 15) over the 16 tokens of half l >> 4); warps 4-7: the
  //    u bonus, four lanes a token
  if (tid < 128) {
    const int j = (tid >> 5) * 16 + (lane & 15);
    const int half = lane >> 4, tb = half * 16;
    float lv[16];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc += sm.lin[sw(tb + i, j)];
      lv[i] = acc;
    }
    const float tot0 = __shfl_up_sync(0xffffffffu, acc, 16);
    const float add = half ? tot0 : 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) sm.lin[sw(tb + i, j)] = (lv[i] + add) * kLog2e;
  } else {
    const int t = (tid - 128) >> 2, q = (tid & 3) * 16;
    float acc = 0.0f;
#pragma unroll
    for (int j = q; j < q + 16; ++j)
      acc = fmaf(sm.r[sw(t, j)] * sm.u[j], sm.k[sw(t, j)], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if ((tid & 3) == 0) sm.bonus[t] = acc;
  }
  __syncthreads();

  // 2. the pairwise scores, once for all value columns
  if (tid < 2 * kOffBlocks) {
    int a, bb;
    off_block(tid >> 1, &a, &bb);
    const int t0 = 2 * a, t1 = t0 + 1, s0 = 2 * bb, s1 = s0 + 1;
    const int q0 = (tid & 1) * (kK / 8);
    const uint32_t r0 = row_key(sm.r, t0), r1 = row_key(sm.r, t1);
    const uint32_t l0 = row_key(sm.lin, t0 - 1), l1 = row_key(sm.lin, t0);
    const uint32_t k0 = row_key(sm.k, s0), k1 = row_key(sm.k, s1);
    const uint32_t m0 = row_key(sm.lin, s0), m1 = row_key(sm.lin, s1);
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
#pragma unroll
    for (int q = 0; q < kK / 8; ++q) {
      const float4 x0 = lds4(r0, q0 + q), x1 = lds4(r1, q0 + q);
      const float4 la0 = lds4(l0, q0 + q), la1 = lds4(l1, q0 + q);
      const float4 y0 = lds4(k0, q0 + q), y1 = lds4(k1, q0 + q);
      const float4 n0 = lds4(m0, q0 + q), n1 = lds4(m1, q0 + q);
      a00 = score4(a00, x0, la0, y0, n0);
      a01 = score4(a01, x0, la0, y1, n1);
      a10 = score4(a10, x1, la1, y0, n0);
      a11 = score4(a11, x1, la1, y1, n1);
    }
    // the two halves of k sit in neighbouring lanes
    const unsigned mask = tid < 2 * kOffBlocks - 16 ? 0xffffffffu : 0xffffu;
    a00 += __shfl_xor_sync(mask, a00, 1);
    a01 += __shfl_xor_sync(mask, a01, 1);
    a10 += __shfl_xor_sync(mask, a10, 1);
    a11 += __shfl_xor_sync(mask, a11, 1);
    if ((tid & 1) == 0) {
      sm.mix[s0][t0] = a00;
      sm.mix[s1][t0] = a01;
      sm.mix[s0][t1] = a10;
      sm.mix[s1][t1] = a11;
    }
  } else {
    const int t1 = 2 * (tid - 2 * kOffBlocks) + 1, s0 = t1 - 1;
    const uint32_t r1 = row_key(sm.r, t1), l1 = row_key(sm.lin, s0);
    const uint32_t k0 = row_key(sm.k, s0);
    float a10 = 0.0f;
#pragma unroll
    for (int q = 0; q < kK / 4; ++q)
      a10 = score4(a10, lds4(r1, q), lds4(l1, q), lds4(k0, q), lds4(l1, q));
    sm.mix[s0][t1] = a10;
  }
  __syncthreads();

  // 3. r decayed from the chunk's start, transposed over k (no longer
  //    read); the bonus on the diagonal of mix and zeros above it
  for (int e = tid; e < kC * kK; e += kThreads) {
    const int t = e % kC, j = e / kC;
    sm.at[j][t] = sm.r[sw(t, j)] * (t ? ex2(sm.lin[sw(t - 1, j)]) : 1.0f);
  }
  for (int e = tid; e < kC * kC; e += kThreads) {
    const int t = e % kC, s2 = e / kC;
    if (s2 >= t) sm.mix[s2][t] = s2 == t ? sm.bonus[t] : 0.0f;
  }
  __syncthreads();

  // 4. rows 4 g .. 4 g + 3 (g = warp) of value columns 2 l, 2 l + 1 (l =
  //    lane): per k or token, one 16-byte load the warp shares and one
  //    8-byte load feed eight FMAs
  const int tr4 = 4 * (tid >> 5), c2 = 2 * lane;
  float o[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  auto accumulate = [&](const float* rows4, float2 x) {
    const float4 p = *reinterpret_cast<const float4*>(rows4);
    o[0][0] = fmaf(p.x, x.x, o[0][0]); o[0][1] = fmaf(p.x, x.y, o[0][1]);
    o[1][0] = fmaf(p.y, x.x, o[1][0]); o[1][1] = fmaf(p.y, x.y, o[1][1]);
    o[2][0] = fmaf(p.z, x.x, o[2][0]); o[2][1] = fmaf(p.z, x.y, o[2][1]);
    o[3][0] = fmaf(p.w, x.x, o[3][0]); o[3][1] = fmaf(p.w, x.y, o[3][1]);
  };
#pragma unroll 8
  for (int j = 0; j < kK; ++j)
    accumulate(&sm.at[j][tr4],
               *reinterpret_cast<const float2*>(&sm.state[j][c2]));
  for (int s2 = 0; s2 < tr4 + 4; ++s2)
    accumulate(&sm.mix[s2][tr4],
               *reinterpret_cast<const float2*>(&sm.v[sw(s2, c2)]));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (t0 + tr4 + i < s)
      *reinterpret_cast<float2*>(out + row0 + (t0 + tr4 + i) * stride + c2) =
          make_float2(o[i][0], o[i][1]);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver call: fetched through the runtime, so
// the library links against the runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A float32 (B, S, H, 64) tensor as a 4-d map (64, H, S, B): boxes of
// `cols` columns x one head x 32 tokens x one sequence; tokens past S read
// as zeros, per sequence
bool make_map(CUtensorMap* map, const void* ptr, int b, int s, int h,
              int cols, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)h * kK * 4;
  const cuuint64_t dims[4] = {(cuuint64_t)kK, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)kK * 4, row, row * s};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)kC, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

}  // namespace

// scratch: (B, H, ceil(S / 32), 64, 64) float32, the chunk-start states.
// passes: 1 the state pass, 2 the output pass (reads the scratch the state
// pass wrote), 3 both in order (the WKV).  Returns a cudaError_t.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* logw, const void* u,
                                const void* state0, void* out, void* state,
                                void* scratch, int b, int s, int h,
                                int passes, void* stream) {
  const int n_chunks = (s + kC - 1) / kC;
  // the output pass's grid is (n_chunks, B H)
  if (b < 1 || s < 1 || h < 1 || passes < 1 || passes > 3 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (passes & 1) {
    CUtensorMap tk, tw, tv;
    if (!make_map(&tk, k, b, s, h, kK, false) ||
        !make_map(&tw, logw, b, s, h, kK, false) ||
        !make_map(&tv, v, b, s, h, kVS, false))
      return (int)cudaErrorNotSupported;
    const size_t smem = sizeof(StateSmem) + 128;
    cudaError_t err = allow_smem(wkv_state_pass, smem);
    if (err != cudaSuccess) return (int)err;
    wkv_state_pass<<<b * h * kSlices, kStateBlock, smem, st>>>(
        tk, tw, tv, static_cast<const float*>(state0),
        static_cast<float*>(scratch), static_cast<float*>(state), s, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    CUtensorMap tr, tk, tw, tv;
    if (!make_map(&tr, r, b, s, h, 32, true) ||
        !make_map(&tk, k, b, s, h, 32, true) ||
        !make_map(&tw, logw, b, s, h, 32, true) ||
        !make_map(&tv, v, b, s, h, 32, true))
      return (int)cudaErrorNotSupported;
    const size_t smem = sizeof(OutSmem) + 1024;
    cudaError_t err = allow_smem(wkv_output_pass, smem);
    if (err != cudaSuccess) return (int)err;
    wkv_output_pass<<<dim3(n_chunks, b * h), kThreads, smem, st>>>(
        tr, tk, tw, tv, static_cast<const float*>(u),
        static_cast<const float*>(scratch), static_cast<float*>(out), s, h);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the state pass (1) or the output pass (2).
extern "C" int rwkv6_wkv_smem(int pass) {
  return pass == 1 ? (int)(sizeof(StateSmem) + 128)
                   : (int)(sizeof(OutSmem) + 1024);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
