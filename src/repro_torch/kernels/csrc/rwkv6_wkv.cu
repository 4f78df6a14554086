// RWKV-6 WKV with data-dependent decay, written by hand for Hopper (sm_90a).
//
// Replaces B6, the Pallas kernel _kernel (:34) of
// src/repro/kernels/rwkv6_wkv.py (pallas_call at :94, wkv_chunked_pallas).
// For r, k, logw (B, S, H, K), v (B, S, H, V), u (H, K) and state0
// (B, H, K, V) with logw <= 0, every (b, h) runs the recurrence
//   out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//   S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,   S_{-1} = state0,
// and the kernel returns out (B, S, H, V) and S_{S-1} (B, H, K, V).
//
// The domain (the reference kernel's, whose BlockSpecs take any K and V):
// any K, V >= 1; r, k, v and out in one type T, float32, bfloat16 or
// float16; logw in T or in float32; u, state0, the state and the scratch
// in float32.  Every T is widened to f32 as it leaves shared memory (the
// reference widens on load too), the products, sums and exponentials are
// the f32 body's in the f32 body's order, and the output store rounds once
// to T (round to nearest even).  So the T kernel's output is the f32
// kernel's output on the widened inputs rounded once to T, bit for bit,
// and its state is that kernel's state, bit for bit.
//
// Widths.  A width up to 128 runs at the next of 32, 64 and 128, past 128
// at the next multiple of 32 (padded_width), with zero columns added: a
// padded key column has r = k = logw = u = 0 and state0 rows 0, so its
// decay is 2^0 = 1, its decayed key 0, its state rows stay 0 and every FMA
// on it adds an exact 0; a padded value column has v = 0 and gives zero
// output and state columns, which are not stored.  The tensor maps take
// the rows' true width and boxes of the padded one, so TMA zero-fills the
// columns past a row (a row whose bytes are not a multiple of 16, TMA's
// stride, is copied padded by the wrapper); an f32 box of 32 columns that
// lies wholly past the row is not loaded but zeroed by the threads.  u,
// state0, the state and the scratch are laid out at the padded widths.  A
// padded width past 128 is cut into tiles, so the passes' shapes stay the
// ones built for K, V in {32, 64, 128}: a block's shared memory holds one
// tile of K and one of V (at K = V = 256 the output pass's chunk-start
// state alone would be 256 KB, the state pass's buffers past 227 KB).  V
// into tiles of 128, 64 or 32 columns (the largest that divides it,
// tile_width), K into key slices of 64 or 32 (key_tile_width): an output
// pass that walks key slices of 128 spilled 8 to 24 bytes even at 255
// registers.
//
// What bounds it on the H100: bytes.  At the served rwkv6-1.6b prefill
// (B 1, S 32768, H 32, K = V = 64, f32) the function reads r, k, v and logw
// and writes out once: 1.34 GB, 0.40 ms at 3.35 TB/s, against about 4 K V
// flops per token and head, 0.26 ms of the f32 pipes.  The TPU kernel
// walked the chunks of a (b, h) as its sequential grid axis, carried the
// (K, V) state in VMEM scratch, and built the (C, C, K) in-chunk decay in
// VMEM.
//
// Design: two passes over chunks of C = 32 tokens, split along what is
// truly sequential.  With L_t the inclusive cumulative log-decay of a chunk
// (base 2 inside the kernel):
//   pass 1, the state pass, grid (b, h, key slice, 16-column value slice),
//     walks the chunks in order and carries only the recurrence
//       S <- diag(2^L_{C-1}) S + sum_s (k_s * 2^(L_{C-1} - L_s)) v_s^T,
//     writing the state at the start of every chunk to a scratch tensor
//     (B, H, n_chunks, K, V) and the final state to the output.  No
//     pairwise score is formed there: a chunk is one rank-C update.  A
//     key row's recurrence reads only its own column's decay and key, so
//     the key rows are cut into slices of the K tile over the grid.  Four
//     update warps apply chunk c's update (each thread K / 32 key rows of
//     four columns) while K / 16 decay warps form chunk c + 1's decayed keys
//     (32 columns of 16 tokens a warp), and a loader warp keeps up to five
//     chunks' rows in flight by TMA, so one barrier a chunk is the whole
//     sequential chain.  T rows stay T in shared memory and are widened as
//     the decay and update warps read them.
//   pass 2, the output pass, grid (chunk, b * h, value slice of the V
//     tile), fully parallel (32,768 blocks at the served prefill): each
//     block forms its chunk's 32 x 32 pairwise scores once for all its
//     value columns (in 2 x 2 blocks, two threads to a block over the
//     halves of k) and writes
//       out_t = (r_t * 2^L_{t-1}) . S_c + sum_{s<t} score_ts v_s
//               + (r_t . (u * k_t)) v_t
//     from the chunk-start state S_c, each thread accumulating four rows
//     of V / 32 value columns.  Past a K of 128 the block walks the key
//     slices in order (kSliced), loading each slice's r, k, logw, u and
//     rows of S_c and adding its part of the scores, the bonus and the
//     cross term to sums that stay in registers; v, the intra-chunk term
//     and the stores follow once.  Each value slice recomputes the scores:
//     the output pass's exponentials and score products are paid vt / V
//     times (twice at V = 256, four times at 512).  T rows land by TMA in a
//     staging buffer and one widening copy writes them into the f32 tiles
//     the body reads; an f32 logw beside T rows lands in its tile directly.
// Rows arrive by TMA (one instruction a tile; cp.async of 16 bytes a
// thread spent more issue slots on the copies than the products took);
// the output pass's f32 tiles are 128-byte swizzled, so the scores' reads
// of eight rows at one column lie in distinct banks.  The scratch costs
// B H S/C K V 4 bytes (537 MB at the served prefill), written once and
// read once: 0.32 ms of traffic beside the function's own bytes.  C = 64
// would halve it but double the pairs per chunk of the output pass, whose
// exponentials already take longer than its bytes; C = 32 is kept.  At
// B 8, S 4096, H 8, K = V = 256 the scratch is 2.15 GB (B H S/32 K V 4
// bytes), at H 4, K = V = 512 4.29 GB: it grows with K V, where the
// function's own bytes grow with K + V.  At
// K = V = 128 the output pass's chunk-start state alone is 64 KB, so one
// block fits an SM where four do at 64.
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
// atomics: one thread owns each output, state and scratch element, and a
// key slice's sums are added in slice order, so two runs give the same
// bits.  Any S >= 1: the tensor maps zero-fill rows
// past S of each sequence (r = k = v = logw = 0 leaves the state as it
// is), and those rows are not written.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                  // tokens per chunk
constexpr int kThreads = 256;           // the output pass
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// element types: widened exactly on the way out of shared memory, rounded
// once on the way out of the kernel
// ---------------------------------------------------------------------------

template <typename T> constexpr bool kIsF32 = false;
template <> constexpr bool kIsF32<float> = true;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// four consecutive elements: 16 bytes of f32, or 8 of a 2-byte type
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&x.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void narrow(float* o, float x) { *o = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void narrow(__half* o, float x) {
  *o = __float2half_rn(x);
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

// one box of a 2-d tensor map (cols, rows) into shared memory
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
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
constexpr int kCV = 4;                  // columns per update thread
constexpr int kUpdateThreads = 128;     // (K / kKR) x (kVS / kCV)
constexpr int kBufs = 5;                // chunk j in buffer j % kBufs

template <int K>
struct StateShape {
  static constexpr int kKR = K / 32;            // key rows per update thread
  static constexpr int kGroups = K / 32;        // 32-column groups of a row
  static constexpr int kDecayWarps = 2 * kGroups;   // x two halves of C
  static constexpr int kThreads = kUpdateThreads + 32 * kDecayWarps;
  static constexpr int kBlock = kThreads + 32;  // and the loader warp
};

template <int K, typename T>
struct alignas(128) StateSmem {
  T k[kBufs][kC][K];                    // dense rows, as TMA writes them
  float w[kBufs][kC][K];                // logw: f32 rows, or T rows packed
                                        // at the start of each buffer
  T v[kBufs][kC][kVS];
  float kd[2][kC][K];                   // k_s * 2^(L_{C-1} - L_s)
  float etot[2][K];                     // 2^L_{C-1}
  float later[K];                       // the second half's log-decay sums
  uint64_t full[kBufs];                 // chunk rows landed
  uint64_t done[kBufs];                 // every warp is done with them
};

// The decay warps: chunk c's decayed keys and total decay from its staged
// k and w.  A dense row of 32 columns puts them in distinct banks (or
// halves of banks) whatever the row, so each warp reads 32 columns of one
// row at a time: decay warp q owns columns 32 (q % kGroups) .. + 31 over
// tokens 16 (q / kGroups) .. + 15.  The suffix sums sum_{t' > t} logw_t'
// run backwards; the first half of the tokens adds the second half's
// total, passed through shared memory.
template <int K, typename T>
__device__ __forceinline__ void decay_keys(StateSmem<K, T>& sm, int buf,
                                           int out, int tid, bool w32) {
  using Shape = StateShape<K>;
  const int q = (tid - kUpdateThreads) >> 5;
  const int j = 32 * (q % Shape::kGroups) + (tid & 31);
  const int half = q / Shape::kGroups, tb = 16 * half;
  float wv[16], sfx[16];
  if (kIsF32<T> || w32) {
#pragma unroll
    for (int i = 0; i < 16; ++i) wv[i] = sm.w[buf][tb + i][j];
  } else {
    const T* wt = reinterpret_cast<const T*>(&sm.w[buf][0][0]);
#pragma unroll
    for (int i = 0; i < 16; ++i) wv[i] = widen(wt[(tb + i) * K + j]);
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 15; i >= 0; --i) {
    sfx[i] = acc;
    acc += wv[i];
  }
  if (half) sm.later[j] = acc;
  // the decay warps only
  asm volatile("bar.sync 2, %0;\n" ::"n"(32 * Shape::kDecayWarps) : "memory");
  const float add = half ? 0.0f : sm.later[j];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    sm.kd[out][tb + i][j] =
        widen(sm.k[buf][tb + i][j]) * ex2((sfx[i] + add) * kLog2e);
  if (!half) sm.etot[out][j] = ex2((acc + add) * kLog2e);
}

// nv and kt: the padded value and key widths (the state's row length and
// its rows); a head's key rows are cut into kt / K slices of K rows, each
// run by `vslices` blocks of kVS value columns (the columns of v that hold
// a value: past them the state's columns are never read into a stored
// output, and are left unwritten); w32: logw is f32 (always, for T = float)
template <int K, typename T>
__global__ void __launch_bounds__(StateShape<K>::kBlock)
wkv_state_pass(const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ s0, float* __restrict__ starts,
               float* __restrict__ sout, int s, int h, int nv, int kt,
               int vslices, int w32) {
  using Shape = StateShape<K>;
  constexpr int kKR = Shape::kKR;
  constexpr int kStateThreads = Shape::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  StateSmem<K, T>& sm = *reinterpret_cast<StateSmem<K, T>*>(
      smem_raw + (((raw + 127) & ~127u) - raw));
  const int tid = threadIdx.x;
  const int per_bh = vslices * (kt / K);
  const int bh = blockIdx.x / per_bh;
  const int slice = blockIdx.x - bh * per_bh;
  const int k0 = (slice / vslices) * K;   // the block's key rows
  const int v0 = (slice % vslices) * kVS;
  const int b = bh / h, hh = bh % h;
  const int n_chunks = (s + kC - 1) / kC;
  const bool wf = kIsF32<T> || w32;
  const int bytes =
      kC * ((K + kVS) * (int)sizeof(T) + K * (wf ? 4 : (int)sizeof(T)));

  // the loader warp's lane 0 fetches chunk c's rows into buffer c % kBufs
  // once every compute warp is done with the chunk it held
  auto load = [&](int c) {
    const int buf = c % kBufs;
    const uint32_t bar = smem_addr(&sm.full[buf]);
    mbar_wait(smem_addr(&sm.done[buf]), ((c / kBufs) & 1) ^ 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, bytes);
    tma_load(&sm.k[buf][0][0], &tk, bar, k0, hh, c * kC, b);
    tma_load(&sm.w[buf][0][0], &tw, bar, k0, hh, c * kC, b);
    tma_load(&sm.v[buf][0][0], &tv, bar, v0, hh, c * kC, b);
  };
  auto wait_rows = [&](int c) {
    mbar_wait(smem_addr(&sm.full[c % kBufs]), (c / kBufs) & 1);
  };
  // the compute warps' barrier (the loader warp runs on its own)
  auto sync_compute = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(StateShape<K>::kThreads)
                 : "memory");
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
  const int64_t chunk_elems = (int64_t)kt * nv;
  float st[kKR][kCV];
  float* const s_row =
      starts + ((int64_t)bh * n_chunks * kt + k0 + kr) * nv + v0 + cv;
  const bool updater = tid < kUpdateThreads;
  if (updater) {
#pragma unroll
    for (int r = 0; r < kKR; ++r)
#pragma unroll
      for (int i = 0; i < kCV; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(
            s0 + ((int64_t)bh * kt + k0 + kr + r) * nv + v0 + cv + i);
        st[r][i] = a.x; st[r][i + 1] = a.y; st[r][i + 2] = a.z;
        st[r][i + 3] = a.w;
      }
  }
  wait_rows(0);
  if (!updater) decay_keys(sm, 0, 0, tid, w32);

  for (int c = 0; c < n_chunks; ++c) {
    // chunk c + 1's rows have landed; chunk c's decayed keys are written;
    // every read of the buffer refilled below (chunk c - 1's) is done
    if (c + 1 < n_chunks) wait_rows(c + 1);
    sync_compute();
    if (updater) {
      float* out = s_row + c * chunk_elems;
      const int buf = c % kBufs, kb = c & 1;
#pragma unroll
      for (int r = 0; r < kKR; ++r) {
#pragma unroll
        for (int i = 0; i < kCV; i += 4)
          *reinterpret_cast<float4*>(out + r * nv + i) =
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
            const float4 x = load4(&sm.v[buf][sp0 + j][cv + i]);
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
      decay_keys(sm, (c + 1) % kBufs, (c + 1) & 1, tid, w32);
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
        *reinterpret_cast<float4*>(sout + ((int64_t)bh * kt + k0 + kr + r) *
                                              nv +
                                   v0 + cv + i) =
            make_float4(st[r][i], st[r][i + 1], st[r][i + 2], st[r][i + 3]);
  }
}

// ---------------------------------------------------------------------------
// pass 2: every chunk's outputs from its chunk-start state
// ---------------------------------------------------------------------------

// A chunk tile of 32 rows x W columns as TMA writes it with the 128-byte
// swizzle: W / 32 boxes of 32 columns, each row 128 bytes whose 16-byte
// pieces are permuted by the row's low three bits.
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

// The rows of a 2-byte T as TMA lands them (dense, one box a tile) before
// the widening copy; f32 rows land in their tiles directly.
template <int K, int V, typename T>
struct OutStage {
  alignas(128) T r[kC * K];
  alignas(128) T k[kC * K];
  alignas(128) T w[kC * K];
  alignas(128) T v[kC * V];
};
template <int K, int V>
struct OutStage<K, V, float> {};

template <int K, int V, typename T>
struct alignas(1024) OutSmem : OutStage<K, V, T> {
  alignas(1024) float r[kC * K];
  union {
    float k[kC * K];
    float at[K][kC];                    // after the scores: (r_t 2^L_{t-1})^T
  };
  float lin[kC * K];                    // logw, then L_t (base 2)
  float v[kC * V];
  float state[K][V];                    // the chunk-start state
  float mix[kC][kC + 4];                // [s][t]: score_ts for s < t, the u
                                        // bonus for s = t, 0 for s > t
  float u[K];
  float bonus[kC];
  uint64_t full;
};

// blocks of the output pass an SM holds by shared memory (228 KB, 1 KB of
// it reserved a block, 1 KB of alignment slack): the register budget
// ptxas is given, at most 4, and at most 2 at K = 128, whose score loop
// spilled at the 80 registers of 3 blocks.  A body that walks key slices
// (kSliced) carries its partial scores, bonus and output rows across them
// and spilled 4 to 128 bytes at the 128 registers of 2 blocks: it is
// given one block's budget.
template <int K, int V, typename T>
constexpr int kSmemBlocks =
    (int)(228 * 1024 / (sizeof(OutSmem<K, V, T>) + 2048));
template <int K, int V, typename T, int kSliced>
constexpr int kOutBlocks =
    kSmemBlocks<K, V, T> < 1 || kSliced ? 1
    : kSmemBlocks<K, V, T> > (K == 128 ? 2 : 4) ? (K == 128 ? 2 : 4)
                                                : kSmemBlocks<K, V, T>;

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

// A dense (32, W) tile of T widened into the f32 swizzled layout, four
// columns a thread at a time.
template <int W, typename T>
__device__ __forceinline__ void widen_tile(const T* src, float* dst,
                                           int tid) {
#pragma unroll 4
  for (int e = 4 * tid; e < kC * W; e += 4 * kThreads) {
    const int t = e / W, j = e % W;
    *reinterpret_cast<float4*>(dst + sw(t, j)) = load4(src + e);
  }
}

// n consecutive floats of shared memory, 4 n bytes aligned
template <int N>
__device__ __forceinline__ void lds_cols(const float* p, float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
}

// one output row's N columns, each rounded once to T
template <int N, typename T>
__device__ __forceinline__ void store_cols(T* dst, const float (&o)[N]) {
  if constexpr (kIsF32<T> && N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
  } else if constexpr (kIsF32<T> && N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) narrow(dst + c, o[c]);
  }
}

// 32 x 32 floats of a swizzled f32 tile (one 32-column box) set to 0: a
// box that lies wholly past the row's true width is not loaded
__device__ __forceinline__ void zero_box(float* tile, int box, int tid) {
  reinterpret_cast<float4*>(tile + box * kC * 32)[tid] =
      make_float4(0.f, 0.f, 0.f, 0.f);
}

// One block: chunk blockIdx.x of (b, h) = blockIdx.y, value columns v0 ..
// v0 + V - 1 (v0 = V blockIdx.z).  K and V are the tile widths; kk and vv
// the rows' widths in memory (columns past them read as zeros), kt the
// padded key width of u and the chunk-start states (ts: the scratch as
// rows of its padded value width).  kSliced 0: K is the whole key width
// (kt = K) and the body runs once; 1: the block walks kt / K key slices,
// reloading r, k, logw, u and the state's rows for each and carrying the
// partial scores, bonus and cross term in registers across them; v, the
// scores' mix and the intra-chunk term follow once.  w32: logw is f32
// (always, for T = float).
template <int K, int V, typename T, int kSliced>
__global__ void __launch_bounds__(kThreads, (kOutBlocks<K, V, T, kSliced>))
wkv_output_pass(const __grid_constant__ CUtensorMap tr,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap ts,
                const float* __restrict__ u, T* __restrict__ out, int s,
                int h, int w32, int kk, int vv, int kt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern follows address bits, so the tiles sit 1024-aligned
  const uint32_t raw = smem_addr(smem_raw);
  OutSmem<K, V, T>& sm = *reinterpret_cast<OutSmem<K, V, T>*>(
      smem_raw + (((raw + 1023) & ~1023u) - raw));
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int v0 = blockIdx.z * V;
  const int n_chunks = gridDim.x;
  const int b = bh / h, hh = bh % h;
  const int64_t stride = (int64_t)h * vv;
  const int64_t row0 = (int64_t)b * s * stride + (int64_t)hh * vv + v0;
  const int t0 = c * kC;
  const bool wf = kIsF32<T> || w32;
  const int n_slices = kSliced ? kt / K : 1;
  // the 32-column f32 boxes of v that hold a column of it
  const int v_boxes = min(V / 32, (vv - v0 + 31) / 32);
  const uint32_t bar = smem_addr(&sm.full);

  // carried across key slices: the thread's partial scores (a00, a01, a10,
  // a11 of its 2 x 2 block; a10 alone on the diagonal's neighbours), its
  // quarter of a token's bonus, and its output rows
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  float bonus = 0.f;
  constexpr int kN = V / 32;
  const int tr4 = 4 * (tid >> 5), cn = kN * lane;
  float o[4][kN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < kN; ++n) o[i][n] = 0.f;
  // rows 4 g .. 4 g + 3 (g = warp) of value columns kN l .. kN l + kN - 1
  // (l = lane, kN = V / 32): per k or token, one 16-byte load the warp
  // shares and one load of kN columns feed 4 kN FMAs
  auto accumulate = [&](const float* rows4, const float* cols) {
    const float4 p = *reinterpret_cast<const float4*>(rows4);
    float x[kN];
    lds_cols(cols, x);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[0][n] = fmaf(p.x, x[n], o[0][n]);
      o[1][n] = fmaf(p.y, x[n], o[1][n]);
      o[2][n] = fmaf(p.z, x[n], o[2][n]);
      o[3][n] = fmaf(p.w, x[n], o[3][n]);
    }
  };
  // the two halves of k sit in neighbouring lanes: the partial scores'
  // sums into mix, and the bonus's four quarters into bonus
  auto write_scores = [&]() {
    if (tid < 2 * kOffBlocks) {
      int a, bb;
      off_block(tid >> 1, &a, &bb);
      const int s0 = 2 * bb, s1 = s0 + 1, q0 = 2 * a, q1 = q0 + 1;
      const unsigned mask = tid < 2 * kOffBlocks - 16 ? 0xffffffffu : 0xffffu;
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] += __shfl_xor_sync(mask, sc[i], 1);
      if ((tid & 1) == 0) {
        sm.mix[s0][q0] = sc[0];
        sm.mix[s1][q0] = sc[1];
        sm.mix[s0][q1] = sc[2];
        sm.mix[s1][q1] = sc[3];
      }
    } else {
      const int q1 = 2 * (tid - 2 * kOffBlocks) + 1;
      sm.mix[q1 - 1][q1] = sc[0];
    }
  };
  auto write_bonus = [&]() {
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
    if ((tid & 3) == 0) sm.bonus[(tid - 128) >> 2] = bonus;
  };
  // the bonus on the diagonal of mix and zeros above it
  auto fill_mix = [&]() {
    for (int e = tid; e < kC * kC; e += kThreads) {
      const int t = e % kC, s2 = e / kC;
      if (s2 >= t) sm.mix[s2][t] = s2 == t ? sm.bonus[t] : 0.0f;
    }
  };

  for (int ks = 0; ks < n_slices; ++ks) {
    const int k0 = ks * K;
    // the 32-column f32 boxes of the slice's key columns that hold one
    const int k_boxes = min(K / 32, (kk - k0 + 31) / 32);
    // every read of the last slice's tiles is done
    if (kSliced && ks > 0) __syncthreads();
    if (tid == 0) {
      if (ks == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      } else {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      int bytes = K * V * 4 + K * 4;    // the state's rows and u
      if constexpr (kIsF32<T>) {
        bytes += 2 * k_boxes * kC * 32 * 4;
        if (ks == 0) bytes += v_boxes * kC * 32 * 4;
      } else {
        bytes += (2 + (wf ? 0 : 1)) * kC * K * (int)sizeof(T);
        if (ks == 0) bytes += kC * V * (int)sizeof(T);
      }
      if (wf) bytes += k_boxes * kC * 32 * 4;
      mbar_expect(bar, bytes);
      if constexpr (kIsF32<T>) {
        for (int box = 0; box < k_boxes; ++box) {
          tma_load(sm.r + box * kC * 32, &tr, bar, k0 + 32 * box, hh, t0, b);
          tma_load(sm.k + box * kC * 32, &tk, bar, k0 + 32 * box, hh, t0, b);
        }
        if (ks == 0)
          for (int box = 0; box < v_boxes; ++box)
            tma_load(sm.v + box * kC * 32, &tv, bar, v0 + 32 * box, hh, t0,
                     b);
      } else {
        OutStage<K, V, T>& stage = sm;
        tma_load(stage.r, &tr, bar, k0, hh, t0, b);
        tma_load(stage.k, &tk, bar, k0, hh, t0, b);
        if (ks == 0) tma_load(stage.v, &tv, bar, v0, hh, t0, b);
        if (!wf) tma_load(stage.w, &tw, bar, k0, hh, t0, b);
      }
      if (wf)
        for (int box = 0; box < k_boxes; ++box)
          tma_load(sm.lin + box * kC * 32, &tw, bar, k0 + 32 * box, hh, t0,
                   b);
      tma_load2(&sm.state[0][0], &ts, bar, v0,
                ((int)bh * n_chunks + c) * kt + k0);
      bulk_load(sm.u, u + hh * kt + k0, K * 4, bar);
    }
    // the f32 boxes wholly past a row's width read as zeros
    if constexpr (kIsF32<T>) {
      for (int box = k_boxes; box < K / 32; ++box) {
        zero_box(sm.r, box, tid);
        zero_box(sm.k, box, tid);
      }
      if (ks == 0)
        for (int box = v_boxes; box < V / 32; ++box) zero_box(sm.v, box, tid);
    }
    if (wf)
      for (int box = k_boxes; box < K / 32; ++box) zero_box(sm.lin, box, tid);
    __syncthreads();
    mbar_wait(bar, ks & 1);
    if constexpr (!kIsF32<T>) {
      const OutStage<K, V, T>& stage = sm;
      widen_tile<K>(stage.r, sm.r, tid);
      widen_tile<K>(stage.k, sm.k, tid);
      if (ks == 0) widen_tile<V>(stage.v, sm.v, tid);
      if (!wf) widen_tile<K>(stage.w, sm.lin, tid);
      __syncthreads();
    }

    // 1. warps 0-3: L_t in place of logw (lane l of warp q owns column
    //    16 q + (l & 15) of each 64-column group over the 16 tokens of half
    //    l >> 4); warps 4-7: the u bonus, four lanes a token
    if (tid < 128) {
      const int half = lane >> 4, tb = half * 16;
#pragma unroll
      for (int j0 = 0; j0 < K; j0 += 64) {
        const int j = j0 + (tid >> 5) * 16 + (lane & 15);
        if (j < K) {      // a whole warp or none (K = 32: warps 0-1)
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
          for (int i = 0; i < 16; ++i)
            sm.lin[sw(tb + i, j)] = (lv[i] + add) * kLog2e;
        }
      }
    } else {
      constexpr int kQ = K / 4;
      const int t = (tid - 128) >> 2, q = (tid & 3) * kQ;
#pragma unroll
      for (int j = q; j < q + kQ; ++j)
        bonus = fmaf(sm.r[sw(t, j)] * sm.u[j], sm.k[sw(t, j)], bonus);
      if constexpr (!kSliced) write_bonus();
    }
    __syncthreads();

    // 2. the pairwise scores, once for all value columns
    if (tid < 2 * kOffBlocks) {
      int a, bb;
      off_block(tid >> 1, &a, &bb);
      const int q0 = 2 * a, q1 = q0 + 1, s0 = 2 * bb, s1 = s0 + 1;
      const int h0 = (tid & 1) * (K / 8);
      const uint32_t r0 = row_key(sm.r, q0), r1 = row_key(sm.r, q1);
      const uint32_t l0 = row_key(sm.lin, q0 - 1), l1 = row_key(sm.lin, q0);
      const uint32_t k0k = row_key(sm.k, s0), k1k = row_key(sm.k, s1);
      const uint32_t m0 = row_key(sm.lin, s0), m1 = row_key(sm.lin, s1);
#pragma unroll
      for (int q = 0; q < K / 8; ++q) {
        const float4 x0 = lds4(r0, h0 + q), x1 = lds4(r1, h0 + q);
        const float4 la0 = lds4(l0, h0 + q), la1 = lds4(l1, h0 + q);
        const float4 y0 = lds4(k0k, h0 + q), y1 = lds4(k1k, h0 + q);
        const float4 n0 = lds4(m0, h0 + q), n1 = lds4(m1, h0 + q);
        sc[0] = score4(sc[0], x0, la0, y0, n0);
        sc[1] = score4(sc[1], x0, la0, y1, n1);
        sc[2] = score4(sc[2], x1, la1, y0, n0);
        sc[3] = score4(sc[3], x1, la1, y1, n1);
      }
    } else {
      const int q1 = 2 * (tid - 2 * kOffBlocks) + 1, s0 = q1 - 1;
      const uint32_t r1 = row_key(sm.r, q1), l1 = row_key(sm.lin, s0);
      const uint32_t k0k = row_key(sm.k, s0);
#pragma unroll
      for (int q = 0; q < K / 4; ++q)
        sc[0] = score4(sc[0], lds4(r1, q), lds4(l1, q), lds4(k0k, q),
                       lds4(l1, q));
    }
    if constexpr (!kSliced) write_scores();
    __syncthreads();

    // 3. r decayed from the chunk's start, transposed over k (no longer
    //    read)
    for (int e = tid; e < kC * K; e += kThreads) {
      const int t = e % kC, j = e / kC;
      sm.at[j][t] = sm.r[sw(t, j)] * (t ? ex2(sm.lin[sw(t - 1, j)]) : 1.0f);
    }
    if constexpr (!kSliced) fill_mix();
    __syncthreads();

    // 4. the cross term, from the slice's rows of the chunk-start state
#pragma unroll 8
    for (int j = 0; j < K; ++j) accumulate(&sm.at[j][tr4], &sm.state[j][cn]);
  }

  if constexpr (kSliced) {
    write_scores();
    if (tid >= 128) write_bonus();
    __syncthreads();
    fill_mix();
    __syncthreads();
  }
  // 5. the intra-chunk term and the u bonus (the diagonal of mix)
  for (int s2 = 0; s2 < tr4 + 4; ++s2)
    accumulate(&sm.mix[s2][tr4], &sm.v[sw(s2, cn)]);
  if (v0 + cn < vv) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (t0 + tr4 + i < s)
        store_cols(out + row0 + (t0 + tr4 + i) * stride + cn, o[i]);
  }
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

// type codes: 0 float32, 1 bfloat16, 2 float16
template <typename T> constexpr int kCode = 0;
template <> constexpr int kCode<__nv_bfloat16> = 1;
template <> constexpr int kCode<__half> = 2;

// A (B, S, H, width) tensor of type `code` as a 4-d map (width, H, S, B):
// boxes of `cols` columns x one head x 32 tokens x one sequence (f32 boxes
// of 32 columns 128-byte swizzled when `swizzle`); tokens past S read as
// zeros, per sequence
bool make_map(CUtensorMap* map, const void* ptr, int code, int b, int s,
              int h, int width, int cols, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = code == 0 ? 4 : 2;
  const cuuint64_t row = (cuuint64_t)h * width * es;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)h,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)width * es, row, row * s};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)kC, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      code == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : code == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The chunk-start states (B, H, n_chunks, kt, vt) f32 as a 2-d map of
// B H n_chunks kt rows of vt columns: boxes of K rows x V columns, the
// output pass's slice of a chunk's state
bool make_state_map(CUtensorMap* map, const void* ptr, int64_t rows, int vt,
                    int box_rows, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)vt, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)vt * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The padded width a width runs at: 32, 64 or 128 up to 128 (the next of
// them), past it the next multiple of 32.
int padded_width(int w) {
  return w <= 32 ? 32 : w <= 64 ? 64 : w <= 128 ? 128 : (w + 31) / 32 * 32;
}

// The tile a padded V is cut into: itself up to 128, past it the largest
// of 128, 64 and 32 that divides it.
int tile_width(int wp) {
  return wp <= 128 ? wp : wp % 128 == 0 ? 128 : wp % 64 == 0 ? 64 : 32;
}

// The slice a padded K is cut into: itself up to 128, past it 64 or 32.
int key_tile_width(int wp) {
  return wp <= 128 ? wp : wp % 64 == 0 ? 64 : 32;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
}

// kk, vv: the widths of the rows in memory; kt, vt: the padded widths of u,
// state0, the state and the scratch
struct Args {
  const void *r, *k, *v, *logw, *u, *state0;
  void *out, *state, *scratch;
  int b, s, h, wcode, passes, kk, vv, kt, vt;
};

template <int K>
size_t state_smem(int code) {
  switch (code) {
    case 0: return sizeof(StateSmem<K, float>) + 128;
    case 1: return sizeof(StateSmem<K, __nv_bfloat16>) + 128;
    default: return sizeof(StateSmem<K, __half>) + 128;
  }
}

template <int K, int V>
size_t out_smem(int code) {
  switch (code) {
    case 0: return sizeof(OutSmem<K, V, float>) + 1024;
    case 1: return sizeof(OutSmem<K, V, __nv_bfloat16>) + 1024;
    default: return sizeof(OutSmem<K, V, __half>) + 1024;
  }
}

template <int K>
size_t out_smem_v(int code, int vv) {
  return vv == 32   ? out_smem<K, 32>(code)
         : vv == 64 ? out_smem<K, 64>(code)
                    : out_smem<K, 128>(code);
}

// K, V: the tiles of the padded widths a.kt, a.vt
template <int K, int V, typename T>
int launch_wkv(const Args& a, cudaStream_t st) {
  constexpr int code = kCode<T>;
  const int n_chunks = (a.s + kC - 1) / kC;
  const int w32 = a.wcode == 0;
  if (a.passes & 1) {
    CUtensorMap tk, tw, tv;
    if (!make_map(&tk, a.k, code, a.b, a.s, a.h, a.kk, K, false) ||
        !make_map(&tw, a.logw, a.wcode, a.b, a.s, a.h, a.kk, K, false) ||
        !make_map(&tv, a.v, code, a.b, a.s, a.h, a.vv, kVS, false))
      return (int)cudaErrorNotSupported;
    const size_t smem = sizeof(StateSmem<K, T>) + 128;
    cudaError_t err = allow_smem(wkv_state_pass<K, T>, smem);
    if (err != cudaSuccess) return (int)err;
    const int vslices = (a.vv + kVS - 1) / kVS;
    wkv_state_pass<K, T>
        <<<a.b * a.h * vslices * (a.kt / K), StateShape<K>::kBlock, smem,
           st>>>(tk, tw, tv, static_cast<const float*>(a.state0),
                 static_cast<float*>(a.scratch), static_cast<float*>(a.state),
                 a.s, a.h, a.vt, a.kt, vslices, w32);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.passes & 2) {
    // f32 rows: boxes of 32 columns, swizzled into the tiles; T rows: one
    // dense box a tile into the staging buffer
    const bool f32 = code == 0;
    const int cols_k = f32 ? 32 : K, cols_v = f32 ? 32 : V;
    CUtensorMap tr, tk, tw, tv, ts;
    if (!make_map(&tr, a.r, code, a.b, a.s, a.h, a.kk, cols_k, f32) ||
        !make_map(&tk, a.k, code, a.b, a.s, a.h, a.kk, cols_k, f32) ||
        !make_map(&tw, a.logw, a.wcode, a.b, a.s, a.h, a.kk, w32 ? 32 : K,
                  w32) ||
        !make_map(&tv, a.v, code, a.b, a.s, a.h, a.vv, cols_v, f32) ||
        !make_state_map(&ts, a.scratch,
                        (int64_t)a.b * a.h * n_chunks * a.kt, a.vt, K, V))
      return (int)cudaErrorNotSupported;
    const size_t smem = sizeof(OutSmem<K, V, T>) + 1024;
    const dim3 grid(n_chunks, a.b * a.h, a.vt / V);
    cudaError_t err;
    if (a.kt > K) {
      // key slices are 64 or 32 wide (key_tile_width)
      if constexpr (K < 128) {
        err = allow_smem(wkv_output_pass<K, V, T, 1>, smem);
        if (err != cudaSuccess) return (int)err;
        wkv_output_pass<K, V, T, 1><<<grid, kThreads, smem, st>>>(
            tr, tk, tw, tv, ts, static_cast<const float*>(a.u),
            static_cast<T*>(a.out), a.s, a.h, w32, a.kk, a.vv, a.kt);
      } else {
        return (int)cudaErrorInvalidValue;
      }
    } else {
      err = allow_smem(wkv_output_pass<K, V, T, 0>, smem);
      if (err != cudaSuccess) return (int)err;
      wkv_output_pass<K, V, T, 0><<<grid, kThreads, smem, st>>>(
          tr, tk, tw, tv, ts, static_cast<const float*>(a.u),
          static_cast<T*>(a.out), a.s, a.h, w32, a.kk, a.vv, a.kt);
    }
  }
  return (int)cudaGetLastError();
}

template <int K, typename T>
int launch_v(int tv, const Args& a, cudaStream_t st) {
  switch (tv) {
    case 32: return launch_wkv<K, 32, T>(a, st);
    case 64: return launch_wkv<K, 64, T>(a, st);
    default: return launch_wkv<K, 128, T>(a, st);
  }
}

template <typename T>
int launch_kv(int tk, int tv, const Args& a, cudaStream_t st) {
  switch (tk) {
    case 32: return launch_v<32, T>(tv, a, st);
    case 64: return launch_v<64, T>(tv, a, st);
    default: return launch_v<128, T>(tv, a, st);
  }
}

}  // namespace

// r, k, v, out in the type `dtype` (0 float32, 1 bfloat16, 2 float16);
// logw in `wdtype` (dtype, or 0); r, k and logw rows of kk columns, v and
// out rows of vv, each row's bytes a multiple of 16 (TMA's stride; the
// tiles' columns past a row read as zeros).  u (H, kt), state0 and state
// (B, H, kt, vt) and the scratch (B, H, ceil(S / 32), kt, vt), the
// chunk-start states, in float32 at the padded widths kt, vt
// (rwkv6_wkv_padded_width).  passes: 1 the state pass, 2 the output pass
// (reads the scratch the state pass wrote), 3 both in order (the WKV).
// Returns a cudaError_t; anything outside that domain is
// cudaErrorInvalidValue and launches nothing.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* logw, const void* u,
                                const void* state0, void* out, void* state,
                                void* scratch, int b, int s, int h, int kk,
                                int vv, int dtype, int wdtype, int passes,
                                void* stream) {
  if (dtype < 0 || dtype > 2 || (wdtype != 0 && wdtype != dtype))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2, wes = wdtype == 0 ? 4 : 2;
  // the output pass's grid is (n_chunks, B H, vt / V)
  if (b < 1 || s < 1 || h < 1 || passes < 1 || passes > 3 || b * h > 65535 ||
      kk < 1 || vv < 1 || kk * es % 16 || kk * wes % 16 || vv * es % 16)
    return (int)cudaErrorInvalidValue;
  const int kt = padded_width(kk), vt = padded_width(vv);
  const Args a{r,      k,  v,  logw,    u,      state0, out, state, scratch,
               b,      s,  h,  wdtype,  passes, kk,     vv,  kt,    vt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tk = key_tile_width(kt), tv = tile_width(vt);
  switch (dtype) {
    case 0: return launch_kv<float>(tk, tv, a, st);
    case 1: return launch_kv<__nv_bfloat16>(tk, tv, a, st);
    default: return launch_kv<__half>(tk, tv, a, st);
  }
}

// The padded width a width of K or V runs at (u, the states).
extern "C" int rwkv6_wkv_padded_width(int w) {
  return w < 1 ? -1 : padded_width(w);
}

// The tile a padded width is cut into: the passes' V (key 0) or K (key 1).
extern "C" int rwkv6_wkv_tile_width(int wp, int key) {
  if (wp < 1 || padded_width(wp) != wp) return -1;
  return key ? key_tile_width(wp) : tile_width(wp);
}

// Dynamic shared memory of the state pass (1) or the output pass (2) at
// type `dtype` and widths K, V (the passes' tiles of their padded widths);
// -1 outside the domain.
extern "C" int rwkv6_wkv_smem(int pass, int dtype, int kk, int vv) {
  if (kk < 1 || vv < 1 || dtype < 0 || dtype > 2) return -1;
  const int tk = key_tile_width(padded_width(kk));
  const int tv = tile_width(padded_width(vv));
  if (pass == 1)
    return (int)(tk == 32   ? state_smem<32>(dtype)
                 : tk == 64 ? state_smem<64>(dtype)
                            : state_smem<128>(dtype));
  return (int)(tk == 32   ? out_smem_v<32>(dtype, tv)
               : tk == 64 ? out_smem_v<64>(dtype, tv)
                          : out_smem_v<128>(dtype, tv));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
