// Flash attention forward (online softmax), written by hand for Hopper
// (sm_90a).
//
// Replaces B5, the Pallas kernel _kernel (:31) of
// src/repro/kernels/flash_attention.py (pallas_call at :97,
// flash_attention_pallas).  It computes, for q (B, S, H, hd) and k, v
// (B, T, Kh, hd) with H a multiple of Kh (query head h reads kv head
// h / (H / Kh)):
//   s = (q . k) * scale;  s = softcap * tanh(s / softcap) when softcap > 0;
//   key j is admitted for query i iff j < T, j <= i when causal, and
//   i - j < window when window > 0;
//   out = sum_j p_j v_j / max(sum_j p_j, 1e-30),  p_j = admitted ?
//   exp(s_j - max_j s_j) : 0,
// in float32 inside, cast back to the input type.  Given an lse pointer
// (training: the residual of the reference's _flash_vjp_fwd,
// src/repro/models/attention.py:182-185), each body also writes
//   lse = m + log(max(sum_j p_j, 1e-30)),  m = max_j s_j over admitted keys
// (0 for a row that admits none), float32, laid out (B, H, S) = the
// reference's (B, Kh, G, S); a null pointer (serving) writes nothing else.
//
// What bounds it on the H100: operations.  At the served gemma2-9b shape
// (B 2, S 4608, H 16, Kh 8, hd 256) one layer needs 4 * hd flops per
// admitted (query, key) pair, 3.5e11 for a causal layer: 0.35 ms of bf16
// tensor cores against 0.02 ms to read q, k, v and write out once.  The
// TPU kernel walked the kv chunks as a sequential grid axis with its
// (m, l, acc) carry in VMEM scratch and skipped dead chunks with pl.when.
//
// Design.  A block owns one (batch, head, query tile) and walks the live
// kv tiles in a loop: keys up to the tile's last query when causal, and
// from window - 1 keys before its first query when windowed, so dead tiles
// cost nothing.  Heavy (late) query tiles are scheduled first.  The
// running max, sum and output accumulator stay in registers in float32.
// Four bodies, by type and head dim:
//   - bfloat16 at head dims 128 and 256 (the dense, MoE and VLM shapes),
//     flash_wgmma: 128 queries a block, two warpgroups of 64 rows.  Q
//     arrives once and K/V tiles of BK keys (64 at hd 256, 128 at hd 128)
//     stream by TMA from 4-d tensor maps (hd, heads, S, B) into a ring of
//     as many stages as fit (2 at hd 256, 3 at hd 128), 128-byte swizzled,
//     each stage behind mbarriers (K landed, V landed, K released, V
//     released); the maps zero-fill the ragged S edge per sequence.  S =
//     Q K^T is a wgmma m64nBKk16 from shared memory (both K-major); the
//     softmax runs on its registers (the softcap's tanh and the
//     exponentials on tanh.approx and ex2.approx; the mask only on tiles
//     that need it; uncapped, the scale folds into the exponent), and P
//     goes to bf16 in registers as the A operand of O += P V, a wgmma
//     m64n{hd}k16 with V from shared memory (MN-major).  S_{i+1} and O +=
//     P_i V_i are issued together, so tile i + 1's softmax runs while P_i
//     V_i is on the tensor cores.  Thread 0 is also the producer: K_j is
//     refilled as soon as both warpgroups formed S_j, V_j once they
//     finished P_j V_j.  The output leaves through the Q tile's shared
//     memory and one TMA store, which clips rows past S.  What bounds it
//     now: with the tile's exponentials (16 a clock per SM) and the K/V
//     ring only two stages deep at hd 256, the tensor cores are busy about
//     half the time.  A producer warpgroup with setmaxnreg was tried
//     first: ptxas then held the consumers to 168 registers and serialised
//     every wgmma (it needs ~235 at hd 256), so the two warpgroups own all
//     255.
//   - bfloat16 at head dims 64 and 80 (granite-moe's and whisper-tiny's
//     64, zamba2-2.7b's shared block at 80), flash_wgmma_ws: the same
//     tiles (128 queries, two consumer warpgroups, K/V tiles of 128 keys,
//     S = Q K^T in m64n128k16 steps, S_{i+1} issued with O += P_i V_i)
//     with three changes.  What bounds it: an admitted pair costs 4 hd
//     flops (256 at hd 64) of the tensor cores' 4,096 a clock per SM, and
//     one exponential of the SFU's 16 a clock, so at hd 64 the
//     exponentials take as long as the products (at hd 80 four fifths)
//     and a body that runs them one after the other cannot pass half the
//     flop bound.  (1) The warpgroups take turns on two named barriers:
//     each waits for its turn, issues its products and hands the turn
//     over, so one warpgroup's softmax can run while the other's products
//     are on the tensor cores (tools/ab_flash.py times it against free
//     issue: about even so far; the softmax alone takes most of the
//     time).  (2) Registers are no longer scarce (S 64
//     floats, O 32 or 40, P 32), so a producer warp of its own keeps the
//     ring full (6 stages of 32 KB at hd 64, 5 of 40 KB at hd 80); with
//     thread 0 as the producer it was slower at every shape timed.  (3) hd 80's 160-byte
//     rows fit no swizzle atom: each Q, K, V and output tile is two TMA
//     boxes, columns 0-63 128-byte swizzled and columns 64-79 32-byte
//     swizzled, so S takes a fifth k-step from the second box and O += P
//     V is a pair, m64n64k16 plus m64n16k16 (accumulators 32 + 8 floats).
//     Padding hd 80 to 128 would cost 1.6x the tensor work.  The last tile
//     issues O += P V in a step of its own, a warp whose rows kept their
//     max skips the output's rescale (exactly 1), whether a softcap
//     applies is a template argument (kCap), and the grid runs (batch,
//     head) pairs in groups of 8, heaviest tile first within a group, so
//     a wave reads the K/V of few heads.  Each warpgroup stores its own 64
//     output rows.
//   - bfloat16 at head dims 16 and 32 (the smoke configs' 8, padded to
//     16), flash_bf16: four warps of 16 query rows each over a 64-query
//     tile, mma.sync m16n8k16 fed by ldmatrix, K and V double-buffered by
//     cp.async over 32-key tiles: at these widths wgmma's 64-row tiles and
//     TMA boxes of 64 columns do not pay, and the launch is the time.
//   - float32: 256 threads on the CUDA cores, each owning 4 query rows x
//     4 keys of the score tile and 4 rows x hd/16 columns of the output.
//     K rows are padded to hd + 1 floats so the 16 keys a warp reads at one
//     depth lie in distinct banks.  This form exists for float32 parity;
//     above hd 64 its tile passes the 48 KB default of dynamic shared
//     memory (78,336 bytes at hd 80) and launch() opts in.
// Masked scores take the finite sentinel -1e30, as the Pallas kernel does,
// and their probability is 0 by the admitted test, so a row whose first
// live tile admits none of its keys never forms exp(-inf + inf).  No
// atomics: two runs give the same bits.  Any S >= 1: ragged tiles are
// zero-filled and masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kBlockQ = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // (B, H, S) or null
  int s, t, h, kh, causal, window;
  float scale, softcap;
};

// One query row's log-sum-exp from its running max m (in score units) and
// its sum l >= 1e-30; a row that admitted no key kept the sentinel max.
__device__ __forceinline__ void store_lse(const Params& p, int batch,
                                          int head, int qi, float m,
                                          float l) {
  p.lse[((int64_t)batch * p.h + head) * p.s + qi] =
      (m == kMasked ? 0.f : m) + logf(l);
}

__device__ __forceinline__ bool admitted(const Params& p, int qi, int kj) {
  return kj < p.t && (!p.causal || kj <= qi) &&
         (p.window <= 0 || qi - kj < p.window);
}

// First key tile (a multiple of bk) and one past the last live key of the
// query rows [q0, q_last].
__device__ __forceinline__ void live_keys(const Params& p, int q0, int q_last,
                                          int bk, int* lo, int* hi) {
  int a = 0, e = p.t;
  if (p.causal) e = min(e, q_last + 1);
  if (p.window > 0) a = max(0, q0 - p.window + 1);
  *lo = (a / bk) * bk;
  *hi = e;
}

// ---------------------------------------------------------------------------
// bfloat16 at head dims 16 and 32: mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// head dims 16 and 32: 32 keys a tile, K and V double-buffered
constexpr int kBf16BlockK = 32;

template <int HD>
constexpr size_t kBf16SmemBytes =
    (size_t)(kBlockQ + 4 * kBf16BlockK) * (HD + 8) * sizeof(__nv_bfloat16);

template <int HD>
__global__ void __launch_bounds__(128) flash_bf16(Params p) {
  constexpr int BK = kBf16BlockK;
  constexpr int LD = HD + 8;   // smem row, bf16 elements (16-byte pad)
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int NS = BK / 8;   // score n-tiles per warp
  constexpr int NO = HD / 8;   // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + kBlockQ * LD;  // stage s: K, then V, BK rows each

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (p.s + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBlockQ;
  const int q_last = min(q0 + kBlockQ, p.s) - 1;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kvh = head / (p.h / p.kh);
  const int64_t q_step = (int64_t)p.h * HD, kv_step = (int64_t)p.kh * HD;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            ((int64_t)batch * p.s * p.h + head) * HD;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            ((int64_t)batch * p.t * p.kh + kvh) * HD;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            ((int64_t)batch * p.t * p.kh + kvh) * HD;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) +
                      ((int64_t)batch * p.s * p.h + head) * HD;

  // start the copies of kv tile k0 into stage st (rows past T zero-filled)
  auto load_kv = [&](int k0, int st) {
    __nv_bfloat16* ks = kvs + st * 2 * BK * LD;
    __nv_bfloat16* vs = ks + BK * LD;
    for (int e = tid; e < BK * CH; e += blockDim.x) {
      const int r = e / CH, c = e - r * CH, kj = k0 + r;
      const int64_t off = min(kj, p.t - 1) * kv_step + c * 8;
      const int n = kj < p.t ? 16 : 0;
      cp_async16(ks + r * LD + c * 8, kg + off, n);
      cp_async16(vs + r * LD + c * 8, vg + off, n);
    }
  };

  int lo, hi;
  live_keys(p, q0, q_last, BK, &lo, &hi);
  for (int e = tid; e < kBlockQ * CH; e += blockDim.x) {
    const int r = e / CH, c = e - r * CH, qi = q0 + r;
    cp_async16(qs + r * LD + c * 8, qg + min(qi, p.s - 1) * q_step + c * 8,
               qi < p.s ? 16 : 0);
  }
  if (lo < hi) load_kv(lo, 0);
  cp_async_commit();  // Q and the first kv tile

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + (lane >> 2);  // rows row0, row0 + 8
  const int mat = lane >> 3, mrow = lane & 7;     // ldmatrix addressing
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;

  int st = 0;
  for (int k0 = lo; k0 < hi; k0 += BK, st ^= 1) {
    // the next tile's copies fly while this one is computed; the other
    // stage was released by the barrier that ended the previous iteration
    if (k0 + BK < hi) {
      load_kv(k0 + BK, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kvs + st * 2 * BK * LD;
    const __nv_bfloat16* vs = ks + BK * LD;
    // a tile whose every (row, key) pair is admitted skips the mask
    const bool full = k0 + BK <= p.t && (!p.causal || k0 + BK - 1 <= q0) &&
                      (p.window <= 0 || q_last - k0 < p.window);

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (warp * 16 + (mat & 1) * 8 + mrow) * LD + kk * 16 +
                         (mat >> 1) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (np * 16 + (mat >> 1) * 8 + mrow) * LD + kk * 16 +
                           (mat & 1) * 8);
        mma_bf16(sc[2 * np], a, b[0], b[1]);
        mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale, softcap, mask; row max over the quad that shares a row
    uint32_t ok = 0;
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row0 + (e >> 1) * 8;
        const int kj = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        float x = sc[n][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanh_approx(x * inv_cap);
        if (full || admitted(p, qi, kj)) {
          ok |= 1u << (n * 4 + e);
        } else {
          x = kMasked;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= corr[i];  // per-thread partial sums; the quad sums at the end
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = (ok >> (n * 4 + e)) & 1u
                             ? exp2f((sc[n][e] - m[e >> 1]) * kLog2e)
                             : 0.f;
        sc[n][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kk * 16 + (mat & 1) * 8 + mrow) * LD +
                                 dp * 16 + (mat >> 1) * 8);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + i * 8;
    if (qi >= p.s) continue;
    if (p.lse != nullptr && (lane & 3) == 0)
      store_lse(p, batch, head, qi, m[i], l[i]);
    __nv_bfloat16* orow = og + qi * q_step + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * i] / l[i], acc[n][2 * i + 1] / l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at head dims 128 and 256: wgmma fed by TMA (the helpers below
// serve the hd 64/80 body too)
// ---------------------------------------------------------------------------

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

// one TMA box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled operand whose
// 8-row groups (of 128-byte rows) lie 1024 bytes apart.  K-major operands
// keep a 16-element k-step inside one 128-byte row (lbo unused); an
// MN-major operand steps `lbo` bytes from one 64-element block of its MN
// extent to the next.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The descriptor of an operand stored as 32-byte rows (16 bf16 columns)
// with the 32-byte swizzle, its 8-row groups 256 bytes apart: K-major, one
// 16-element k-step is a whole row; MN-major, 16 columns are the whole N
// extent, so the leading byte offset is unused either way.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instruction
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64, f32) {=, +=} a (64 x 16, smem, K-major) b (16 x 64, smem,
// K-major): scale_d 0 overwrites d, 1 accumulates
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) {=, +=} a (64 x 16, smem, K-major) b (16 x 128, smem,
// K-major): scale_d 0 overwrites d, 1 accumulates
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += a (64 x 16, registers) b (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += a (64 x 16, registers) b (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16, registers) b (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16, f32) += a (64 x 16, registers) b (16 x 16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_scores(float (&d)[BK / 2], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (BK == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    wgmma_ss_n128(d, da, db, scale_d);
  }
}

template <int HD>
__device__ __forceinline__ void wgmma_values(float (&d)[HD / 2],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (HD == 256) {
    wgmma_rs_n256(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// 128 queries a block, 64 per consumer warpgroup; K/V tiles of BK keys in
// a ring of stages; every tile is stored as HD / 64 boxes of 64 columns
// (128 bytes a row, 128-byte swizzle), one after another
constexpr int kWgBlockQ = 128;
constexpr int kWgThreads = 256;   // two warpgroups
constexpr int kMaxSmem = 232448;  // what one block may have on the H100

template <int HD>
struct WgTile {
  // keys a tile: 64 at hd 256 keeps the scores, probabilities and the
  // 128-register output under the 255-register budget
  static constexpr int BK = HD == 256 ? 64 : 128;
  static constexpr int kBoxes = HD / 64;
  static constexpr int kQBox = kWgBlockQ * 128;   // bytes of one Q box
  static constexpr int kKBox = BK * 128;
  static constexpr int kQBytes = kWgBlockQ * HD * 2;
  static constexpr int kKBytes = BK * HD * 2;
  // as many K/V stages as fit beside Q, 1 KB of alignment and the barriers
  static constexpr int kStages = (kMaxSmem - kQBytes - 2048) / (2 * kKBytes);
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKBytes;
  static constexpr size_t kSmemBytes = kBarOffset + 8 * (1 + 4 * kStages) +
                                       1024;
  static_assert(kStages >= 2, "two K/V stages must fit");
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Scale and softcap one score tile in place when capped, fold its row
// maxima into m, and leave exp(s - m) in place of the scores (uncapped,
// the scale goes into the exponent): returns the factor
// exp(m_old - m_new) of each of the thread's two rows in corr, and adds the
// probabilities to l.  kMask (boundary tiles only) gives the keys a row
// does not admit the sentinel score and probability 0.  kCap 0 or 1 fixes
// whether a softcap applies at compile time (-1: read from p); with kCap 1
// the scores (and m) stay in tanh units, t = tanh(s * scale / softcap),
// and the softcap folds into the exponent as well.
template <int NS, bool kMask, int kCap = -1>
__device__ __forceinline__ void online_softmax(float (&sc)[NS * 4],
                                               const Params& p, int row0,
                                               int k0, int lane,
                                               float inv_cap, float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2]) {
  // Without a softcap the scale is folded into the exponent: scores stay
  // raw (and so do m and the sentinel), exp2(s * scale * log2 e - m').
  const bool capped = kCap < 0 ? p.softcap > 0.f : kCap > 0;
  const float unit = kCap == 1 ? p.softcap * kLog2e
                     : capped  ? kLog2e
                               : p.scale * kLog2e;
  uint64_t ok = 0;
  float mx[2] = {kMasked, kMasked};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * n + e];
      if (kCap == 1)
        x = tanh_approx(x * p.scale * inv_cap);
      else if (capped)
        x = p.softcap * tanh_approx(x * p.scale * inv_cap);
      if constexpr (kMask) {
        const int qi = row0 + (e >> 1) * 8;
        const int kj = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        if (admitted(p, qi, kj)) {
          ok |= 1ull << (n * 4 + e);
        } else {
          x = kMasked;
        }
      }
      sc[4 * n + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2_approx((m[r] - m_new) * unit);
    m[r] = m_new;
    ml[r] = m_new * unit;
    l[r] *= corr[r];   // per-thread partial sums; the quad sums at the end
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = ex2_approx(fmaf(sc[4 * n + e], unit, -ml[e >> 1]));
      if constexpr (kMask) pe = (ok >> (n * 4 + e)) & 1ull ? pe : 0.f;
      sc[4 * n + e] = pe;
      l[e >> 1] += pe;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, Params p) {
  using Tile = WgTile<HD>;
  constexpr int BK = Tile::BK, NST = Tile::kStages;
  constexpr int NS = BK / 8;   // score n8 blocks per thread
  constexpr int NO = HD / 8;   // output n8 blocks per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms 1024-aligned
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t qs = base;
  const uint32_t bars = base + Tile::kBarOffset;
  const uint32_t qbar = bars;
  auto k_smem = [&](int st) {
    return base + Tile::kQBytes + st * 2 * Tile::kKBytes;
  };
  // per stage: K landed, V landed, K read by both warpgroups, V read
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + NST + st); };
  auto free_k = [&](int st) { return bars + 8 * (1 + 2 * NST + st); };
  auto free_v = [&](int st) { return bars + 8 * (1 + 3 * NST + st); };

  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup, broadcast from lane 0 so the compiler sees it uniform
  // across the warp: wgmma on a path it takes for divergent is serialised
  const int cw = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int nq = (p.s + kWgBlockQ - 1) / kWgBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kWgBlockQ;
  const int q_last = min(q0 + kWgBlockQ, p.s) - 1;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kvh = head / (p.h / p.kh);
  int lo, hi;
  live_keys(p, q0, q_last, BK, &lo, &hi);
  const int n_tiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;

  // Thread 0 is also the producer: it keeps up to NST tiles of K and V in
  // flight by TMA, refilling a stage once both warpgroups released it.  K_j
  // is released as soon as S_j is formed, so K tiles are refilled half an
  // iteration before V tiles.
  auto produce_k = [&](int j) {
    const int st = j % NST;
    mbar_wait(free_k(st), ((j / NST) & 1) ^ 1);
    mbar_expect(full_k(st), Tile::kKBytes);
    for (int d = 0; d < Tile::kBoxes; ++d)
      tma_load(k_smem(st) + d * Tile::kKBox, &tk, full_k(st), 64 * d, kvh,
               lo + j * BK, batch);
  };
  auto produce_v = [&](int j) {
    const int st = j % NST;
    mbar_wait(free_v(st), ((j / NST) & 1) ^ 1);
    mbar_expect(full_v(st), Tile::kKBytes);
    for (int d = 0; d < Tile::kBoxes; ++d)
      tma_load(k_smem(st) + Tile::kKBytes + d * Tile::kKBox, &tv, full_v(st),
               64 * d, kvh, lo + j * BK, batch);
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(free_k(st), 8);   // one arrival per warp
      mbar_init(free_v(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(qbar, Tile::kQBytes);
    for (int d = 0; d < Tile::kBoxes; ++d)
      tma_load(qs + d * Tile::kQBox, &tq, qbar, 64 * d, head, q0, batch);
    for (int j = 0; j < NST && j < n_tiles; ++j) {
      produce_k(j);
      produce_v(j);
    }
  }
  __syncthreads();

  const int wq = (tid / 32) & 3;           // warp within it: 16 rows each
  const int rq = 64 * cw + 16 * wq + (lane >> 2);   // rows rq, rq + 8
  const int row0 = q0 + rq;
  const int qa = q0 + 64 * cw, qb = min(qa + 63, p.s - 1);
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;
  const uint32_t q_rows = qs + cw * 64 * 128;
  // a tile whose every (row, key) pair is admitted skips the mask
  auto full_tile = [&](int k0) {
    return k0 + BK <= p.t && (!p.causal || k0 + BK - 1 <= qa) &&
           (p.window <= 0 || qb - k0 < p.window);
  };
  // S = Q K^T for the tile in stage st, both operands from shared memory
  float sc[BK / 2];
  auto issue_scores = [&](int st) {
    const uint32_t ks = k_smem(st);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t box = kk >> 2, in_row = (kk & 3) * 32;
      wgmma_scores<BK>(sc,
                       sw128_desc(q_rows + box * Tile::kQBox + in_row, 16),
                       sw128_desc(ks + box * Tile::kKBox + in_row, 16),
                       kk > 0);
    }
    wgmma_commit();
  };
  // O += P V for the tile in stage st, P from registers, V (MN-major) from
  // shared memory
  uint32_t pa[BK / 16][4];
  float acc[HD / 2];
  auto issue_values = [&](int st) {
    const uint32_t vs = k_smem(st) + Tile::kKBytes;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_values<HD>(acc, pa[kk],
                       sw128_desc(vs + kk * 16 * 128, Tile::kKBox));
    wgmma_commit();
  };
  // P (in sc) to the bf16 A fragments: rows (r, r + 8) x keys 16 (n / 2) ..
  // + 15; the output rescaled by corr
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
  auto softmax_tile = [&](int k0) {
    if (full_tile(k0)) {
      online_softmax<NS, false>(sc, p, row0, k0, lane, inv_cap, m, l, corr);
    } else {
      online_softmax<NS, true>(sc, p, row0, k0, lane, inv_cap, m, l, corr);
    }
  };
  auto to_values = [&]() {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      pa[n >> 1][(n & 1) * 2] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[4 * n] *= corr[0];
      acc[4 * n + 1] *= corr[0];
      acc[4 * n + 2] *= corr[1];
      acc[4 * n + 3] *= corr[1];
    }
  };

#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);
  if (n_tiles > 0) {
    mbar_wait(full_k(0), 0);
    fence_regs(sc);
    wgmma_fence();
    issue_scores(0);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(free_k(0));
    softmax_tile(lo);
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % NST, parity = (i / NST) & 1;
    const int st1 = (i + 1) % NST, parity1 = ((i + 1) / NST) & 1;
    const bool next = i + 1 < n_tiles;
    const int k1 = lo + (i + 1) * BK;
    to_values();
    // S_{i+1} = Q K_{i+1}^T and O += P_i V_i go out together, and the
    // softmax of tile i + 1 runs while O += P_i V_i is on the tensor
    // cores; the last tile's scores are a dummy product on its own stage
    // (K_i stays: no tile follows), so every wgmma is issued on a path
    // the whole warpgroup takes
    mbar_wait(full_v(st), parity);
    if (next) mbar_wait(full_k(st1), parity1);
    fence_regs(sc);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    issue_scores(next ? st1 : st);
    issue_values(st);
    if (tid == 0 && i + NST < n_tiles) produce_k(i + NST);
    __syncwarp();
    wgmma_wait<1>();   // the scores; O += P V may still run
    fence_regs(sc);
    if (next) {
      if (lane == 0) mbar_arrive(free_k(st1));
      softmax_tile(k1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(free_v(st));
    if (tid == 0 && i + NST < n_tiles) produce_v(i + NST);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    // uncapped, m is in raw score units (the scale went into the exponent)
    const int qi = row0 + 8 * r;
    if (p.lse != nullptr && (lane & 3) == 0 && qi < p.s)
      store_lse(p, batch, head, qi,
                m[r] == kMasked || p.softcap > 0.f ? m[r] : m[r] * p.scale,
                l[r]);
    l[r] = 1.f / l[r];
  }
  // out into this warpgroup's own Q rows (read by no wgmma any more), in
  // the tensor map's swizzled layout, then one TMA store of the block;
  // rows past S are clipped by the store
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rq + 8 * r;
      const int chunk = (n & 7) ^ (row & 7);
      const uint32_t off = (n >> 3) * Tile::kQBox + row * 128 + chunk * 16 +
                           (lane & 3) * 4;
      *reinterpret_cast<uint32_t*>(gbase + off) =
          pack_bf16(acc[4 * n + 2 * r] * l[r], acc[4 * n + 2 * r + 1] * l[r]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    for (int d = 0; d < Tile::kBoxes; ++d)
      tma_store(&to, qs + d * Tile::kQBox, 64 * d, head, q0, batch);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at head dims 64 and 80: wgmma fed by TMA, a producer warp, and
// two consumer warpgroups that take turns on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWsThreads = 288;   // two consumer warpgroups, a producer warp
constexpr int kGroup = 8;         // (batch, head) pairs a group of the grid

// 128 queries a block, 64 per consumer warpgroup; K/V tiles of 128 keys.
// Columns 0-63 of every tile are one box of 128-byte rows (128-byte
// swizzle); at hd 80 columns 64-79 are a second box right after it, of
// 32-byte rows (32-byte swizzle): a 160-byte row fits no swizzle atom.
template <int HD>
struct WsTile {
  static constexpr int BK = 128;
  static constexpr int kNarrow = HD - 64;            // columns past 64
  static constexpr int kQWide = kWgBlockQ * 128;     // bytes of Q's first box
  static constexpr int kKWide = BK * 128;
  static constexpr int kQBytes = kWgBlockQ * HD * 2;
  static constexpr int kKBytes = BK * HD * 2;
  // as many K/V stages as fit beside Q, 1 KB of alignment and the barriers
  static constexpr int kStages = (kMaxSmem - kQBytes - 2048) / (2 * kKBytes);
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKBytes;
  static constexpr size_t kSmemBytes = kBarOffset + 8 * (1 + 4 * kStages) +
                                       1024;
  static_assert(HD == 64 || HD == 80, "head dims 64 and 80");
  static_assert(kStages >= 2, "two K/V stages must fit");
};

// kCap: 1 when a softcap applies.  Fixed per instantiation, since a test
// of it among the scores costs instructions on every one.
template <int HD, int kCap>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_wgmma_ws(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tq2,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tk2,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tv2,
                   const __grid_constant__ CUtensorMap to,
                   const __grid_constant__ CUtensorMap to2, Params p) {
  using Tile = WsTile<HD>;
  constexpr int BK = Tile::BK, NST = Tile::kStages;
  constexpr int NS = BK / 8;   // score n8 blocks per thread
  constexpr bool kSplit = Tile::kNarrow > 0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms 1024-aligned
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t qs = base;
  const uint32_t bars = base + Tile::kBarOffset;
  const uint32_t qbar = bars;
  auto k_smem = [&](int st) {
    return base + Tile::kQBytes + st * 2 * Tile::kKBytes;
  };
  // per stage: K landed, V landed, K read by both warpgroups, V read
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + NST + st); };
  auto free_k = [&](int st) { return bars + 8 * (1 + 2 * NST + st); };
  auto free_v = [&](int st) { return bars + 8 * (1 + 3 * NST + st); };

  const int tid = threadIdx.x, lane = tid & 31;
  // 0 and 1: the consumer warpgroups; 2: the producer warp.  Broadcast from
  // lane 0 so the compiler sees it uniform across the warp
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // The (batch, head) pairs go in groups of kGroup; within a group the
  // blocks run heaviest query tile first, the group's heads side by side:
  // a wave reads the K/V of a few heads (which stay in L2), and the
  // lightest tiles come last
  const int nq = (p.s + kWgBlockQ - 1) / kWgBlockQ;
  const int n_bh = (int)gridDim.x / nq;
  const int group = (int)blockIdx.x / (kGroup * nq);
  const int in_group = (int)blockIdx.x - group * kGroup * nq;
  const int g_size = min(kGroup, n_bh - group * kGroup);
  const int bh = group * kGroup + in_group % g_size;
  const int q0 = (nq - 1 - in_group / g_size) * kWgBlockQ;
  const int q_last = min(q0 + kWgBlockQ, p.s) - 1;
  const int head = bh % p.h, batch = bh / p.h;
  const int kvh = head / (p.h / p.kh);
  int lo, hi;
  live_keys(p, q0, q_last, BK, &lo, &hi);
  const int n_tiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(free_k(st), 8);   // one arrival per consumer warp
      mbar_init(free_v(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // The producer: one thread loads Q, then keeps every stage of the ring
    // in flight, K_j and V_j each as soon as both warpgroups released the
    // stage's previous tile.  A warp of its own: thread 0 of a consumer as
    // the producer (the hd 128 body's way) held its warpgroup on every
    // refill and was slower here.
    if (lane == 0) {
      mbar_expect(qbar, Tile::kQBytes);
      tma_load(qs, &tq, qbar, 0, head, q0, batch);
      if constexpr (kSplit)
        tma_load(qs + Tile::kQWide, &tq2, qbar, 64, head, q0, batch);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NST, free_parity = ((j / NST) & 1) ^ 1;
        const int k0 = lo + j * BK;
        const uint32_t ks = k_smem(st), vs = ks + Tile::kKBytes;
        mbar_wait(free_k(st), free_parity);
        mbar_expect(full_k(st), Tile::kKBytes);
        tma_load(ks, &tk, full_k(st), 0, kvh, k0, batch);
        if constexpr (kSplit)
          tma_load(ks + Tile::kKWide, &tk2, full_k(st), 64, kvh, k0, batch);
        mbar_wait(free_v(st), free_parity);
        mbar_expect(full_v(st), Tile::kKBytes);
        tma_load(vs, &tv, full_v(st), 0, kvh, k0, batch);
        if constexpr (kSplit)
          tma_load(vs + Tile::kKWide, &tv2, full_v(st), 64, kvh, k0, batch);
      }
    }
    return;
  }

  // The two warpgroups issue their products in turn (named barrier 1 is
  // warpgroup 0's turn, 2 warpgroup 1's): each waits for its turn, issues,
  // and hands the turn over, so one warpgroup's softmax runs while the
  // other's products are on the tensor cores.  Warpgroup 0 goes first;
  // warpgroup 1 hands no turn over after its last issue, so every wait is
  // matched by exactly one hand-over.
  auto my_turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto your_turn = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  };

  const int wq = (tid / 32) & 3;           // warp within it: 16 rows each
  const int rq = 64 * wg + 16 * wq + (lane >> 2);   // rows rq, rq + 8
  const int row0 = q0 + rq;
  const int qa = q0 + 64 * wg, qb = min(qa + 63, p.s - 1);
  const uint32_t q_rows = qs + wg * 64 * 128;
  const uint32_t q_rows2 = qs + Tile::kQWide + wg * 64 * 32;
  // a tile whose every (row, key) pair is admitted skips the mask
  auto full_tile = [&](int k0) {
    return k0 + BK <= p.t && (!p.causal || k0 + BK - 1 <= qa) &&
           (p.window <= 0 || qb - k0 < p.window);
  };
  // S = Q K^T for the tile in stage st, both operands K-major from shared
  // memory: 4 k-steps in the first box, at hd 80 a fifth in the second
  float sc[BK / 2];
  auto issue_scores = [&](int st) {
    const uint32_t ks = k_smem(st);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n128(sc, sw128_desc(q_rows + kk * 32, 16),
                    sw128_desc(ks + kk * 32, 16), kk > 0);
    if constexpr (kSplit)
      wgmma_ss_n128(sc, sw32_desc(q_rows2), sw32_desc(ks + Tile::kKWide), 1);
    wgmma_commit();
  };
  // O += P V for the tile in stage st, P from registers, V MN-major from
  // shared memory: columns 0-63 in one product, at hd 80 columns 64-79 in
  // a second (accumulator split 32 + 8 floats)
  uint32_t pa[BK / 16][4];
  float acc[32];
  float acc2[kSplit ? 8 : 1];
  auto issue_values = [&](int st) {
    const uint32_t vs = k_smem(st) + Tile::kKBytes;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs_n64(acc, pa[kk], sw128_desc(vs + kk * 16 * 128, Tile::kKWide));
      if constexpr (kSplit)
        wgmma_rs_n16(acc2, pa[kk], sw32_desc(vs + Tile::kKWide + kk * 16 * 32));
    }
    wgmma_commit();
  };
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
  const float inv_cap = kCap ? 1.f / p.softcap : 0.f;
  auto softmax_tile = [&](int k0) {
    if (full_tile(k0)) {
      online_softmax<NS, false, kCap>(sc, p, row0, k0, lane, inv_cap, m, l,
                                      corr);
    } else {
      online_softmax<NS, true, kCap>(sc, p, row0, k0, lane, inv_cap, m, l,
                                     corr);
    }
  };
  // P (in sc) to the bf16 A fragments: rows (r, r + 8) x keys 16 (n / 2) ..
  // + 15; the output rescaled by corr
  auto to_values = [&]() {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      pa[n >> 1][(n & 1) * 2] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
    }
    // a warp none of whose rows raised its max leaves the output as it is
    // (corr is exactly 1 then)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];
      if constexpr (kSplit) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc2[i] *= corr[(i >> 1) & 1];
      }
    }
  };

#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kSplit ? 8 : 1); ++i) acc2[i] = 0.f;
  mbar_wait(qbar, 0);
  if (n_tiles > 0) {
    if (wg == 1) your_turn();   // warpgroup 0 goes first
    mbar_wait(full_k(0), 0);
    fence_regs(sc);
    my_turn();
    wgmma_fence();
    issue_scores(0);
    your_turn();   // never the last issue: O += P_0 V_0 follows
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(free_k(0));
    softmax_tile(lo);
  }

  // Tile i: S_{i+1} = Q K_{i+1}^T and O += P_i V_i go out together, and
  // the softmax of tile i + 1 runs while O += P_i V_i is on the tensor
  // cores.  The last tile issues O += P V alone, in a step of its own: no
  // wgmma sits under a branch (ptxas then serialises every wgmma).
  auto step = [&](int i, auto has_next) {
    constexpr bool kNext = decltype(has_next)::value;
    const int st = i % NST, parity = (i / NST) & 1;
    const int st1 = (i + 1) % NST, parity1 = ((i + 1) / NST) & 1;
    to_values();
    mbar_wait(full_v(st), parity);
    if constexpr (kNext) mbar_wait(full_k(st1), parity1);
    fence_regs(sc);
    fence_regs(acc);
    fence_regs(acc2);
    fence_regs(pa);
    my_turn();
    wgmma_fence();
    if constexpr (kNext) issue_scores(st1);
    issue_values(st);
    if (kNext || wg == 0) your_turn();
    if constexpr (kNext) {
      wgmma_wait<1>();   // the scores; O += P V may still run
      fence_regs(sc);
      if (lane == 0) mbar_arrive(free_k(st1));
      softmax_tile(lo + (i + 1) * BK);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(acc2);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(free_v(st));
  };
  for (int i = 0; i + 1 < n_tiles; ++i) step(i, std::true_type{});
  if (n_tiles > 0) step(n_tiles - 1, std::false_type{});

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    // m is in raw score units uncapped (the scale went into the exponent),
    // in tanh units capped (the softcap went there)
    const int qi = row0 + 8 * r;
    if (p.lse != nullptr && (lane & 3) == 0 && qi < p.s)
      store_lse(p, batch, head, qi,
                m[r] == kMasked ? m[r] : m[r] * (kCap ? p.softcap : p.scale),
                l[r]);
    l[r] = 1.f / l[r];
  }
  // out into this warpgroup's own Q rows (read by no wgmma any more), in
  // the tensor maps' swizzled layouts, then the warpgroup's own TMA store
  // of its 64 rows; rows past S are clipped by the store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rq + 8 * r;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t off = row * 128 + ((n ^ (row & 7)) * 16) +
                           (lane & 3) * 4;
      *reinterpret_cast<uint32_t*>(gbase + off) =
          pack_bf16(acc[4 * n + 2 * r] * l[r], acc[4 * n + 2 * r + 1] * l[r]);
    }
    if constexpr (kSplit) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t off = Tile::kQWide + row * 32 +
                             ((n ^ ((row >> 2) & 1)) * 16) + (lane & 3) * 4;
        *reinterpret_cast<uint32_t*>(gbase + off) = pack_bf16(
            acc2[4 * n + 2 * r] * l[r], acc2[4 * n + 2 * r + 1] * l[r]);
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
  if (tid % 128 == 0) {
    tma_store(&to, q_rows, 0, head, qa, batch);
    if constexpr (kSplit) tma_store(&to2, q_rows2, 64, head, qa, batch);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32BlockK = 64;

template <int HD>
struct F32Tile {
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)kBlockQ * HD + kF32BlockK * (HD + 1) +
                       kF32BlockK * HD + kBlockQ * (kF32BlockK + 1));
};

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads) flash_f32(Params p) {
  constexpr int BK = kF32BlockK, LDK = HD + 1, LDP = BK + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [64][HD]
  float* ks = qs + kBlockQ * HD;  // [BK][HD + 1]
  float* vs = ks + BK * LDK;      // [BK][HD]
  float* ps = vs + BK * HD;       // [64][BK + 1]

  // thread (ty, tx): query rows ty + 16 i, keys tx + 16 j, columns tx + 16 c;
  // a row's 16 threads are 16 lanes of one warp
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nq = (p.s + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBlockQ;
  const int q_last = min(q0 + kBlockQ, p.s) - 1;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kvh = head / (p.h / p.kh);
  const int64_t q_step = (int64_t)p.h * HD, kv_step = (int64_t)p.kh * HD;
  const float* qg = static_cast<const float*>(p.q) +
                    ((int64_t)batch * p.s * p.h + head) * HD;
  const float* kg = static_cast<const float*>(p.k) +
                    ((int64_t)batch * p.t * p.kh + kvh) * HD;
  const float* vg = static_cast<const float*>(p.v) +
                    ((int64_t)batch * p.t * p.kh + kvh) * HD;
  float* og = static_cast<float*>(p.out) +
              ((int64_t)batch * p.s * p.h + head) * HD;

  for (int e = tid; e < kBlockQ * HD; e += kF32Threads) {
    const int r = e / HD, d = e - r * HD, qi = q0 + r;
    qs[e] = qi < p.s ? qg[qi * q_step + d] : 0.f;
  }

  float acc[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  live_keys(p, q0, q_last, BK, &lo, &hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = tid; e < BK * HD; e += kF32Threads) {
      const int r = e / HD, d = e - r * HD, kj = k0 + r;
      const bool in = kj < p.t;
      ks[r * LDK + d] = in ? kg[kj * kv_step + d] : 0.f;
      vs[r * HD + d] = in ? vg[kj * kv_step + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        ok[j] = admitted(p, qi, k0 + tx + 16 * j);
        sc[i][j] = ok[j] ? x : kMasked;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = pe;
        rs += pe;
      }
      l[i] = l[i] * corr + rs;  // per-thread partial; summed at the end
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(sum16(l[i]), 1e-30f);
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.s) continue;
    if (p.lse != nullptr && tx == 0) store_lse(p, batch, head, qi, m[i], li);
#pragma unroll
    for (int c = 0; c < NC; ++c) og[qi * q_step + tx + 16 * c] = acc[i][c] / li;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const Params& p, int b,
           cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.s + kBlockQ - 1) / kBlockQ, p.h, b);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

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

// A bf16 (B, rows, heads, hd) tensor as a 4-d map (hd, heads, rows, B):
// boxes of box_cols columns (64, 128-byte swizzled; or 16, 32-byte
// swizzled) x one head x box_rows rows x one sequence; rows past `rows`
// read as zeros and are not written, per sequence
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int rows,
              int b, int box_rows, int box_cols = 64) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)heads * hd * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, row, row * rows};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const Params& p, int b, cudaStream_t stream) {
  using Tile = WgTile<HD>;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, p.q, HD, p.h, p.s, b, kWgBlockQ) ||
      !make_map(&tk, p.k, HD, p.kh, p.t, b, Tile::BK) ||
      !make_map(&tv, p.v, HD, p.kh, p.t, b, Tile::BK) ||
      !make_map(&to, p.out, HD, p.h, p.s, b, kWgBlockQ))
    return (int)cudaErrorNotSupported;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.s + kWgBlockQ - 1) / kWgBlockQ, p.h, b);
  flash_wgmma<HD><<<grid, kWgThreads, Tile::kSmemBytes, stream>>>(tq, tk, tv,
                                                                  to, p);
  return (int)cudaGetLastError();
}

template <int HD, int kCap>
int launch_ws(const Params& p, int b, cudaStream_t stream) {
  using Tile = WsTile<HD>;
  // at hd 80 each tensor is two maps over the same memory: columns 0-63
  // and 64-79 (at hd 64 the second is never read)
  constexpr int kCols2 = Tile::kNarrow > 0 ? Tile::kNarrow : 64;
  CUtensorMap tq, tq2, tk, tk2, tv, tv2, to, to2;
  if (!make_map(&tq, p.q, HD, p.h, p.s, b, kWgBlockQ) ||
      !make_map(&tq2, p.q, HD, p.h, p.s, b, kWgBlockQ, kCols2) ||
      !make_map(&tk, p.k, HD, p.kh, p.t, b, Tile::BK) ||
      !make_map(&tk2, p.k, HD, p.kh, p.t, b, Tile::BK, kCols2) ||
      !make_map(&tv, p.v, HD, p.kh, p.t, b, Tile::BK) ||
      !make_map(&tv2, p.v, HD, p.kh, p.t, b, Tile::BK, kCols2) ||
      !make_map(&to, p.out, HD, p.h, p.s, b, 64) ||
      !make_map(&to2, p.out, HD, p.h, p.s, b, 64, kCols2))
    return (int)cudaErrorNotSupported;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_ws<HD, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // one dimension over (batch, head, query tile), in the kernel's order
  const dim3 grid(p.h * b * ((p.s + kWgBlockQ - 1) / kWgBlockQ));
  flash_wgmma_ws<HD, kCap><<<grid, kWsThreads, Tile::kSmemBytes, stream>>>(
      tq, tq2, tk, tk2, tv, tv2, to, to2, p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const Params& p, int b, cudaStream_t stream) {
  if (dtype == 1) {
    if constexpr (HD >= 128) {
      return launch_wgmma<HD>(p, b, stream);
    } else if constexpr (HD >= 64) {
      return p.softcap > 0.f ? launch_ws<HD, 1>(p, b, stream)
                             : launch_ws<HD, 0>(p, b, stream);
    } else {
      return launch(flash_bf16<HD>, 128, kBf16SmemBytes<HD>, p, b, stream);
    }
  }
  return launch(flash_f32<HD>, kF32Threads, F32Tile<HD>::kSmemBytes, p, b,
                stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q, out (B, S, H, hd) and k, v (B, T, Kh,
// hd), contiguous, 16-byte aligned; lse null, or (B, H, S) float32.
// Returns a cudaError_t; an unsupported head dim or type is
// cudaErrorInvalidValue and launches nothing.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int dtype,
                                      int b, int s, int t, int h, int kh,
                                      int hd, int causal, int window,
                                      float scale, float softcap,
                                      void* stream) {
  if ((dtype != 0 && dtype != 1) || b < 1 || s < 1 || t < 1 || kh < 1 ||
      h % kh != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out, static_cast<float*>(lse), s, t, h, kh,
                 causal, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(dtype, p, b, st);
    case 32: return launch_hd<32>(dtype, p, b, st);
    case 64: return launch_hd<64>(dtype, p, b, st);
    case 80: return launch_hd<80>(dtype, p, b, st);
    case 128: return launch_hd<128>(dtype, p, b, st);
    case 256: return launch_hd<256>(dtype, p, b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

namespace {
template <typename Tile>
int tiling(int* bk, int* stages, int* smem_bytes) {
  *bk = Tile::BK;
  *stages = Tile::kStages;
  *smem_bytes = (int)Tile::kSmemBytes;
  return 0;
}
}  // namespace

// The bf16 tiling of a wgmma body at head dim hd (64 and 80: flash_wgmma_ws;
// 128 and 256: flash_wgmma): keys a tile, K/V stages and dynamic shared
// memory; returns -1 for another head dim.
extern "C" int flash_attention_tiling(int hd, int* bk, int* stages,
                                      int* smem_bytes) {
  switch (hd) {
    case 64: return tiling<WsTile<64>>(bk, stages, smem_bytes);
    case 80: return tiling<WsTile<80>>(bk, stages, smem_bytes);
    case 128: return tiling<WgTile<128>>(bk, stages, smem_bytes);
    case 256: return tiling<WgTile<256>>(bk, stages, smem_bytes);
    default: return -1;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
