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
// in float32 inside, cast back to the input type.  Masked scores take the
// finite sentinel -1e30, as the Pallas kernel does, so a row whose first
// live tile admits none of its keys keeps exp(m_prev - m_new) = 1 and never
// forms exp(-inf + inf).
//
// What bounds it on the H100: operations.  At the served gemma2-9b shape
// (B 2, S 4608, H 16, Kh 8, hd 256) one layer needs 4 * hd flops per
// admitted (query, key) pair, 3.5e11 for a causal layer: 0.35 ms of bf16
// tensor cores against 0.02 ms to read q, k, v and write out once.  The
// TPU kernel walked the kv chunks as a sequential grid axis with its
// (m, l, acc) carry in VMEM scratch and skipped dead chunks with pl.when.
//
// Design.  One block owns one (batch, head, 64-query tile) and walks the
// live kv tiles in a loop: keys up to the tile's last query when causal,
// and from window - 1 keys before its first query when windowed, so dead
// tiles cost nothing.  Heavy (late) query tiles are scheduled first.  K and
// V tiles are staged in shared memory; the running max, sum and output
// accumulator stay in registers in float32.  Two forms, by input type:
//   - bfloat16: four warps, each owning 16 query rows, run both products
//     on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 out):
//     Q K^T from ldmatrix fragments, then P V with the probabilities
//     packed to bf16 straight from the score registers.  Rows are padded by
//     16 bytes so ldmatrix's eight row reads hit distinct banks.  K and V
//     tiles are double-buffered: cp.async fetches the next tile while the
//     current one is computed.  Tiles where every pair is admitted skip
//     the mask.  The softcap's tanh is the hardware tanh.approx.
//   - float32: 256 threads on the CUDA cores, each owning 4 query rows x
//     4 keys of the score tile and 4 rows x hd/16 columns of the output.
//     K rows are padded to hd + 1 floats so the 16 keys a warp reads at one
//     depth lie in distinct banks.  This form exists for float32 parity.
// No atomics: two runs give the same bits.  Any S >= 1: the ragged last
// query tile and kv tile are zero-filled and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  int s, t, h, kh, causal, window;
  float scale, softcap;
};

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
// bfloat16 on the tensor cores
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

// 32 keys per tile keeps the score registers down at hd 256 and, with K
// and V double-buffered (two stages), the shared memory small enough for
// several blocks per SM at hd 128
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
    __nv_bfloat16* orow = og + qi * q_step + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * i] / l[i], acc[n][2 * i + 1] / l[i]);
    }
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

template <int HD>
int launch_hd(int dtype, const Params& p, int b, cudaStream_t stream) {
  if (dtype == 1)
    return launch(flash_bf16<HD>, 128, kBf16SmemBytes<HD>, p, b, stream);
  return launch(flash_f32<HD>, kF32Threads, F32Tile<HD>::kSmemBytes, p, b,
                stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q, out (B, S, H, hd) and k, v (B, T, Kh,
// hd), contiguous, 16-byte aligned.  Returns a cudaError_t; an unsupported
// head dim or type is cudaErrorInvalidValue and launches nothing.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int b, int s, int t, int h, int kh,
                                      int hd, int causal, int window,
                                      float scale, float softcap,
                                      void* stream) {
  if ((dtype != 0 && dtype != 1) || b < 1 || s < 1 || t < 1 || kh < 1 ||
      h % kh != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out, s, t, h, kh, causal, window, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(dtype, p, b, st);
    case 32: return launch_hd<32>(dtype, p, b, st);
    case 64: return launch_hd<64>(dtype, p, b, st);
    case 128: return launch_hd<128>(dtype, p, b, st);
    case 256: return launch_hd<256>(dtype, p, b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
