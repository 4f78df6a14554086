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
// (B 1, S 32768, H 32) r, k, v and logw are read and out is written once:
// 1.34 GB, 0.40 ms at 3.35 TB/s, against about 4 K V flops per token and
// head, 0.26 ms of the f32 pipes.  The TPU kernel walked the chunks of a
// (b, h) as its sequential grid axis, carried the (K, V) state in VMEM
// scratch, and built the (C, C, K) in-chunk decay in VMEM so it never
// reached HBM.
//
// Design.  One block of 256 threads owns one (b, h) and 16 of its 64 value
// columns: each column of the state evolves on its own (out[:, v] needs only
// S[:, v]), so B H 4 blocks run, 128 at the served prefill.  The block walks
// its chunks of 32 tokens in order with its slice of the state on chip (in
// registers, mirrored in shared memory for the cross term), and cp.async
// fetches the next chunk's rows while the current one is computed.  Per
// chunk, with L_t the inclusive cumulative log-decay (kept in base-2 units):
//   cross_t  = (r_t * 2^L_{t-1}) . S                 (state at chunk start)
//   intra_t  = sum_{s<t} [sum_k r_tk k_sk 2^(L_{t-1,k} - L_{s,k})] v_s
//   bonus_t  = (r_t . (u * k_t)) v_t
//   S       <- diag(2^L_{C-1}) S + sum_s (k_s * 2^(L_{C-1} - L_s)) v_s^T
// Every exponent is a difference L_a - L_s with s <= a, so it is <= 0 and
// nothing overflows, however fast the decay: the pairwise decay is
// exponentiated per (t, s, k) and never factorised into 2^L_t 2^-L_s.  The
// in-chunk decay lives only in registers; the 32 x 32 scores only in shared
// memory.  Products run on the CUDA cores in float32 FMA.  No atomics: one
// thread owns each output and state element, so two runs give the same
// bits.  Any S >= 1: rows past S are zero-filled (r = k = v = logw = 0
// leaves the state as it is) and not written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 64;                  // key width (head size)
constexpr int kV = 64;                  // value width
constexpr int kC = 32;                  // tokens per chunk
constexpr int kVS = 16;                 // value columns per block
constexpr int kSlices = kV / kVS;
constexpr int kThreads = 256;
constexpr int kLd = kK + 4;             // padded row: float4-aligned, and
                                        // rows t, t+1 start 4 banks apart
constexpr int kPairs = kC * (kC - 1) / 2;
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  float r[2][kC][kLd];                  // double-buffered chunk rows
  float k[2][kC][kLd];
  float w[2][kC][kLd];
  float v[2][kC][kVS];
  float lin[kC][kLd];                   // L_t, base 2
  float a[kC][kLd];                     // r_t * 2^L_{t-1}
  float kd[kC][kLd];                    // k_s * 2^(L_{C-1} - L_s)
  float scores[kC][kC + 1];             // strictly lower triangle used
  float state[kK][kVS];
  float u[kK];
  float etot[kK];                       // 2^L_{C-1}
  float bonus[kC];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0));
}

// Stage chunk rows t0 .. t0 + kC - 1 of one (b, h) into buffer `buf`; rows
// at or past S are zero-filled (their source is row 0, never read).
__device__ __forceinline__ void load_chunk(Smem& sm, int buf, const float* r,
                                           const float* k, const float* v,
                                           const float* w, int64_t row0,
                                           int64_t stride, int t0, int s,
                                           int v0) {
  for (int p = threadIdx.x; p < kC * (kK / 4); p += kThreads) {
    const int t = p / (kK / 4), c4 = (p % (kK / 4)) * 4;
    const bool live = t0 + t < s;
    const int64_t off = row0 + (live ? t0 + t : 0) * stride + c4;
    cp_async16(&sm.r[buf][t][c4], r + off, live);
    cp_async16(&sm.k[buf][t][c4], k + off, live);
    cp_async16(&sm.w[buf][t][c4], w + off, live);
  }
  for (int p = threadIdx.x; p < kC * (kVS / 4); p += kThreads) {
    const int t = p / (kVS / 4), c4 = (p % (kVS / 4)) * 4;
    const bool live = t0 + t < s;
    const int64_t off = row0 + (live ? t0 + t : 0) * stride + v0 + c4;
    cp_async16(&sm.v[buf][t][c4], v + off, live);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, 2)
rwkv6_wkv_f32(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ s0,
              float* __restrict__ out, float* __restrict__ sout, int s,
              int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / kSlices;
  const int v0 = (blockIdx.x % kSlices) * kVS;
  const int b = bh / h, hh = bh % h;
  const int64_t stride = (int64_t)h * kK;            // one token's row
  const int64_t row0 = (int64_t)b * s * stride + (int64_t)hh * kK;
  const int n_chunks = (s + kC - 1) / kC;

  // this thread's state elements S[ck .. ck+3][cv] and output rows tq and
  // kC - 1 - tq (31 intra terms between the two, whatever tq is)
  const int cv = tid % kVS;
  const int ck = (tid / kVS) * 4;
  const int tq = tid / kVS;
  const float* s0p = s0 + (int64_t)bh * kK * kV;
  float st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st[i] = s0p[(ck + i) * kV + v0 + cv];
    sm.state[ck + i][cv] = st[i];
  }
  if (tid < kK) sm.u[tid] = u[hh * kK + tid];
  load_chunk(sm, 0, r, k, v, w, row0, stride, 0, s, v0);

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (c + 1 < n_chunks)
      load_chunk(sm, buf ^ 1, r, k, v, w, row0, stride, (c + 1) * kC, s, v0);

    // 1. cumulative log-decay per key column; the u bonus per token
    if (tid < kK) {
      float acc = 0.0f;
#pragma unroll 8
      for (int t = 0; t < kC; ++t) {
        acc += sm.w[buf][t][tid];
        sm.lin[t][tid] = acc * kLog2e;
      }
    } else if (tid < kK + kC) {
      const int t = tid - kK;
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < kK; ++j)
        acc = fmaf(sm.r[buf][t][j] * sm.u[j], sm.k[buf][t][j], acc);
      sm.bonus[t] = acc;
    }
    __syncthreads();

    // 2. decayed r and k, the chunk's total decay, and the pairwise scores
    for (int e = tid; e < kC * kK; e += kThreads) {
      const int t = e / kK, j = e % kK;
      const float prev = t ? sm.lin[t - 1][j] : 0.0f;
      sm.a[t][j] = sm.r[buf][t][j] * ex2(prev);
      sm.kd[t][j] = sm.k[buf][t][j] * ex2(sm.lin[kC - 1][j] - sm.lin[t][j]);
    }
    if (tid < kK) sm.etot[tid] = ex2(sm.lin[kC - 1][tid]);
    for (int p = tid; p < kPairs; p += kThreads) {
      // p = t (t - 1) / 2 + s, 0 <= s < t: the strict lower triangle
      int t = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)p)) * 0.5f);
      while (t * (t - 1) / 2 > p) --t;
      while ((t + 1) * t / 2 <= p) ++t;
      const int sp = p - t * (t - 1) / 2;
      const float4* rt = reinterpret_cast<const float4*>(sm.r[buf][t]);
      const float4* lt = reinterpret_cast<const float4*>(sm.lin[t - 1]);
      const float4* ks = reinterpret_cast<const float4*>(sm.k[buf][sp]);
      const float4* ls = reinterpret_cast<const float4*>(sm.lin[sp]);
      float acc = 0.0f;
#pragma unroll 4
      for (int q = 0; q < kK / 4; ++q) {
        const float4 a = rt[q], la = lt[q], b4 = ks[q], lb = ls[q];
        acc = fmaf(a.x * b4.x, ex2(la.x - lb.x), acc);
        acc = fmaf(a.y * b4.y, ex2(la.y - lb.y), acc);
        acc = fmaf(a.z * b4.z, ex2(la.z - lb.z), acc);
        acc = fmaf(a.w * b4.w, ex2(la.w - lb.w), acc);
      }
      sm.scores[t][sp] = acc;
    }
    __syncthreads();

    // 3. two output rows per thread, then its four state elements
    const int t0 = tq, t1 = kC - 1 - tq;
    float o0 = 0.0f, o1 = 0.0f;
    const float4* a0 = reinterpret_cast<const float4*>(sm.a[t0]);
    const float4* a1 = reinterpret_cast<const float4*>(sm.a[t1]);
#pragma unroll 4
    for (int q = 0; q < kK / 4; ++q) {
      const float4 x0 = a0[q], x1 = a1[q];
      const float s_0 = sm.state[4 * q][cv], s_1 = sm.state[4 * q + 1][cv];
      const float s_2 = sm.state[4 * q + 2][cv], s_3 = sm.state[4 * q + 3][cv];
      o0 = fmaf(x0.x, s_0, o0); o0 = fmaf(x0.y, s_1, o0);
      o0 = fmaf(x0.z, s_2, o0); o0 = fmaf(x0.w, s_3, o0);
      o1 = fmaf(x1.x, s_0, o1); o1 = fmaf(x1.y, s_1, o1);
      o1 = fmaf(x1.z, s_2, o1); o1 = fmaf(x1.w, s_3, o1);
    }
    for (int sp = 0; sp < t1; ++sp) {       // t0 < t1 always
      const float vv = sm.v[buf][sp][cv];
      o1 = fmaf(sm.scores[t1][sp], vv, o1);
      if (sp < t0) o0 = fmaf(sm.scores[t0][sp], vv, o0);
    }
    o0 = fmaf(sm.bonus[t0], sm.v[buf][t0][cv], o0);
    o1 = fmaf(sm.bonus[t1], sm.v[buf][t1][cv], o1);
    const int tb = c * kC;
    if (tb + t0 < s) out[row0 + (tb + t0) * stride + v0 + cv] = o0;
    if (tb + t1 < s) out[row0 + (tb + t1) * stride + v0 + cv] = o1;

    float ns[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ns[i] = sm.etot[ck + i] * st[i];
#pragma unroll 4
    for (int sp = 0; sp < kC; ++sp) {
      const float4 kk = *reinterpret_cast<const float4*>(&sm.kd[sp][ck]);
      const float vv = sm.v[buf][sp][cv];
      ns[0] = fmaf(kk.x, vv, ns[0]);
      ns[1] = fmaf(kk.y, vv, ns[1]);
      ns[2] = fmaf(kk.z, vv, ns[2]);
      ns[3] = fmaf(kk.w, vv, ns[3]);
    }
    __syncthreads();  // every read of the chunk-start state is done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st[i] = ns[i];
      sm.state[ck + i][cv] = ns[i];
    }
  }

  float* so = sout + (int64_t)bh * kK * kV;
#pragma unroll
  for (int i = 0; i < 4; ++i) so[(ck + i) * kV + v0 + cv] = st[i];
}

}  // namespace

extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* logw, const void* u,
                                const void* state0, void* out, void* state,
                                int b, int s, int h, void* stream) {
  const size_t smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_wkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_wkv_f32<<<b * h * kSlices, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(out), static_cast<float*>(state), s, h);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
