// Masked, weighted embedding-bag pooling over a flat (T*R, s) row space,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/embedding_bag.py:
//   B1  _stacked_kernel_vec (:782) and its scalar twin _stacked_kernel
//       (:762), the resident stacked form (pallas_call at :867);
//   B2  _stream_kernel_vec (:465) and its scalar twin _stream_kernel (:415),
//       the row-block-streamed form over the flat row space (pallas_call at
//       :619), which serves embedding_bag_rows too;
//   B4  _kernel_vec (:689) and its scalar twin _kernel (:649), the
//       single-table form (pallas_call at :742).
// All of them compute
//   out[n, :] = sum_h  w[n, h] * table[t(n) * R + clamp(idx[n, h], 0, R-1), :]
// where t(n) is tid[n] (rows form) or n % T (stacked form, n = b*T + t).
//
// What bounds it on the H100: bytes.  Each slot reads one s-wide row from a
// random place in a multi-GB table (256 B at s = 64 f32) plus 8 B of id and
// weight, and does one multiply-add per element read.  At the serving shapes
// (13,312 bags, up to 100 slots each) that is ~340 MB of row reads against
// 3.35 TB/s of device memory.
//
// Design.  The TPU kernels bucketed ids by row block so that their DMAs
// fetched only the touched blocks into VMEM.  Here rows come straight from
// device memory through L2, so there is no staging and no plan: one warp
// owns one bag.  Lanes cover s with V-wide vector loads (s = 64 f32: 32
// lanes x float2, one 256-byte row per warp instruction, fully coalesced).
// The slot loop walks h = 0..hot-1 in order and accumulates in f32
// registers; it is unrolled so several row loads are in flight before their
// adds, which stay in order.  A bag has one owner, so there are no atomics
// and every run gives the same bits.  Every slot is read, zero-weight ones
// included, so a NaN row times weight 0 stays NaN as in the reference.
// Row offsets are 64-bit: a Kaggle-width stack holds up to 2.26e9 elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void add_scaled(float (&acc)[1], float w, float v) {
  acc[0] += __fmul_rn(w, v);
}
__device__ __forceinline__ void add_scaled(float (&acc)[2], float w, float2 v) {
  acc[0] += __fmul_rn(w, v.x);
  acc[1] += __fmul_rn(w, v.y);
}
__device__ __forceinline__ void add_scaled(float (&acc)[4], float w, float4 v) {
  acc[0] += __fmul_rn(w, v.x);
  acc[1] += __fmul_rn(w, v.y);
  acc[2] += __fmul_rn(w, v.z);
  acc[3] += __fmul_rn(w, v.w);
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bag_pool_f32(const float* __restrict__ table, const int32_t* __restrict__ idx,
             const float* __restrict__ w, const int32_t* __restrict__ tid,
             float* __restrict__ out, int64_t n_bags, int hot, int s,
             int64_t rows, int n_tables) {
  using VT = typename Vec<V>::T;
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  int t = tid != nullptr ? tid[bag] : (int)(bag % n_tables);
  t = min(max(t, 0), n_tables - 1);
  const float* base = table + (int64_t)t * rows * s;
  const int32_t* ib = idx + bag * hot;
  const float* wb = w + bag * hot;
  for (int c = lane * V; c < s; c += 32 * V) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll 4
    for (int h = 0; h < hot; ++h) {
      const int64_t r = clamp64(__ldg(ib + h), 0, rows - 1);
      const float wt = __ldg(wb + h);
      const VT x = __ldg(reinterpret_cast<const VT*>(base + r * s + c));
      add_scaled(acc, wt, x);
    }
    float* o = out + bag * s + c;
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = acc[v];
  }
}

}  // namespace

extern "C" int embedding_bag_pool_f32(const void* table, const void* idx,
                                      const void* w, const void* tid,
                                      void* out, int64_t n_bags, int hot,
                                      int s, int64_t rows, int n_tables,
                                      void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(table);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* wt = static_cast<const float*>(w);
  const int32_t* td = static_cast<const int32_t*>(tid);
  float* ob = static_cast<float*>(out);
  if (s % 4 == 0 && s >= 128) {
    bag_pool_f32<4><<<grid, block, 0, st>>>(tb, ix, wt, td, ob, n_bags, hot,
                                            s, rows, n_tables);
  } else if (s % 2 == 0) {
    bag_pool_f32<2><<<grid, block, 0, st>>>(tb, ix, wt, td, ob, n_bags, hot,
                                            s, rows, n_tables);
  } else {
    bag_pool_f32<1><<<grid, block, 0, st>>>(tb, ix, wt, td, ob, n_bags, hot,
                                            s, rows, n_tables);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
