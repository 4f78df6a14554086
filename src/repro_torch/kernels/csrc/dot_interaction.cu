// DLRM pairwise dot interaction, written by hand for Hopper (sm_90a).
//
// Replaces B3, the Pallas kernel _kernel (:24) of
// src/repro/kernels/dot_interaction.py (pallas_call at :52): for each sample
// the strict lower triangle of Z Z^T, with Z its (F, S) feature block, in
// np.tril_indices(F, -1) row-major order — pair (i, j), i > j, lands at
// output index i(i-1)/2 + j.
//
// What bounds it on the H100: at serving sizes, launch and ramp.  A
// (128, 27, 64) f32 input is 0.88 MB and the (128, 351) output 0.18 MB,
// about 0.32 us at 3.35 TB/s; the 5.8 MFLOP of dots are ~0.09 us of the f32
// pipes.  What is left to the kernel is latency: one round trip to stage a
// sample, a short chain of dependent multiply-adds, one write.  The TPU
// kernel spent two MXU matmuls (the Gram matrix, then a one-hot selection)
// to keep the F x F Gram matrix out of HBM.
//
// Design.  One block of 256 threads owns one sample.
//  * Staging: the sample's contiguous F x S block lands in shared memory
//    with 16-byte loads, all issued before the first store (one round trip),
//    rows padded to a stride whose 16-byte units are
//    odd in number, so the eight threads of a quarter-warp that read
//    float4s of different rows at one column hit different banks; F is
//    padded to an even count with a zero row.
//  * Register tiles: the lower triangle of the (padded) Gram matrix is cut
//    into 2 x 2 tiles, diagonal tiles included (105 at F = 27).  Tile q is
//    taken from its position by walking the tile rows (ti, tj <= ti), with no
//    square root.  Each tile is split over KP threads (a power of two, as
//    many as fit in the block: 2 at F = 27) that take every KP-th float4 of
//    the features; a thread keeps 2 x 2 x 4 independent partial sums (one
//    per tile entry and float4 component), so its fmaf chains are S / (4 KP)
//    long and 16 wide.
//  * Fixed-order combine: per entry (x + y) + (z + w), then an xor-shuffle
//    tree over the KP threads; every thread of the tree ends with the same
//    bits, so two runs agree bit for bit.  kernels/ref.py::
//    dot_interaction_split_ref is the CPU model of this order (fused
//    multiply-adds included: bit-exact to the float4 schedule).
//  * f32 on the CUDA cores only (no TF32, no tensor cores), so the kernel
//    holds 1e-5 against the plain version.
// S not a multiple of 4 (or z not 16-byte aligned) takes the same schedule
// with scalar loads.  A padded block over the 48 KB default opts into up to
// 227 KB of dynamic shared memory.  dot_interaction_empty launches an empty
// kernel on the same grid, so a run can time the launch-and-ramp floor
// beside the kernel.
// bf16 features (dot_interaction_bf16_launch) take the same body: each
// sample's block is read as 8-byte units of 4 bf16 (single elements where
// S is not a multiple of 4 or z not 8-byte aligned), widened to f32
// exactly and staged in the same padded f32 layout, so the products, the
// KP split and the combine are the f32 kernel's; each output is rounded
// once to bf16 (to nearest, ties to even).  Shared memory holds the
// staged f32 rows: (F + 1) x (S + 4) floats, as for f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// float4 loads one thread issues together while staging
constexpr int kStageUnroll = 4;
constexpr size_t kDefaultSmem = 48 * 1024;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<4> { using T = float4; };

// The V-element unit a thread loads from a row of type In while staging,
// and its exact widening to the f32 vector it stores
template <typename In, int V> struct Stage;
template <int V> struct Stage<float, V> {
  using T = typename Vec<V>::T;
  static __device__ __forceinline__ T widen(T x) { return x; }
};
template <> struct Stage<__nv_bfloat16, 1> {
  using T = unsigned short;
  static __device__ __forceinline__ float widen(T x) {
    return __uint_as_float((unsigned)x << 16);
  }
};
template <> struct Stage<__nv_bfloat16, 4> {
  using T = uint2;
  static __device__ __forceinline__ float4 widen(T x) {
    return make_float4(__uint_as_float(x.x << 16),
                       __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16),
                       __uint_as_float(x.y & 0xffff0000u));
  }
};

// a dot stored in the input's type, rounded once
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void fma_v(float (&acc)[1], float a, float b) {
  acc[0] = fmaf(a, b, acc[0]);
}
__device__ __forceinline__ void fma_v(float (&acc)[4], float4 a, float4 b) {
  acc[0] = fmaf(a.x, b.x, acc[0]);
  acc[1] = fmaf(a.y, b.y, acc[1]);
  acc[2] = fmaf(a.z, b.z, acc[2]);
  acc[3] = fmaf(a.w, b.w, acc[3]);
}
__device__ __forceinline__ float fold(const float (&acc)[1]) { return acc[0]; }
__device__ __forceinline__ float fold(const float (&acc)[4]) {
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// row stride in floats: V-wide units odd in number (bank-conflict-free
// float4 reads of eight rows at one column)
__host__ __device__ __forceinline__ int stride_of(int s, int v) {
  const int units = (s + v - 1) / v;
  return (units | 1) * v;
}

template <int V, typename In>
__global__ void __launch_bounds__(kThreads)
dot_interaction(const In* __restrict__ z, In* __restrict__ out, int f, int s,
                int kp_log2) {
  using VT = typename Vec<V>::T;
  using LT = typename Stage<In, V>::T;
  extern __shared__ float4 smem4[];
  float* sz = reinterpret_cast<float*>(smem4);
  const int ld = stride_of(s, V);
  const int fp = (f + 1) & ~1;
  const int nv = s / V;
  const LT* src = reinterpret_cast<const LT*>(z + (int64_t)blockIdx.x * f * s);
  // every load of a round is issued before the first store, so staging
  // costs one round trip per kStageUnroll x kThreads vectors
  for (int e0 = 0; e0 < f * nv; e0 += kStageUnroll * kThreads) {
    LT v[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      if (e < f * nv) v[u] = __ldg(src + e);
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int e = e0 + u * kThreads + threadIdx.x;
      const int row = e / nv;
      if (e < f * nv)
        reinterpret_cast<VT*>(sz + row * ld)[e - row * nv] =
            Stage<In, V>::widen(v[u]);
    }
  }
  if (fp > f)
    for (int c = threadIdx.x; c < s; c += kThreads) sz[f * ld + c] = 0.0f;
  __syncthreads();

  const int n_out = f * (f - 1) / 2;
  In* dst = out + (int64_t)blockIdx.x * n_out;
  const int tf = fp / 2;
  const int kp_n = 1 << kp_log2;
  const int total = tf * (tf + 1) / 2 * kp_n;
  // every thread runs every round, so the whole warp meets each shuffle
  for (int base = 0; base < total; base += kThreads) {
    const int wdx = base + threadIdx.x;
    const bool ok = wdx < total;
    const int kp = wdx & (kp_n - 1);
    int tj = ok ? wdx >> kp_log2 : 0, ti = 0;
    while (tj > ti) tj -= ++ti;
    const VT* a0 = reinterpret_cast<const VT*>(sz + 2 * ti * ld);
    const VT* a1 = reinterpret_cast<const VT*>(sz + (2 * ti + 1) * ld);
    const VT* b0 = reinterpret_cast<const VT*>(sz + 2 * tj * ld);
    const VT* b1 = reinterpret_cast<const VT*>(sz + (2 * tj + 1) * ld);
    float acc[2][2][V];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[p][q][v] = 0.0f;
    if (ok) {
#pragma unroll 4
      for (int v = kp; v < nv; v += kp_n) {
        const VT x0 = a0[v], x1 = a1[v], y0 = b0[v], y1 = b1[v];
        fma_v(acc[0][0], x0, y0);
        fma_v(acc[0][1], x0, y1);
        fma_v(acc[1][0], x1, y0);
        fma_v(acc[1][1], x1, y1);
      }
    }
    float dot[2][2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        dot[p][q] = fold(acc[p][q]);
        for (int off = 1; off < kp_n; off <<= 1)
          dot[p][q] += __shfl_xor_sync(0xffffffffu, dot[p][q], off);
      }
    if (ok && kp == 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 2 * ti + p, j = 2 * tj + q;
          if (i > j && i < f) store(dst + i * (i - 1) / 2 + j, dot[p][q]);
        }
    }
  }
}

__global__ void dot_interaction_empty_kernel() {}

// log2 of KP: the most threads per tile (a power of two, at most one per
// V-wide column) with every tile in one round of the block
int kparts_log2(int f, int s, int v) {
  const int fp = (f + 1) & ~1;
  const int tiles = fp / 2 * (fp / 2 + 1) / 2;
  int kp_log2 = 0;
  while ((tiles << (kp_log2 + 1)) <= kThreads && (2 << kp_log2) <= s / v &&
         kp_log2 < 5)
    ++kp_log2;
  return kp_log2;
}

template <int V, typename In>
int launch(const In* z, In* out, int batch, int f, int s, cudaStream_t st) {
  const int fp = (f + 1) & ~1;
  const size_t smem = (size_t)fp * stride_of(s, V) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        dot_interaction<V, In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dot_interaction<V, In><<<batch, kThreads, smem, st>>>(
      z, out, f, s, kparts_log2(f, s, V));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dot_interaction_f32_launch(const void* z, void* out, int batch,
                                          int f, int s, void* stream) {
  const float* zz = static_cast<const float*>(z);
  float* oo = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0)
    return launch<4>(zz, oo, batch, f, s, st);
  return launch<1>(zz, oo, batch, f, s, st);
}

// bf16 features and output, f32 products and sums (the same schedule and
// KP as the f32 entry point)
extern "C" int dot_interaction_bf16_launch(const void* z, void* out,
                                           int batch, int f, int s,
                                           void* stream) {
  const __nv_bfloat16* zz = static_cast<const __nv_bfloat16*>(z);
  __nv_bfloat16* oo = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 8 == 0)
    return launch<4>(zz, oo, batch, f, s, st);
  return launch<1>(zz, oo, batch, f, s, st);
}

// KP of the float4 schedule (S a multiple of 4, z 16-byte aligned): the
// ``kparts`` of kernels/ref.py::dot_interaction_split_ref
extern "C" int dot_interaction_kparts(int f, int s) {
  return 1 << kparts_log2(f, s, 4);
}

// the launch-and-ramp floor: an empty kernel on ``blocks`` x 256 threads
extern "C" int dot_interaction_empty(int blocks, void* stream) {
  dot_interaction_empty_kernel<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
