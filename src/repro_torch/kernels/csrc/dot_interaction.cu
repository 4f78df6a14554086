// DLRM pairwise dot interaction, written by hand for Hopper (sm_90a).
//
// Replaces B3, the Pallas kernel _kernel (:24) of
// src/repro/kernels/dot_interaction.py (pallas_call at :52): for each sample
// the strict lower triangle of Z Z^T, with Z its (F, S) feature block, in
// np.tril_indices(F, -1) row-major order — pair (i, j), i > j, lands at
// output index i(i-1)/2 + j.
//
// What bounds it on the H100: bytes, and at serving sizes launch overhead.
// A (512, 27, 64) f32 input is 3.5 MB and the (512, 351) output 0.7 MB,
// about 1.3 us at 3.35 TB/s; the 23 MFLOP of dots are ~0.3 us of the f32
// pipes.  The TPU kernel spent two MXU matmuls (the Gram matrix, then a
// one-hot selection) to keep the F x F Gram matrix out of HBM.
//
// Design.  One block owns one sample and stages its features in shared
// memory (27 x 65 x 4 B = 7 KB; rows padded to S + 1 floats so the threads
// of a warp, which read different rows j at the same column, hit different
// banks).  Its threads then take the pairs the output keeps, dot over S in
// order with f32 accumulation, and write coalesced.  The Gram matrix is
// never formed.  A batch of 512 gives 512 small blocks, several per SM, so
// the staging loads of one block overlap the dots of another.  A feature
// block over the 48 KB default opts into up to 227 KB of dynamic shared
// memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
dot_interaction_f32(const float* __restrict__ z, float* __restrict__ out,
                    int f, int s) {
  extern __shared__ float sz[];
  const int ld = s + 1;
  const int n_out = f * (f - 1) / 2;
  const float* src = z + (int64_t)blockIdx.x * f * s;
  for (int e = threadIdx.x; e < f * s; e += blockDim.x) {
    const int row = e / s;
    sz[row * ld + (e - row * s)] = src[e];
  }
  __syncthreads();
  float* dst = out + (int64_t)blockIdx.x * n_out;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    int i = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)o)) * 0.5f);
    while (i * (i - 1) / 2 > o) --i;
    while ((i + 1) * i / 2 <= o) ++i;
    const int j = o - i * (i - 1) / 2;
    const float* zi = sz + i * ld;
    const float* zj = sz + j * ld;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < s; ++k) acc = fmaf(zi[k], zj[k], acc);
    dst[o] = acc;
  }
}

}  // namespace

extern "C" int dot_interaction_f32_launch(const void* z, void* out, int batch,
                                          int f, int s, void* stream) {
  const size_t smem = (size_t)f * (s + 1) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        dot_interaction_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dot_interaction_f32<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<float*>(out), f, s);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
