// A measurement aid of ab_dlrm_kernels.py, not on any path of the port:
// each thread reads its float4s of ``buf`` through L2 (ld.global.cg skips
// L1) ``passes`` times, so a run can time the card's L2 read rate on a
// buffer that L2 holds, and its device-memory read rate on one that it does
// not.  The sum is written only if it equals a value a zero buffer never
// gives, which keeps the loads live.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
l2_read_probe_kernel(const float4* __restrict__ buf, int64_t n_vec,
                     int passes, float* __restrict__ sink) {
  float acc = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int p = 0; p < passes; ++p) {
#pragma unroll 4
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_vec;
         i += stride) {
      const float4 v = __ldcg(buf + i);
      acc += (v.x + v.y) + (v.z + v.w);
    }
  }
  if (acc == 1234.5f) sink[0] = acc;
}

}  // namespace

extern "C" int l2_read_probe(const void* buf, int64_t n_vec, int passes,
                             void* sink, int blocks, void* stream) {
  l2_read_probe_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(buf), n_vec, passes,
      static_cast<float*>(sink));
  return (int)cudaGetLastError();
}
