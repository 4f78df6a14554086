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
// where t(n) is clamp(tid[n], 0, T-1) (rows form) or n % T (stacked form,
// n = b*T + t).
//
// What bounds it on the H100: L2 and the latency of dependent loads.  Each
// slot reads one s-wide row from a random place in a multi-GB table (256 B
// at s = 64 f32) plus 8 B of id and weight, and does one multiply-add per
// element read.  The served microbatch (128 x 26 bags, 100 slots each)
// names ~136k distinct rows (35 MB from device memory) in 333k slots, whose
// 85 MB all pass through L2; a bag's slots are a chain of id load -> row
// load -> add.  So the kernel needs many rows in flight, no id load in
// front of a row load, and few instructions per slot.
//
// Design.
//  * A group of L lanes reads one row: V-wide vector loads (float4 where s is
//    a multiple of 4), L = the largest power of two <= min(32, s / V).  At
//    s = 64 that is 16 lanes x float4, so a warp reads two slots per
//    instruction.
//  * A block (128 threads) first stages the (id clamped to [0, R-1],
//    weight) pairs of its bags in shared memory, all loads of a thread
//    issued before its first store (one round trip).  A group then walks
//    its slots in batches of 8: the batch's pairs from shared memory, then
//    all its row loads back to back with no branch between them (a slot
//    past the end repeats the last one and is not added); the next batch
//    is issued before the current one is added, so 16 rows are in flight
//    per group.  __launch_bounds__ holds the registers to 4 resident
//    blocks.  One-slot bags (hot 1) take a kernel with no staging and no
//    batch.
//  * Stacked form: table-major.  A block pools bags of ONE table (table t,
//    a run of samples b), so a small table's rows are reused from L1 across
//    the block's bags.  The rows form and the single-table form have no
//    static table order and keep the bag order.
//  * A bag of more than 128 slots, or a call with too few bags to give
//    every SM a block (the single-table form of one batch), is split over
//    G groups (a power of two): group k takes slots k, k+G, ...
//    in order, and the G partial sums meet in shared memory, added in the
//    fixed order 0, 1, ..., G-1.  Either way two runs give the same bits,
//    with no atomics.
//  * Products are rounded before they are added (__fmul_rn, no FMA), as the
//    plain version's rows * mask; every slot is read, zero-weight ones
//    included, so a NaN row times weight 0 stays NaN as in the reference.
//    Row offsets are 64-bit: a Kaggle-width stack holds 1.8e9 elements.
//    kernels/ref.py::embedding_bag_split_ref is the CPU model of this
//    summation order (bit-exact to it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// row loads a group issues together
constexpr int kUnroll = 8;
// resident blocks the register budget must allow
constexpr int kMinBlocks = 4;
// most slots one group walks before the bag is split (a hot-100 bag is
// one group's)
constexpr int kGroupSlots = 128;
// shared memory for the G > 1 partial sums: (kThreads / L) x s floats
constexpr int kPartialBytes = 32 * 1024;
// shared memory for one chunk of the block's ids and weights, and the
// loads of it one thread issues together
constexpr int kIdBytes = 16 * 1024;
constexpr int kStageUnroll = 8;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void add_scaled(float (&acc)[1], float w, float v) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(w, v));
}
__device__ __forceinline__ void add_scaled(float (&acc)[2], float w, float2 v) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(w, v.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(w, v.y));
}
__device__ __forceinline__ void add_scaled(float (&acc)[4], float w, float4 v) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(w, v.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(w, v.y));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(w, v.z));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(w, v.w));
}

struct Args {
  const float* table;
  const int32_t* idx;
  const float* w;
  const int32_t* tid;   // nullptr: table n % n_tables
  float* out;
  int64_t n_bags, rows;
  int hot, s, n_tables;
  int lanes_log2;       // L = 1 << lanes_log2 lanes read one row
  int groups;           // G groups pool one bag
  int chunk_log2;       // slots of each bag whose ids are staged at a time
  int table_major;      // block = (table, run of samples)
};

// One batch of a group's slots: the row loads of its slots j0 .. j0+U-1,
// (row, weight) pairs read from shared memory first, then every row load
// issued back to back with no branch between them.  A slot past the group's
// last (j >= n_mine) repeats the last slot read, whose row is in flight or
// just landed; the adds skip it.
template <int V, int U>
__device__ __forceinline__ void fetch(typename Vec<V>::T (&x)[U],
                                      float (&wt)[U], const int2* slots,
                                      int j0, int n_mine, int step,
                                      const float* base, int s, int c) {
  using VT = typename Vec<V>::T;
  int r[U];
  const int tail = min(j0, max(n_mine - 1, 0));
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int2 e = slots[(j0 + u < n_mine ? j0 + u : tail) * step];
    r[u] = e.x;
    wt[u] = __int_as_float(e.y);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float* p = base + (int64_t)r[u] * s + c;
    x[u] = __ldg(reinterpret_cast<const VT*>(p));
  }
}

template <int V, int U>
__global__ void __launch_bounds__(kThreads, U == 1 ? 4 : kMinBlocks)
bag_pool_f32(const Args a) {
  using VT = typename Vec<V>::T;
  extern __shared__ float4 smem4[];
  const int lanes = 1 << a.lanes_log2;
  const int n_groups = kThreads >> a.lanes_log2;
  const int per_block = n_groups / a.groups;
  const int chunk = 1 << a.chunk_log2;
  const int id_ld = chunk + 1;        // padded: two bags' slots, two banks
  float* part = reinterpret_cast<float*>(smem4);
  // the staged (clamped row, weight bits) of each of the block's slots
  int2* slots = reinterpret_cast<int2*>(
      part + (a.groups > 1 ? n_groups * a.s : 0));
  const int gi = threadIdx.x >> a.lanes_log2;
  const int li = threadIdx.x & (lanes - 1);
  const int slot = gi / a.groups;             // the group's bag in the block
  const int k = gi - slot * a.groups;         // its split of that bag

  // the block's bags: (table t, samples b0 ..) or bags n0 ..
  int64_t first, stride, count;
  int t;
  if (a.table_major) {
    const int64_t samples = a.n_bags / a.n_tables;
    t = (int)(blockIdx.x % a.n_tables);
    const int64_t b0 = (int64_t)(blockIdx.x / a.n_tables) * per_block;
    first = b0 * a.n_tables + t;
    stride = a.n_tables;
    count = min((int64_t)per_block, samples - b0);
  } else {
    first = (int64_t)blockIdx.x * per_block;
    stride = 1;
    count = min((int64_t)per_block, a.n_bags - first);
    t = 0;
  }
  const bool valid = slot < count;
  const int64_t bag = first + slot * stride;
  if (!a.table_major && valid) {
    t = a.tid != nullptr ? min(max(__ldg(a.tid + bag), 0), a.n_tables - 1)
                         : (int)(bag % a.n_tables);
  }
  const float* base = a.table + (int64_t)t * a.rows * a.s;
  // ids are int32, so clamping to min(rows - 1, INT_MAX) loses nothing
  const int last = (int)min(a.rows - 1, (int64_t)0x7fffffff);
  if constexpr (U == 1) {
    // one-slot bags (G = 1): the id straight from device memory, no staging
    if (!valid) return;
    for (int c = li * V; c < a.s; c += lanes * V) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      if (a.hot == 1) {
        const int r = min(max(__ldg(a.idx + bag), 0), last);
        add_scaled(acc, __ldg(a.w + bag),
                   __ldg(reinterpret_cast<const VT*>(base + (int64_t)r * a.s +
                                                     c)));
      }
      float* o = a.out + bag * a.s + c;
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = acc[v];
    }
    return;
  }
  const int2* mine = slots + slot * id_ld + k;
  for (int c0 = 0; c0 < a.s; c0 += lanes * V) {
    const int c = c0 + li * V;
    const bool active = valid && c < a.s;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int h0 = 0; h0 < a.hot; h0 += chunk) {
      // the block's ids (clamped here, once per slot) and weights of slots
      // h0 .. h0+chunk-1, coalesced; kStageUnroll loads per thread are
      // issued before the first store, so the chunk costs one round trip
      __syncthreads();
      for (int e0 = 0; e0 < per_block * chunk; e0 += kStageUnroll * kThreads) {
        int32_t iv[kStageUnroll];
        float wv[kStageUnroll];
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {
          const int e = e0 + u * kThreads + threadIdx.x;
          const int sl = e >> a.chunk_log2;
          const int h = h0 + (e & (chunk - 1));
          if (sl < count && h < a.hot) {
            const int64_t at = (first + sl * stride) * a.hot + h;
            iv[u] = __ldg(a.idx + at);
            wv[u] = __ldg(a.w + at);
          }
        }
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {
          const int e = e0 + u * kThreads + threadIdx.x;
          const int sl = e >> a.chunk_log2;
          if (sl < count && h0 + (e & (chunk - 1)) < a.hot)
            slots[sl * id_ld + (e & (chunk - 1))] =
                make_int2(min(max(iv[u], 0), last), __float_as_int(wv[u]));
        }
      }
      __syncthreads();
      if (!active) continue;
      // this group's slots of the chunk: h0 + k, h0 + k + G, ...
      const int left = min(chunk, a.hot - h0) - k;
      const int n_mine = left > 0 ? (left + a.groups - 1) / a.groups : 0;
      VT xa[U];
      float wa[U];
      // the next batch's rows load while this batch is added
      fetch<V, U>(xa, wa, mine, 0, n_mine, a.groups, base, a.s, c);
      for (int j0 = 0; j0 < n_mine; j0 += U) {
        VT xb[U];
        float wb[U];
        fetch<V, U>(xb, wb, mine, j0 + U, n_mine, a.groups, base, a.s, c);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u < n_mine) add_scaled(acc, wa[u], xa[u]);
          xa[u] = xb[u];
          wa[u] = wb[u];
        }
      }
    }
    if (a.groups == 1) {
      if (active) {
        float* o = a.out + bag * a.s + c;
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = acc[v];
      }
    } else if (c < a.s) {
      float* p = part + gi * a.s + c;
#pragma unroll
      for (int v = 0; v < V; ++v) p[v] = acc[v];
    }
  }
  if (a.groups == 1) return;
  __syncthreads();
  // the bag's G partial sums, added in split order
  for (int e = threadIdx.x; e < count * a.s; e += kThreads) {
    const int sl = e / a.s;
    const int c = e - sl * a.s;
    const float* p = part + sl * a.groups * a.s + c;
    float sum = p[0];
    for (int g = 1; g < a.groups; ++g) sum = __fadd_rn(sum, p[g * a.s]);
    a.out[(first + sl * stride) * a.s + c] = sum;
  }
}

int pow2_floor(int64_t x) {
  int p = 1;
  while ((int64_t)p * 2 <= x) p *= 2;
  return p;
}

int pow2_ceil(int64_t x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// The launch plan: lanes per row, groups per bag, the id chunk, grid and
// shared memory.  G (a power of two, within the block's groups) is the
// least that leaves each group at most kGroupSlots slots; while the grid
// has fewer blocks than the card has SMs (few bags: the single-table form
// of a batch), G doubles as long as each group keeps kUnroll slots.
// G > 1 needs the partial sums to fit kPartialBytes.  The chunk is the most
// slots of each of the block's bags whose ids and weights fit kIdBytes (a
// power of two, at least G, at most the bag's slots rounded up).
struct Plan {
  int64_t blocks;
  size_t smem;
};

// The SM count of the card current at the first call, read once: it shapes
// the grid, and the groups per bag of a call with few bags, so every call
// of a process plans alike.
int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev, n, err;
    if ((err = (int)cudaGetDevice(&dev))) return err;
    if ((err = (int)cudaDeviceGetAttribute(
             &n, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    cached = n;
  }
  *sms = cached;
  return 0;
}

template <int V>
int plan(Args* a, Plan* p) {
  int sms;
  const int err = sm_count(&sms);
  if (err) return err;
  const int nvec = (a->s + V - 1) / V;
  const int lanes = pow2_floor(nvec < 32 ? nvec : 32);
  a->lanes_log2 = __builtin_ctz(lanes);
  const int n_groups = kThreads / lanes;
  const int64_t part_bytes = (int64_t)n_groups * a->s * 4;
  a->table_major = a->tid == nullptr && a->n_tables > 1;
  auto blocks = [&](int g) {
    const int64_t per_block = n_groups / g;
    return a->table_major
               ? a->n_tables * ((a->n_bags / a->n_tables + per_block - 1) /
                                per_block)
               : (a->n_bags + per_block - 1) / per_block;
  };
  int g = 1;
  while (g < n_groups && (int64_t)g * kGroupSlots < a->hot) g *= 2;
  while (2 * g <= n_groups && (int64_t)2 * g * kUnroll <= a->hot &&
         blocks(g) < sms)
    g *= 2;
  if (part_bytes > kPartialBytes) g = 1;
  a->groups = g;
  const int per_block = n_groups / g;
  int chunk = pow2_floor(kIdBytes / (per_block * 8));
  const int need = pow2_ceil(a->hot);
  if (chunk > need) chunk = need;
  if (chunk < g) chunk = g;
  a->chunk_log2 = __builtin_ctz(chunk);
  p->blocks = blocks(g);
  p->smem = (size_t)((g > 1 ? part_bytes : 0) +
                     (int64_t)per_block * (chunk + 1) * 8);
  return 0;
}

template <int V, int U>
int launch_with(const Args& a, const Plan& p, cudaStream_t st) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bag_pool_f32<V, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (err != cudaSuccess) return (int)err;
  }
  bag_pool_f32<V, U><<<(unsigned)p.blocks, kThreads, p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

// one-slot bags (the hot-1 traffic) take U = 1: their id comes straight
// from device memory, and the registers a batch of rows would hold buy
// resident blocks instead
template <int V>
int launch(Args a, cudaStream_t st) {
  Plan p;
  const int err = plan<V>(&a, &p);
  if (err) return err;
  return a.hot <= 1 ? launch_with<V, 1>(a, p, st)
                    : launch_with<V, kUnroll>(a, p, st);
}

Args make_args(const void* table, const void* idx, const void* w,
               const void* tid, void* out, int64_t n_bags, int hot, int s,
               int64_t rows, int n_tables) {
  Args a;
  a.table = static_cast<const float*>(table);
  a.idx = static_cast<const int32_t*>(idx);
  a.w = static_cast<const float*>(w);
  a.tid = static_cast<const int32_t*>(tid);
  a.out = static_cast<float*>(out);
  a.n_bags = n_bags;
  a.rows = rows;
  a.hot = hot;
  a.s = s;
  a.n_tables = n_tables;
  a.lanes_log2 = a.groups = a.chunk_log2 = a.table_major = 0;
  return a;
}

}  // namespace

extern "C" int embedding_bag_pool_f32(const void* table, const void* idx,
                                      const void* w, const void* tid,
                                      void* out, int64_t n_bags, int hot,
                                      int s, int64_t rows, int n_tables,
                                      void* stream) {
  const Args a = make_args(table, idx, w, tid, out, n_bags, hot, s, rows,
                           n_tables);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s % 4 == 0) return launch<4>(a, st);
  if (s % 2 == 0) return launch<2>(a, st);
  return launch<1>(a, st);
}

// The plan a call with these shapes would launch (tid_given: the rows
// form): out[0] lanes per row, out[1] groups per bag, out[2] table-major,
// out[3] blocks, out[4] bytes of dynamic shared memory.
extern "C" int embedding_bag_plan(int64_t n_bags, int hot, int s,
                                  int n_tables, int tid_given,
                                  int64_t* out) {
  static const int32_t some_tid = 0;
  Args a = make_args(nullptr, nullptr, nullptr,
                     tid_given ? &some_tid : nullptr, nullptr, n_bags, hot,
                     s, 1, n_tables);
  Plan p;
  const int err = s % 4 == 0   ? plan<4>(&a, &p)
                  : s % 2 == 0 ? plan<2>(&a, &p)
                               : plan<1>(&a, &p);
  if (err) return err;
  out[0] = 1 << a.lanes_log2;
  out[1] = a.groups;
  out[2] = a.table_major;
  out[3] = p.blocks;
  out[4] = (int64_t)p.smem;
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
