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
// Three bodies, by type and head dim, all on the tensor cores.  The two
// 16-bit bodies are templated on their input type T, bfloat16 or float16:
// wgmma takes both in the same shapes at the same rate, accumulating in
// f32, so a body's f16 instantiation differs from its bf16 one only in the
// PTX type of its products, the type P is rounded to for P V, the tensor
// maps' element type and the output's rounding.  Scores,
// the running max, sum and lse stay f32 in both (P <= 1 and |out| <= max
// |v|: nothing overflows f16's range).
//   - 16-bit at head dims 128 and 256 (the dense, MoE and VLM shapes),
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
//     goes to T in registers as the A operand of O += P V, a wgmma
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
//   - 16-bit at head dims 64, 80 and 96 (granite-moe's and whisper-tiny's
//     64, zamba2-2.7b's shared block at 80, phi-3-mini's 96),
//     flash_wgmma_ws: the same tiles (128 queries, two consumer
//     warpgroups, K/V tiles of 128 keys, S = Q K^T in m64n128k16 steps,
//     S_{i+1} issued with O += P_i V_i; at hd 96 tiles of 112 keys, so the
//     larger output fits the registers) with three changes.  What bounds
//     it: an admitted pair costs 4 hd flops (256 at hd 64) of the tensor
//     cores' 4,096 a clock per SM, and one exponential of the SFU's 16 a
//     clock, so at hd 64 the exponentials take as long as the products (at
//     hd 80 four fifths, at hd 96 two thirds) and a body that runs them one
//     after the other cannot pass half the flop bound.  (1) The warpgroups
//     take turns on two named barriers (WsTile::kTurns, at these head dims
//     only): each waits for its turn, issues its products and hands the
//     turn over, so one warpgroup's softmax can run while the other's
//     products are on the tensor cores (tools/ab_flash.py times it against
//     free issue: about even so far; the softmax alone takes most of the
//     time).  (2) Registers are no longer scarce (S 64
//     floats, O 32 to 48, P 32; 168 a thread with nine warps), so a
//     producer warp of its own keeps the ring full (6 stages of 32 KB at
//     hd 64, 5 of 40 KB at hd 80, 4 of 42 KB at hd 96); with thread 0 as
//     the producer it was slower at every shape timed.  (3) Rows of 160 bytes (hd 80) or 192 (hd 96) fit no
//     swizzle atom: each Q, K, V and output tile is two TMA boxes, columns
//     0-63 128-byte swizzled and the rest, 16 columns 32-byte swizzled at
//     hd 80 or 32 columns 64-byte swizzled at hd 96, so S takes one or two
//     more k-steps from the second box and O += P V is a pair, m64n64k16
//     plus m64n16k16 or m64n32k16 (accumulators 32 + 8 or 32 + 16 floats).
//     Padding to 128 would cost 1.6x (hd 80) or 1.33x (hd 96) the tensor
//     work and a padded copy of q, k and v.  The last tile issues O += P V
//     in a step of its own, a warp whose rows kept their max skips the
//     output's rescale (exactly 1), whether a softcap applies is a
//     template argument (kCap), and the grid runs (batch, head) pairs in
//     groups of 8, heaviest tile first within a group, so a wave reads the
//     K/V of few heads.  Each warpgroup stores its own 64 output rows.
//   - 16-bit at head dims 16 and 32 (no served model; the smoke configs'
//     8 in bf16 or f16, padded to 16), the same flash_wgmma_ws at narrow
//     rows.  It replaces flash_bf16, an mma.sync body (64 queries
//     over 32-key tiles, each with two __syncthreads, a cp.async wait and
//     Q's fragments reloaded by ldmatrix, the softcap tested and the scale
//     multiplied on every score), which ran 1.46x (hd 16) and 1.81x (hd
//     32) scaled_dot_product_attention's time at B 4, S 1024, H 8 over Kh
//     2: there the time is the longest block's chain of 32 short tiles,
//     not the launch.  What bounds a body here: an admitted pair costs 4
//     hd flops (64 at hd 16, 128 at hd 32) of the tensor cores' ~4,096 a
//     clock per SM, and one exponential of the SFU's 16, so the
//     exponentials take 2x (hd 32) to 4x (hd 16) as long as the products
//     and set the floor: the 16.8 M admitted pairs of that shape take
//     ~4-4.5 us of the SFU (132 SMs at 1.755-1.98 GHz), the 680 M of B 2,
//     S 4608, H 32 ~0.16-0.18 ms.  What the design does: the products,
//     the loads and the other warpgroup's softmax run beside the
//     exponentials.  A row of 32 or 64 bytes is one TMA box, 32- or
//     64-byte swizzled, with no 128-byte box: S = Q K^T is one k-step from
//     it (hd 16, sw32_desc) or two (hd 32, sw64_desc), and O += P V one
//     m64n16k16 or m64n32k16 a 16-key step (8 or 16 accumulators).  Tiles
//     of 64 keys in a fixed ring of 4 stages, two blocks an SM (at most
//     112 registers a thread: scores 32, P 16, output 16; ptxas takes
//     93-96), and the warpgroups issue freely, without turns.  Measured
//     (tools/ab_flash.py --narrow, H100 SXM at 700 W): at B 4, S 1024
//     every tiling tried ran 0.0240-0.0266 ms (a wave's longest chain of
//     tiles, not throughput; 128-key tiles at one block an SM within 3%);
//     at B 2, S 4608, H 32 over Kh 8 this one ran 0.368 ms (hd 32) and
//     0.333 (hd 16) against 0.409 and 0.359 for one block an SM over
//     128-key tiles, 0.404 and 0.369 with every stage that fits (13 at hd
//     32), 2 or 8 stages within 2.5%, and turns 0-6% slower.  Nor does
//     the SFU bound it yet: with no exponential at all the hd 32 row ran
//     0.334 ms, with no softmax 0.181, and taking a quarter (an eighth) of
//     the exponentials on the FMA pipe (2^floor(x) times a cubic) ran 19%
//     (11%) slower, so the softmax's other instructions (scale, max, sum,
//     packing P) set the time.
//   - float32 at every head dim, flash_3xtf32: the tensor cores in TF32
//     (495 TFLOP/s dense against 67 on the CUDA cores), each f32 product
//     taken as three.  An operand x is split into big = tf32(x) and small =
//     x - big, which the tensor cores read to TF32 by truncation, and a . b
//     = big.big + big.small + small.big leaves about 2^-21 of each product:
//     within a few f32 ulps, where one TF32 product keeps about three
//     decimal digits.  mma.sync m16n8k8 (TF32 wgmma takes only K-major
//     operands from shared memory, and V is MN-major for P V): four warps
//     of 16 query rows over K and V tiles brought by cp.async into two
//     stages, each warp splitting the fragments it loads.  The K
//     fragment's columns take the keys of each 8-key group in the order 0,
//     4, 1, 5, 2, 6, 3, 7, so a thread's score accumulators are its P
//     fragment for P V with no shuffle.  The tensor cores sum in f32 but
//     truncate, so no accumulator lives long on them: each two 8-deep steps
//     of Q K^T (one at hd 256) and each output tile's P V over one key tile
//     are summed from zero and added on the CUDA cores.  Scores, max, sum
//     and output stay f32; the softcap runs on tanhf (tanh.approx keeps 11
//     bits), the exponentials on exp2 with the scale folded in when
//     uncapped.  What bounds it: mma.sync's TF32 rate (on an H100 with the
//     splits removed the body still took 0.30 of its 0.37 ms at zamba2's
//     f32 row, tools/ab_flash.py --f32), not the tensor cores' peak.
//   - past hd 256 (no served model; the reference kernel takes any hd),
//     flash_wgmma_wide in bf16/f16 and flash_3xtf32_wide in f32: neither
//     Q's rows nor a K tile fits at the whole depth beside a K/V ring (at
//     hd 512 Q's 128 rows alone are 128 KB), nor a warpgroup's m64n{hd}
//     output in 255 registers, so Q K^T streams the depth in 64-column
//     boxes and the output's columns are cut into slices, one a block (256
//     in 16-bit, 192 in f32), each slice recomputing S: Q K^T costs
//     ceil(hd / slice) times its flops.  See the bodies' notes below.
// Other head dims up to 256 reach a built one zero-padded by the caller
// (the zero columns add nothing to q . k, and the scale is the true hd's);
// past 256 the bodies read any multiple of 8 and zero-fill the rest.
// Masked scores take the finite sentinel -1e30, as the Pallas kernel does,
// and their probability is 0 by the admitted test, so a row whose first
// live tile admits none of its keys never forms exp(-inf + inf).  No
// atomics: two runs give the same bits.  Any S >= 1: ragged tiles are
// zero-filled and masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
  int hd;      // the rows' width in memory (the bodies past 256 read it)
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
// helpers: shared memory, cp.async, the 16-bit types' asm
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

// The 16-bit input types of the tensor-core bodies.  Their products'
// PTX strings differ only in the type, so each wrapper below is one asm
// statement written as a macro of the type's name, issued for T by
// TYPED_ASM: ".bf16.bf16" or ".f16.f16", accumulating in f32 either way.
template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

#define TYPED_ASM(T, ASM)  \
  if constexpr (kHalf<T>) { \
    ASM(".f16.f16");        \
  } else {                  \
    ASM(".bf16.bf16");      \
  }

// two floats rounded to T, packed as one 32-bit register (lo first)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// 16-bit at head dims 128 and 256: wgmma fed by TMA (the helpers below
// serve the hd 16-96 body too)
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

// The descriptor of an operand stored as 32-byte rows (16 16-bit columns)
// with the 32-byte swizzle, its 8-row groups 256 bytes apart: K-major, one
// 16-element k-step is a whole row; MN-major, 16 columns are the whole N
// extent, so the leading byte offset is unused either way.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

// The same for 64-byte rows (32 16-bit columns) with the 64-byte swizzle,
// 8-row groups 512 bytes apart: K-major, the two k-steps of a row start 0
// and 32 bytes in; MN-major, 32 columns are the whole N extent.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
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
// K-major), T in: scale_d 0 overwrites d, 1 accumulates
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
#define WGMMA_SS_N64(AB) \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" AB " {"                             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                                       \
      : "l"(da), "l"(db), "r"(scale_d))
  TYPED_ASM(T, WGMMA_SS_N64)
#undef WGMMA_SS_N64
}

// d (64 x 112, f32) {=, +=} a (64 x 16, smem, K-major) b (16 x 112, smem,
// K-major), T in: scale_d 0 overwrites d, 1 accumulates
template <typename T>
__device__ __forceinline__ void wgmma_ss_n112(float (&d)[56], uint64_t da,
                                              uint64_t db, int scale_d) {
#define WGMMA_SS_N112(AB) \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n112k16.f32" AB " {"                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55"                                           \
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"                                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),          \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),        \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),    \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),    \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),    \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),    \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),    \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),    \
        "+f"(d[54]), "+f"(d[55])                                                         \
      : "l"(da), "l"(db), "r"(scale_d))
  TYPED_ASM(T, WGMMA_SS_N112)
#undef WGMMA_SS_N112
}

// d (64 x 128, f32) {=, +=} a (64 x 16, smem, K-major) b (16 x 128, smem,
// K-major), T in: scale_d 0 overwrites d, 1 accumulates
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
#define WGMMA_SS_N128(AB) \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" AB " {"                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"   \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),          \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),        \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),    \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),    \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),    \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),    \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),    \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),    \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                               \
      : "l"(da), "l"(db), "r"(scale_d))
  TYPED_ASM(T, WGMMA_SS_N128)
#undef WGMMA_SS_N128
}

// d (64 x 256, f32) += a (64 x 16, registers) b (16 x 256, smem, MN-major),
// T in
template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
#define WGMMA_RS_N256(AB) \
  asm volatile(                                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                                    \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32" AB " {"                                            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "               \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "               \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "               \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "               \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "               \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "   \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),                        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),                  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),                  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),                  \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),                  \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),                  \
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),                  \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),                  \
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),                  \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),                  \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),                  \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),                \
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),            \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),            \
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),            \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),            \
        "+f"(d[126]), "+f"(d[127])                                                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  TYPED_ASM(T, WGMMA_RS_N256)
#undef WGMMA_RS_N256
}

// d (64 x 128, f32) += a (64 x 16, registers) b (16 x 128, smem, MN-major),
// T in
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
#define WGMMA_RS_N128(AB) \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" AB " {"                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"   \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),          \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),        \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),    \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),    \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),    \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),    \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),    \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),    \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  TYPED_ASM(T, WGMMA_RS_N128)
#undef WGMMA_RS_N128
}

// d (64 x 64, f32) += a (64 x 16, registers) b (16 x 64, smem, MN-major),
// T in
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
#define WGMMA_RS_N64(AB) \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" AB " {"                             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  TYPED_ASM(T, WGMMA_RS_N64)
#undef WGMMA_RS_N64
}

// d (64 x 32, f32) += a (64 x 16, registers) b (16 x 32, smem, MN-major),
// T in
template <typename T>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
#define WGMMA_RS_N32(AB) \
  asm volatile(                                                                   \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32" AB " {"                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"      \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  TYPED_ASM(T, WGMMA_RS_N32)
#undef WGMMA_RS_N32
}

// d (64 x 16, f32) += a (64 x 16, registers) b (16 x 16, smem, MN-major),
// T in
template <typename T>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
#define WGMMA_RS_N16(AB) \
  asm volatile(                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32" AB " {"                      \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                          \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7])                                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  TYPED_ASM(T, WGMMA_RS_N16)
#undef WGMMA_RS_N16
}

template <int BK, typename T>
__device__ __forceinline__ void wgmma_scores(float (&d)[BK / 2], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (BK == 64) {
    wgmma_ss_n64<T>(d, da, db, scale_d);
  } else if constexpr (BK == 112) {
    wgmma_ss_n112<T>(d, da, db, scale_d);
  } else {
    wgmma_ss_n128<T>(d, da, db, scale_d);
  }
}

template <int HD, typename T>
__device__ __forceinline__ void wgmma_values(float (&d)[HD / 2],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (HD == 256) {
    wgmma_rs_n256<T>(d, a, db);
  } else {
    wgmma_rs_n128<T>(d, a, db);
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

// T: the type of q, k, v and out (__nv_bfloat16 or __half)
template <int HD, typename T>
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
      wgmma_scores<BK, T>(sc,
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
      wgmma_values<HD, T>(acc, pa[kk],
                          sw128_desc(vs + kk * 16 * 128, Tile::kKBox));
    wgmma_commit();
  };
  // P (in sc) to the A fragments in T: rows (r, r + 8) x keys 16 (n / 2) ..
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
      pa[n >> 1][(n & 1) * 2] = pack2<T>(sc[4 * n], sc[4 * n + 1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack2<T>(sc[4 * n + 2], sc[4 * n + 3]);
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
          pack2<T>(acc[4 * n + 2 * r] * l[r], acc[4 * n + 2 * r + 1] * l[r]);
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
// 16-bit at head dims 16, 32, 64, 80 and 96: wgmma fed by TMA, a producer
// warp, and two consumer warpgroups (at 64-96 taking turns on the tensor
// cores)
// ---------------------------------------------------------------------------

constexpr int kWsThreads = 288;   // two consumer warpgroups, a producer warp
constexpr int kGroup = 8;         // (batch, head) pairs a group of the grid

// 128 queries a block, 64 per consumer warpgroup; K/V tiles of 128 keys,
// 112 at hd 96.  Columns 0-63 of every tile are one box of 128-byte rows
// (128-byte swizzle); past 64 columns the rest is a second box right after
// it: at hd 80 16 columns, 32-byte rows (32-byte swizzle), at hd 96 32
// columns, 64-byte rows (64-byte swizzle): a row of 160 or 192 bytes fits
// no swizzle atom.  Nine warps leave a consumer 168 registers; at hd 96
// the output's 16 more floats put 128-key tiles 8 registers over (32
// bytes spilled and a slower body: tools/ab_flash.py's hd96_bk128 variant
// times it).  At hd 16 and 32 a row is 32 or 64 bytes, so the whole tile
// is one narrow box and there is no 128-byte one (kWide 0); tiles of 64
// keys in a fixed ring of 4 stages, two blocks an SM (kMinBlocks: 112
// registers a thread hold scores 32, P 16 and the output 16 floats), where
// filling shared memory with stages would leave one block an SM
// (tools/ab_flash.py --narrow times the other tilings).  ref.ws_block_k
// keeps the same rule for the CPU model.
template <int HD>
struct WsTile {
  static constexpr int BK = HD < 64 ? 64 : (HD == 96 ? 112 : 128);
  static constexpr int kMinBlocks = HD < 64 ? 2 : 1;   // blocks an SM
  // whether the two consumer warpgroups take turns on the tensor cores: at
  // hd 16 and 32 (two blocks an SM) free issue measured as fast or faster
  static constexpr bool kTurns = HD >= 64;
  static constexpr int kWide = HD < 64 ? 0 : 64;     // 128-byte box columns
  static constexpr int kNarrow = HD - kWide;         // columns past them
  static constexpr int kNarrowRow = kNarrow * 2;     // bytes a row of them
  // the 16-byte chunk index of the narrow box's swizzle is XORed with row
  // bits from this one up (rows of 32 bytes: bit 2; of 64: bit 1)
  static constexpr int kSwizzleShift = kNarrow == 16 ? 2 : 1;
  static constexpr int kQWide = kWgBlockQ * kWide * 2;   // bytes of Q's box
  static constexpr int kKWide = BK * kWide * 2;
  static constexpr int kQBytes = kWgBlockQ * HD * 2;
  static constexpr int kKBytes = BK * HD * 2;
  // as many K/V stages as fit beside Q, 1 KB of alignment and the barriers
  // (at hd 16 and 32 a fixed ring)
  static constexpr int kStages =
      HD < 64 ? 4 : (kMaxSmem - kQBytes - 2048) / (2 * kKBytes);
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKBytes;
  static constexpr size_t kSmemBytes = kBarOffset + 8 * (1 + 4 * kStages) +
                                       1024;
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 80 || HD == 96,
                "head dims 16, 32, 64, 80, 96");
  static_assert(kStages >= 2 && kSmemBytes * kMinBlocks <= kMaxSmem,
                "two K/V stages must fit, kMinBlocks times");
};

// kCap: 1 when a softcap applies.  Fixed per instantiation, since a test
// of it among the scores costs instructions on every one.  T: the type of
// q, k, v and out (__nv_bfloat16 or __half).
template <int HD, int kCap, typename T>
__global__ void __launch_bounds__(kWsThreads, WsTile<HD>::kMinBlocks)
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
  // which boxes a row has: 64 columns 128-byte swizzled (hd >= 64), and
  // the rest past them (hd 80, 96) or the whole row (hd 16, 32)
  constexpr bool kWideBox = Tile::kWide > 0, kNarrowBox = Tile::kNarrow > 0;
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
      if constexpr (kWideBox) tma_load(qs, &tq, qbar, 0, head, q0, batch);
      if constexpr (kNarrowBox)
        tma_load(qs + Tile::kQWide, &tq2, qbar, Tile::kWide, head, q0,
                 batch);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NST, free_parity = ((j / NST) & 1) ^ 1;
        const int k0 = lo + j * BK;
        const uint32_t ks = k_smem(st), vs = ks + Tile::kKBytes;
        mbar_wait(free_k(st), free_parity);
        mbar_expect(full_k(st), Tile::kKBytes);
        if constexpr (kWideBox)
          tma_load(ks, &tk, full_k(st), 0, kvh, k0, batch);
        if constexpr (kNarrowBox)
          tma_load(ks + Tile::kKWide, &tk2, full_k(st), Tile::kWide, kvh,
                   k0, batch);
        mbar_wait(free_v(st), free_parity);
        mbar_expect(full_v(st), Tile::kKBytes);
        if constexpr (kWideBox)
          tma_load(vs, &tv, full_v(st), 0, kvh, k0, batch);
        if constexpr (kNarrowBox)
          tma_load(vs + Tile::kKWide, &tv2, full_v(st), Tile::kWide, kvh,
                   k0, batch);
      }
    }
    return;
  }

  // The two warpgroups issue their products in turn (named barrier 1 is
  // warpgroup 0's turn, 2 warpgroup 1's): each waits for its turn, issues,
  // and hands the turn over, so one warpgroup's softmax runs while the
  // other's products are on the tensor cores.  Warpgroup 0 goes first;
  // warpgroup 1 hands no turn over after its last issue, so every wait is
  // matched by exactly one hand-over.  Without Tile::kTurns each issues
  // whenever it is ready.
  auto my_turn = [&]() {
    if constexpr (Tile::kTurns)
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto your_turn = [&]() {
    if constexpr (Tile::kTurns)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  };

  const int wq = (tid / 32) & 3;           // warp within it: 16 rows each
  const int rq = 64 * wg + 16 * wq + (lane >> 2);   // rows rq, rq + 8
  const int row0 = q0 + rq;
  const int qa = q0 + 64 * wg, qb = min(qa + 63, p.s - 1);
  const uint32_t q_rows = qs + wg * 64 * 128;
  const uint32_t q_rows2 = qs + Tile::kQWide + wg * 64 * Tile::kNarrowRow;
  // a tile whose every (row, key) pair is admitted skips the mask
  auto full_tile = [&](int k0) {
    return k0 + BK <= p.t && (!p.causal || k0 + BK - 1 <= qa) &&
           (p.window <= 0 || qb - k0 < p.window);
  };
  // S = Q K^T for the tile in stage st, both operands K-major from shared
  // memory: 4 k-steps in the wide box, then one (16 columns: hd 80 and 16)
  // or two (32 columns: hd 96 and 32) in the narrow box
  float sc[BK / 2];
  auto issue_scores = [&](int st) {
    const uint32_t ks = k_smem(st);
    if constexpr (kWideBox) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_scores<BK, T>(sc, sw128_desc(q_rows + kk * 32, 16),
                            sw128_desc(ks + kk * 32, 16), kk > 0);
    }
    if constexpr (Tile::kNarrow == 16) {
      wgmma_scores<BK, T>(sc, sw32_desc(q_rows2),
                          sw32_desc(ks + Tile::kKWide), kWideBox);
    } else if constexpr (Tile::kNarrow == 32) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_scores<BK, T>(sc, sw64_desc(q_rows2 + kk * 32),
                            sw64_desc(ks + Tile::kKWide + kk * 32),
                            kWideBox || kk > 0);
    }
    wgmma_commit();
  };
  // O += P V for the tile in stage st, P from registers, V MN-major from
  // shared memory: columns 0-63 in one product, the narrow box's in a
  // second (accumulators 32 + 8 floats at hd 80, 32 + 16 at hd 96; 8 at hd
  // 16, 16 at hd 32)
  constexpr int kAcc = kWideBox ? 32 : 1;
  constexpr int kAcc2 = kNarrowBox ? Tile::kNarrow / 2 : 1;
  uint32_t pa[BK / 16][4];
  float acc[kAcc];
  float acc2[kAcc2];
  auto issue_values = [&](int st) {
    const uint32_t vs = k_smem(st) + Tile::kKBytes;
    const uint32_t vs2 = vs + Tile::kKWide;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (kWideBox)
        wgmma_rs_n64<T>(acc, pa[kk],
                        sw128_desc(vs + kk * 16 * 128, Tile::kKWide));
      if constexpr (Tile::kNarrow == 16)
        wgmma_rs_n16<T>(acc2, pa[kk], sw32_desc(vs2 + kk * 16 * 32));
      else if constexpr (Tile::kNarrow == 32)
        wgmma_rs_n32<T>(acc2, pa[kk], sw64_desc(vs2 + kk * 16 * 64));
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
  // P (in sc) to the A fragments in T: rows (r, r + 8) x keys 16 (n / 2)
  // .. + 15; the output rescaled by corr
  auto to_values = [&]() {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      pa[n >> 1][(n & 1) * 2] = pack2<T>(sc[4 * n], sc[4 * n + 1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack2<T>(sc[4 * n + 2], sc[4 * n + 3]);
    }
    // a warp none of whose rows raised its max leaves the output as it is
    // (corr is exactly 1 then)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
      if constexpr (kWideBox) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] *= corr[(i >> 1) & 1];
      }
      if constexpr (kNarrowBox) {
#pragma unroll
        for (int i = 0; i < kAcc2; ++i) acc2[i] *= corr[(i >> 1) & 1];
      }
    }
  };

  if constexpr (kWideBox) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kAcc2; ++i) acc2[i] = 0.f;
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
    if constexpr (kWideBox) fence_regs(acc);
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
    if constexpr (kWideBox) fence_regs(acc);
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
    if constexpr (kWideBox) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t off = row * 128 + ((n ^ (row & 7)) * 16) +
                             (lane & 3) * 4;
        *reinterpret_cast<uint32_t*>(gbase + off) = pack2<T>(
            acc[4 * n + 2 * r] * l[r], acc[4 * n + 2 * r + 1] * l[r]);
      }
    }
    if constexpr (kNarrowBox) {
      // the narrow box: 16-byte chunks n of a kNarrowRow-byte row, swizzled
      // as the narrow maps are (32 or 64 bytes)
      constexpr int kChunks = Tile::kNarrow / 8;
#pragma unroll
      for (int n = 0; n < kChunks; ++n) {
        const int chunk = n ^ ((row >> Tile::kSwizzleShift) & (kChunks - 1));
        const uint32_t off = Tile::kQWide + row * Tile::kNarrowRow +
                             chunk * 16 + (lane & 3) * 4;
        *reinterpret_cast<uint32_t*>(gbase + off) = pack2<T>(
            acc2[4 * n + 2 * r] * l[r], acc2[4 * n + 2 * r + 1] * l[r]);
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
  if (tid % 128 == 0) {
    if constexpr (kWideBox) tma_store(&to, q_rows, 0, head, qa, batch);
    if constexpr (kNarrowBox)
      tma_store(&to2, q_rows2, Tile::kWide, head, qa, batch);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as the f32 bit pattern with the low 13 bits clear
__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small to about 2^-21 of x: big = tf32(x), and small = x - big
// (exact) as it stands, of which the tensor cores read the top 19 bits
// (TF32 by truncation: under 2^-10 of small, and |small| <= 2^-11 |x|;
// rounding it too cost a conversion a split for no change measured)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_round(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the cross terms first, then big . big (small . small,
// under 2^-22 of the product, is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// The f32 body's tiling: four warps of 16 query rows (kBlockQ a block)
// over key tiles of BK keys, brought by cp.async into two stages; each
// warp splits the Q, K and V fragments it loads (three operations an
// element).  Splitting each K and V tile once per block into shared memory
// instead, or giving a warp two 16-row tiles so each K and V fragment
// feeds two products, ran no faster (tools/ab_flash.py --f32).  BK keeps
// kMinBlocks blocks an SM (at hd 256 three, which caps a thread at 168
// registers: at 255 ptxas spilled 12 to 20 bytes however the loops were
// unrolled, tools/ab_flash.py --f32); Q K^T takes kSteps 8-deep steps on
// the tensor cores before adding them to S on the CUDA cores, its depth
// loop unrolled kUnroll steps at a time.  Row strides (floats) keep the
// fragment loads free of bank conflicts: a warp reads Q and K at rows g (8
// of them) and columns t (4), so their stride is 4 times an odd number; V
// at rows t and columns g, so its stride is 8 times an odd number.
template <int HD>
struct Tf32Tile {
  static constexpr int BK = HD <= 96 ? 32 : (HD <= 128 ? 16 : 8);
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128;
  static constexpr int kSteps = HD <= 128 ? 2 : 1;
  static constexpr int kUnroll = HD <= 128 ? HD / 8 / kSteps : 4;
  static constexpr int kMinBlocks = HD <= 128 ? 2 : 3;
  static constexpr int LDQ = HD + 4, LDK = HD + 4, LDV = HD + 8;
  static constexpr int kStage = BK * (LDK + LDV);  // floats: K, then V
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)kBlockQ * LDQ + (size_t)kStages * kStage);
};

// kCap: whether a softcap applies (tanhf, exact to f32; without it the
// scores stay raw and the scale folds into exp2's unit)
template <int HD, int kCap>
__global__ void __launch_bounds__(Tf32Tile<HD>::kThreads,
                                  Tf32Tile<HD>::kMinBlocks)
    flash_3xtf32(Params p) {
  using Tile = Tf32Tile<HD>;
  constexpr int BK = Tile::BK, KS = Tile::kSteps, KV = Tile::kStage;
  constexpr int LDQ = Tile::LDQ, LDK = Tile::LDK, LDV = Tile::LDV;
  constexpr int CH = HD / 4;  // 16-byte chunks a row
  constexpr int NS = BK / 8;  // 8-key score tiles a warp
  constexpr int NO = HD / 8;  // 8-column output tiles a warp
  constexpr int US = Tile::kUnroll;
  static_assert(Tile::kThreads == 2 * kBlockQ && NS * 4 <= 32 &&
                    (HD / 8) % KS == 0,
                "tiling");
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;             // [kBlockQ][LDQ]
  float* kvs = qs + kBlockQ * LDQ;  // stage s: K [BK][LDK], then V [BK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int nq = (p.s + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBlockQ;
  const int q_last = min(q0 + kBlockQ, p.s) - 1;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kvh = head / (p.h / p.kh);
  const int64_t q_step = (int64_t)p.h * HD, kv_step = (int64_t)p.kh * HD;
  const float* qg = static_cast<const float*>(p.q) +
                    ((int64_t)batch * p.s * p.h + head) * HD;

  // start the copies of kv tile k0 into stage st (rows past T zero-filled);
  // the K and V pointers are formed from the parameters at each call, and
  // the output's at the end, so none is held across the key loop
  auto load_kv = [&](int k0, int st) {
    const int64_t base = ((int64_t)batch * p.t * p.kh + kvh) * HD;
    const float* kg = static_cast<const float*>(p.k) + base;
    const float* vg = static_cast<const float*>(p.v) + base;
    float* ks = kvs + st * KV;
    float* vs = ks + BK * LDK;
    for (int e = tid; e < BK * CH; e += Tile::kThreads) {
      const int r = e / CH, c = e - r * CH, kj = k0 + r;
      const int64_t off = min(kj, p.t - 1) * kv_step + c * 4;
      const int n = kj < p.t ? 16 : 0;
      cp_async16(ks + r * LDK + c * 4, kg + off, n);
      cp_async16(vs + r * LDV + c * 4, vg + off, n);
    }
  };

  int lo, hi;
  live_keys(p, q0, q_last, BK, &lo, &hi);
  for (int e = tid; e < kBlockQ * CH; e += Tile::kThreads) {
    const int r = e / CH, c = e - r * CH, qi = q0 + r;
    cp_async16(qs + r * LDQ + c * 4, qg + min(qi, p.s - 1) * q_step + c * 4,
               qi < p.s ? 16 : 0);
  }
  if (lo < hi) load_kv(lo, 0);
  cp_async_commit();  // Q and the first kv tile

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int wq0 = q0 + warp * 16;  // the warp's rows: wq0 + g, wq0 + g + 8
  const int row0 = wq0 + g;
  const float unit = kCap ? kLog2e : p.scale * kLog2e;
  const float inv_cap = kCap ? 1.f / p.softcap : 0.f;
  const float* qw = qs + (warp * 16 + g) * LDQ + t;
  // the B fragment's column g holds key kperm of each 8-key group, so that
  // a thread's score accumulators (c0, c1, c2, c3) are its P fragment for
  // P V as they stand: rows g, g, g + 8, g + 8 at keys t, t + 4, t, t + 4
  const int kperm = (g >> 1) + 4 * (g & 1);

  int it = 0;
  for (int k0 = lo; k0 < hi; k0 += BK, ++it) {
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; every warp is done with the last
    const float* ks = kvs + (it & 1) * KV;
    const float* vs = ks + BK * LDK;
    // the next tile flies while this one is computed; its stage held the
    // tile before this one, which every warp has finished
    if (k0 + BK < hi) load_kv(k0 + BK, (it + 1) & 1);
    cp_async_commit();
    // a tile whose every (row, key) pair of this warp is admitted skips
    // the mask
    const bool full = k0 + BK <= p.t &&
                      (!p.causal || k0 + BK - 1 <= wq0) &&
                      (p.window <= 0 || wq0 + 15 - k0 < p.window);

    // S = Q K^T: each group of KS 8-deep steps summed from zero on the
    // tensor cores, then added to S on the CUDA cores (the tensor cores
    // truncate their f32 sums: no accumulator lives long on them)
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll US
    for (int k8 = 0; k8 < HD / 8; k8 += KS) {
      uint32_t qb[KS][4], qsm[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const float* qr = qw + (k8 + s) * 8;
        split_tf32(qr[0], qb[s][0], qsm[s][0]);
        split_tf32(qr[8 * LDQ], qb[s][1], qsm[s][1]);
        split_tf32(qr[4], qb[s][2], qsm[s][2]);
        split_tf32(qr[8 * LDQ + 4], qb[s][3], qsm[s][3]);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t kb[KS][2], ksm[KS][2];
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int off = (n * 8 + kperm) * LDK + (k8 + s) * 8 + t;
          split_tf32(ks[off], kb[s][0], ksm[s][0]);
          split_tf32(ks[off + 4], kb[s][1], ksm[s][1]);
        }
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < KS; ++s)
          mma_3xtf32(d, qb[s], qsm[s], kb[s], ksm[s]);
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += d[e];
      }
    }

    // softcap, mask; row max over the quad that shares a row
    uint32_t ok = 0;
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e];
        if constexpr (kCap != 0) x = p.softcap * tanhf(x * p.scale * inv_cap);
        if (full || admitted(p, row0 + (e >> 1) * 8,
                             k0 + n * 8 + t + (e & 1) * 4)) {
          ok |= 1u << (n * 4 + e);
        } else {
          x = kMasked;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f((m[i] - m_new) * unit);
      m[i] = m_new;
      mu[i] = m_new * unit;
      l[i] *= corr[i];  // per-thread partial sums; the quad sums at the end
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = (ok >> (n * 4 + e)) & 1u
                             ? exp2f(fmaf(sc[n][e], unit, -mu[e >> 1]))
                             : 0.f;
        sc[n][e] = pe;
        l[e >> 1] += pe;
      }
    }
    // a warp whose rows all kept their max skips the rescale (exactly 1)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    }

    // O += P V: P split once (its A fragment is (c0, c2, c1, c3)); each
    // 8-column output tile sums the tile's keys from zero, then is added
    // to O on the CUDA cores
    uint32_t pb[NS][4], psm[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      split_tf32(sc[n][0], pb[n][0], psm[n][0]);
      split_tf32(sc[n][2], pb[n][1], psm[n][1]);
      split_tf32(sc[n][1], pb[n][2], psm[n][2]);
      split_tf32(sc[n][3], pb[n][3], psm[n][3]);
    }
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int off = (n * 8 + t) * LDV + dn * 8 + g;
        uint32_t vb[2], vsm[2];
        split_tf32(vs[off], vb[0], vsm[0]);
        split_tf32(vs[off + 4 * LDV], vb[1], vsm[1]);
        mma_3xtf32(o, pb[n], psm[n], vb, vsm);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] += o[e];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  float* og = static_cast<float*>(p.out) +
              ((int64_t)batch * p.s * p.h + head) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + i * 8;
    if (qi >= p.s) continue;
    // uncapped, m is in raw score units
    if (p.lse != nullptr && t == 0)
      store_lse(p, batch, head, qi,
                kCap || m[i] == kMasked ? m[i] : m[i] * p.scale, l[i]);
    float* orow = og + qi * q_step + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(acc[n][2 * i] / l[i], acc[n][2 * i + 1] / l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// past head dim 256: depth boxes and value slices, in bf16/f16 and in f32
// ---------------------------------------------------------------------------

// The 16-bit body past hd 256 (flash_wgmma_wide): two warpgroups of 64
// query rows, thread 0 also the producer, as flash_wgmma.  Q's 128 rows
// at hd 512 alone take 128 KB and one 64-key K tile another 64 KB, and a
// warpgroup's m64n{hd} output would take hd / 2 registers a thread, so
// neither the depth nor the output's width is held whole.  The depth
// streams through a ring of kStages stages, each one 64-column box of Q's
// 128 rows (16 KB) and of the K tile's 64 keys (8 KB), 128-byte swizzled:
// S = Q K^T takes four k-steps of m64n64k16 from each box in turn, summed
// on the tensor cores in f32 (a box's products are issued as it lands,
// the box before it released once its products are done).  The output's
// columns are cut into slices of DV = 256, one slice a block (grid z):
// O += P V is the hd 256 body's m64n256k16 from a V stage of the slice's
// four 64-column boxes of the tile's keys (32 KB; 2 stages), and each
// slice recomputes S, so Q K^T costs ceil(hd / 256) times its flops (2x
// at hd 320 and 512, 4x at 1024).  Shared memory: 6 depth stages (144
// KB), 2 V stages (64 KB), barriers and 1 KB of alignment: 214,144 bytes.
// Registers a thread: the output 128, S 32, P 16, beside addresses.  A
// producer warp of its own, as flash_wgmma_ws has, makes nine warps, three
// on one of the SM's four register files, which caps a thread at 168: the
// first build so spilled about 1 KB a thread.  So thread 0 refills a depth
// stage once both warpgroups released its box, and a V stage once both
// finished its P V, and eight warps keep 255 registers.  Columns past hd
// read as zeros: the tensor maps take the
// true hd (a multiple of 8: 16-byte rows) and zero-fill the last depth
// box; a V box wholly past hd is zeroed once and never loaded; the output
// is stored from registers, columns past hd and rows past S skipped.  The
// lse is written by the first slice's blocks.
struct WideTile {
  static constexpr int BK = 64;                    // keys a tile
  static constexpr int DV = 256;                   // value columns a block
  static constexpr int kQBox = kWgBlockQ * 128;    // 128 rows x 64 columns
  static constexpr int kKBox = BK * 128;           // 64 keys x 64 columns
  static constexpr int kQKBytes = kQBox + kKBox;   // a depth stage
  static constexpr int kVBytes = (DV / 64) * kKBox;
  static constexpr int kVStages = 2;
  static constexpr int kStages =
      (kMaxSmem - kVStages * kVBytes - 2048) / kQKBytes;
  static constexpr int kVOffset = kStages * kQKBytes;
  static constexpr int kBarOffset = kVOffset + kVStages * kVBytes;
  static constexpr size_t kSmemBytes =
      kBarOffset + 8 * (2 * kStages + 2 * kVStages) + 1024;
  static_assert(kStages >= 2 && kSmemBytes <= kMaxSmem,
                "two depth stages must fit beside the V stages");
};

// kCap: 1 when a softcap applies; T: the type of q, k, v and out
// (__nv_bfloat16 or __half)
template <int kCap, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_wide(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, Params p) {
  using Tile = WideTile;
  constexpr int BK = Tile::BK, NST = Tile::kStages, NV = Tile::kVStages;
  constexpr int NS = BK / 8;         // score n8 blocks per thread
  constexpr int NO = Tile::DV / 8;   // output n8 blocks per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms 1024-aligned
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + Tile::kBarOffset;
  auto qk_smem = [&](int st) { return base + st * Tile::kQKBytes; };
  auto v_smem = [&](int st) {
    return base + Tile::kVOffset + st * Tile::kVBytes;
  };
  // per stage: landed, and read by both warpgroups
  auto full_qk = [&](int st) { return bars + 8 * st; };
  auto free_qk = [&](int st) { return bars + 8 * (NST + st); };
  auto full_v = [&](int st) { return bars + 8 * (2 * NST + st); };
  auto free_v = [&](int st) { return bars + 8 * (2 * NST + NV + st); };

  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup, broadcast from lane 0 so the compiler sees it uniform
  // across the warp
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int nq = (p.s + kWgBlockQ - 1) / kWgBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kWgBlockQ;
  const int q_last = min(q0 + kWgBlockQ, p.s) - 1;
  const int head = blockIdx.y;
  const int n_slices = (p.hd + Tile::DV - 1) / Tile::DV;
  const int batch = (int)blockIdx.z / n_slices;
  const int v0 = ((int)blockIdx.z - batch * n_slices) * Tile::DV;
  const int kvh = head / (p.h / p.kh);
  const int nd = (p.hd + 63) / 64;   // depth boxes a tile
  // the slice's V boxes that hold a column of v
  const int v_boxes = min(Tile::DV / 64, (p.hd - v0 + 63) / 64);
  int lo, hi;
  live_keys(p, q0, q_last, BK, &lo, &hi);
  const int n_tiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;
  const int n_boxes = n_tiles * nd;

  // depth box i (tile i / nd, columns 64 (i % nd) ..) into stage i % NST
  // and tile j's V boxes into stage j % NV, each once both warpgroups
  // released what the stage held
  auto produce_box = [&](int i) {
    const int st = i % NST, j = i / nd, d = i - j * nd;
    mbar_wait(free_qk(st), ((i / NST) & 1) ^ 1);
    mbar_expect(full_qk(st), Tile::kQKBytes);
    tma_load(qk_smem(st), &tq, full_qk(st), 64 * d, head, q0, batch);
    tma_load(qk_smem(st) + Tile::kQBox, &tk, full_qk(st), 64 * d, kvh,
             lo + j * BK, batch);
  };
  auto produce_v = [&](int j) {
    const int sv = j % NV;
    mbar_wait(free_v(sv), ((j / NV) & 1) ^ 1);
    mbar_expect(full_v(sv), v_boxes * Tile::kKBox);
    for (int e = 0; e < v_boxes; ++e)
      tma_load(v_smem(sv) + e * Tile::kKBox, &tv, full_v(sv), v0 + 64 * e,
               kvh, lo + j * BK, batch);
  };
  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(full_qk(st), 1);
      mbar_init(free_qk(st), 8);   // one arrival per warp
    }
    for (int st = 0; st < NV; ++st) {
      mbar_init(full_v(st), 1);
      mbar_init(free_v(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the V boxes wholly past hd stay zero in every stage
  for (int st = 0; st < NV; ++st)
    for (int e = v_boxes; e < Tile::DV / 64; ++e)
      for (int i = tid; i < Tile::kKBox / 16; i += kWgThreads)
        reinterpret_cast<uint4*>(gbase + Tile::kVOffset + st * Tile::kVBytes +
                                 e * Tile::kKBox)[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < NST && i < n_boxes; ++i) produce_box(i);
    for (int j = 0; j < NV && j < n_tiles; ++j) produce_v(j);
  }
  __syncwarp();

  const int wq = (tid / 32) & 3;           // warp within it: 16 rows each
  const int rq = 64 * wg + 16 * wq + (lane >> 2);   // rows rq, rq + 8
  const int row0 = q0 + rq;
  const int qa = q0 + 64 * wg, qb = min(qa + 63, p.s - 1);
  // a tile whose every (row, key) pair is admitted skips the mask
  auto full_tile = [&](int k0) {
    return k0 + BK <= p.t && (!p.causal || k0 + BK - 1 <= qa) &&
           (p.window <= 0 || qb - k0 < p.window);
  };
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
  float acc[NO * 4];
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
  const float inv_cap = kCap ? 1.f / p.softcap : 0.f;
  // S (+)= Q K^T over the depth box in stage st: the warpgroup's 64 rows
  // of Q and the tile's keys, both K-major; `more` 0 overwrites S
  auto issue_box = [&](int st, int more) {
    const uint32_t qs = qk_smem(st) + wg * 64 * 128;
    const uint32_t ks = qk_smem(st) + Tile::kQBox;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64<T>(sc, sw128_desc(qs + kk * 32, 16),
                      sw128_desc(ks + kk * 32, 16), more || kk > 0);
    wgmma_commit();
  };
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;

  // box i read: the warp releases its stage, and thread 0 refills it with
  // box i + NST
  auto release_box = [&](int i) {
    if (lane == 0) mbar_arrive(free_qk(i % NST));
    if (tid == 0 && i + NST < n_boxes) produce_box(i + NST);
    __syncwarp();
  };
  int g = 0;   // depth boxes consumed
  for (int j = 0; j < n_tiles; ++j, g += nd) {
    const int k0 = lo + j * BK;
    mbar_wait(full_qk(g % NST), (g / NST) & 1);
    fence_regs(sc);
    wgmma_fence();
    issue_box(g % NST, 0);
    for (int i = g + 1; i < g + nd; ++i) {
      mbar_wait(full_qk(i % NST), (i / NST) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_box(i % NST, 1);
      wgmma_wait<1>();   // the box before: its products are done
      fence_regs(sc);
      release_box(i - 1);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    release_box(g + nd - 1);
    if (full_tile(k0)) {
      online_softmax<NS, false, kCap>(sc, p, row0, k0, lane, inv_cap, m, l,
                                      corr);
    } else {
      online_softmax<NS, true, kCap>(sc, p, row0, k0, lane, inv_cap, m, l,
                                     corr);
    }
    // P (in sc) to the A fragments in T; the output rescaled by corr (a
    // warp none of whose rows raised its max leaves it as it is)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      pa[n >> 1][(n & 1) * 2] = pack2<T>(sc[4 * n], sc[4 * n + 1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack2<T>(sc[4 * n + 2], sc[4 * n + 3]);
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < NO * 4; ++i) acc[i] *= corr[(i >> 1) & 1];
    }
    // O += P V over the slice's 256 columns, V MN-major from shared memory
    const int sv = j % NV;
    mbar_wait(full_v(sv), (j / NV) & 1);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_n256<T>(acc, pa[kk],
                       sw128_desc(v_smem(sv) + kk * 16 * 128, Tile::kKBox));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(free_v(sv));
    if (tid == 0 && j + NV < n_tiles) produce_v(j + NV);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    // m is in raw score units uncapped (the scale went into the exponent),
    // in tanh units capped (the softcap went there)
    const int qi = row0 + 8 * r;
    if (p.lse != nullptr && v0 == 0 && (lane & 3) == 0 && qi < p.s)
      store_lse(p, batch, head, qi,
                m[r] == kMasked ? m[r] : m[r] * (kCap ? p.softcap : p.scale),
                l[r]);
    l[r] = 1.f / l[r];
  }
  // the output from registers: rows past S and columns past hd skipped
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= p.s) continue;
    T* orow = og + (((int64_t)batch * p.s + qi) * p.h + head) * p.hd + v0 +
              2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (v0 + 8 * n + 2 * (lane & 3) < p.hd)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack2<T>(
            acc[4 * n + 2 * r] * l[r], acc[4 * n + 2 * r + 1] * l[r]);
  }
}

// The f32 body past hd 256 (flash_3xtf32_wide): flash_3xtf32's four warps
// of 16 query rows and its 3xTF32 products, cut as the 16-bit body is.
// Q's 64 rows at the whole depth would take 66 KB at hd 256 and 132 KB at
// 512 beside K and V, and the output hd / 2 registers a thread, so the
// depth comes in chunks of DC = 64 columns, Q's 64 rows and the tile's 32
// keys (17 KB + 8.5 KB), two chunks in flight by cp.async, each summed into
// S by eight 8-deep steps of three TF32 products; the output's columns are
// cut into slices of DV = 192 (grid z), and P V runs on the slice's V tile
// (32 keys x 192 columns, 25 KB) as flash_3xtf32's does: each 8-column
// output tile sums the tile's keys from zero on the tensor cores, then is
// added to O on the CUDA cores.  Shared memory 77,824 bytes, two blocks an
// SM; the output takes 96 registers a thread.  The tiling is the fastest
// that does not spill of the eleven in tools/f32_wide_tilings.py (slices
// of 128 to 256 columns, 8- to 32-key tiles, two or three blocks an SM,
// the depth steps unrolled 2 to 8 at a time), timed at B 2, S 1024, H 8
// over Kh 2, hd 512 on an H100 SXM (700 W): 1.87 ms; 256-column slices
// over 16 keys 2.04 ms spilling 4 bytes, 2.15 ms unrolled two steps at a
// time without; 8 keys at three blocks (168 registers) spilled 624 bytes.
// Each slice recomputes S (Q K^T ceil(hd / 192) times: 3x at hd 512);
// output tiles wholly past hd are skipped.
struct Tf32WideTile {
  static constexpr int BK = 32;    // keys a tile
  static constexpr int DC = 64;    // depth columns a chunk
  static constexpr int DV = 192;   // value columns a block
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = 2;
  static constexpr int LDQ = DC + 4, LDK = DC + 4, LDV = DV + 8;
  static constexpr int kChunk = kBlockQ * LDQ + BK * LDK;  // floats: Q, K
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)kStages * kChunk + (size_t)BK * LDV);
};

template <int kCap>
__global__ void __launch_bounds__(Tf32WideTile::kThreads,
                                  Tf32WideTile::kMinBlocks)
    flash_3xtf32_wide(Params p) {
  using Tile = Tf32WideTile;
  constexpr int BK = Tile::BK, DC = Tile::DC, DV = Tile::DV;
  constexpr int LDQ = Tile::LDQ, LDK = Tile::LDK, LDV = Tile::LDV;
  constexpr int NS = BK / 8;  // 8-key score tiles a warp
  constexpr int NO = DV / 8;  // 8-column output tiles a warp
  extern __shared__ __align__(16) float smem_f32[];
  float* vs = smem_f32 + Tile::kStages * Tile::kChunk;  // [BK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int nq = (p.s + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBlockQ;
  const int q_last = min(q0 + kBlockQ, p.s) - 1;
  const int head = blockIdx.y;
  const int n_slices = (p.hd + DV - 1) / DV;
  const int batch = (int)blockIdx.z / n_slices;
  const int v0 = ((int)blockIdx.z - batch * n_slices) * DV;
  const int kvh = head / (p.h / p.kh);
  const int nd = (p.hd + DC - 1) / DC;
  const int64_t q_step = (int64_t)p.h * p.hd, kv_step = (int64_t)p.kh * p.hd;

  // depth chunk d (columns DC d ..) of Q's rows and of the keys from k0
  // into stage st; rows past S or T and columns past hd zero-filled
  auto load_qk = [&](int k0, int d, int st) {
    const float* qg = static_cast<const float*>(p.q) +
                      ((int64_t)batch * p.s * p.h + head) * p.hd;
    const float* kg = static_cast<const float*>(p.k) +
                      ((int64_t)batch * p.t * p.kh + kvh) * p.hd;
    float* qs = smem_f32 + st * Tile::kChunk;
    float* ks = qs + kBlockQ * LDQ;
    constexpr int CH = DC / 4;  // 16-byte chunks a row
    for (int e = tid; e < (kBlockQ + BK) * CH; e += Tile::kThreads) {
      const int r = e / CH, c = e - r * CH, col = d * DC + c * 4;
      if (r < kBlockQ) {
        const int qi = q0 + r;
        const bool ok = qi < p.s && col < p.hd;
        cp_async16(qs + r * LDQ + c * 4, qg + (ok ? qi * q_step + col : 0),
                   ok ? 16 : 0);
      } else {
        const int kj = k0 + r - kBlockQ;
        const bool ok = kj < p.t && col < p.hd;
        cp_async16(ks + (r - kBlockQ) * LDK + c * 4,
                   kg + (ok ? kj * kv_step + col : 0), ok ? 16 : 0);
      }
    }
  };
  // the slice's columns of the keys from k0
  auto load_v = [&](int k0) {
    const float* vg = static_cast<const float*>(p.v) +
                      ((int64_t)batch * p.t * p.kh + kvh) * p.hd;
    constexpr int CH = DV / 4;
    for (int e = tid; e < BK * CH; e += Tile::kThreads) {
      const int r = e / CH, c = e - r * CH, kj = k0 + r, col = v0 + c * 4;
      const bool ok = kj < p.t && col < p.hd;
      cp_async16(vs + r * LDV + c * 4, vg + (ok ? kj * kv_step + col : 0),
                 ok ? 16 : 0);
    }
  };

  int lo, hi;
  live_keys(p, q0, q_last, BK, &lo, &hi);
  const int n_tiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;
  if (n_tiles > 0) load_qk(lo, 0, 0);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int wq0 = q0 + warp * 16;  // the warp's rows: wq0 + g, wq0 + g + 8
  const int row0 = wq0 + g;
  const float unit = kCap ? kLog2e : p.scale * kLog2e;
  const float inv_cap = kCap ? 1.f / p.softcap : 0.f;
  // the B fragment's column g holds key kperm of each 8-key group (as in
  // flash_3xtf32): a thread's score accumulators are its P fragment
  const int kperm = (g >> 1) + 4 * (g & 1);

  int gc = 0;   // depth chunks consumed; chunk gc sits in stage gc & 1
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = lo + j * BK;
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    for (int d = 0; d < nd; ++d, ++gc) {
      // the next chunk flies while this one is summed (after the last
      // chunk, this tile's V: the last tile's P V is done)
      if (d + 1 < nd) {
        load_qk(k0, d + 1, (gc + 1) & 1);
      } else {
        load_v(k0);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // chunk gc landed
      const float* qs = smem_f32 + (gc & 1) * Tile::kChunk;
      const float* ks = qs + kBlockQ * LDQ;
      const float* qw = qs + (warp * 16 + g) * LDQ + t;
#pragma unroll 2
      for (int k8 = 0; k8 < DC / 8; ++k8) {
        uint32_t qb[4], qsm[4];
        const float* qr = qw + k8 * 8;
        split_tf32(qr[0], qb[0], qsm[0]);
        split_tf32(qr[8 * LDQ], qb[1], qsm[1]);
        split_tf32(qr[4], qb[2], qsm[2]);
        split_tf32(qr[8 * LDQ + 4], qb[3], qsm[3]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int off = (n * 8 + kperm) * LDK + k8 * 8 + t;
          uint32_t kb[2], ksm[2];
          split_tf32(ks[off], kb[0], ksm[0]);
          split_tf32(ks[off + 4], kb[1], ksm[1]);
          float dd[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(dd, qb, qsm, kb, ksm);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] += dd[e];
        }
      }
      __syncthreads();  // every warp is done with stage gc & 1
    }
    // the next tile's first chunk flies while this tile's P V runs
    if (j + 1 < n_tiles) load_qk(k0 + BK, 0, gc & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // V landed
    const bool full = k0 + BK <= p.t &&
                      (!p.causal || k0 + BK - 1 <= wq0) &&
                      (p.window <= 0 || wq0 + 15 - k0 < p.window);

    // softcap, mask; row max over the quad that shares a row
    uint32_t ok = 0;
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e];
        if constexpr (kCap != 0) x = p.softcap * tanhf(x * p.scale * inv_cap);
        if (full || admitted(p, row0 + (e >> 1) * 8,
                             k0 + n * 8 + t + (e & 1) * 4)) {
          ok |= 1u << (n * 4 + e);
        } else {
          x = kMasked;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f((m[i] - m_new) * unit);
      m[i] = m_new;
      mu[i] = m_new * unit;
      l[i] *= corr[i];  // per-thread partial sums; the quad sums at the end
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = (ok >> (n * 4 + e)) & 1u
                             ? exp2f(fmaf(sc[n][e], unit, -mu[e >> 1]))
                             : 0.f;
        sc[n][e] = pe;
        l[e >> 1] += pe;
      }
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    }

    // O += P V over the slice, P split once (its A fragment is (c0, c2,
    // c1, c3)); output tiles wholly past hd are skipped
    uint32_t pb[NS][4], psm[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      split_tf32(sc[n][0], pb[n][0], psm[n][0]);
      split_tf32(sc[n][2], pb[n][1], psm[n][1]);
      split_tf32(sc[n][1], pb[n][2], psm[n][2]);
      split_tf32(sc[n][3], pb[n][3], psm[n][3]);
    }
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      if (v0 + dn * 8 >= p.hd) continue;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int off = (n * 8 + t) * LDV + dn * 8 + g;
        uint32_t vb[2], vsm[2];
        split_tf32(vs[off], vb[0], vsm[0]);
        split_tf32(vs[off + 4 * LDV], vb[1], vsm[1]);
        mma_3xtf32(o, pb[n], psm[n], vb, vsm);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] += o[e];
    }
    __syncthreads();  // every warp is done with V
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  float* og = static_cast<float*>(p.out) +
              ((int64_t)batch * p.s * p.h + head) * p.hd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + i * 8;
    if (qi >= p.s) continue;
    // uncapped, m is in raw score units
    if (p.lse != nullptr && t == 0 && v0 == 0)
      store_lse(p, batch, head, qi,
                kCap || m[i] == kMasked ? m[i] : m[i] * p.scale, l[i]);
    float* orow = og + qi * q_step + v0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (v0 + n * 8 + 2 * t < p.hd)
        *reinterpret_cast<float2*>(orow + n * 8) =
            make_float2(acc[n][2 * i] / l[i], acc[n][2 * i + 1] / l[i]);
  }
}

// The f32 body's TF32 rounding, element by element: a probe that holds the
// CPU model (ref.tf32_round) to the card's cvt.rna, bit for bit
__global__ void tf32_round_probe(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __uint_as_float(tf32_round(x[i]));
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

// A 16-bit (B, rows, heads, hd) tensor of T as a 4-d map (hd, heads, rows,
// B): boxes of box_cols columns (64, 128-byte swizzled; 32, 64-byte
// swizzled; or 16, 32-byte swizzled: a box row is the swizzle's span) x one
// head x box_rows rows x one sequence; rows past `rows` read as zeros and
// are not written, per sequence
template <typename T>
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
  return fn(map,
            kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
            : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, typename T>
int launch_wgmma(const Params& p, int b, cudaStream_t stream) {
  using Tile = WgTile<HD>;
  CUtensorMap tq, tk, tv, to;
  if (!make_map<T>(&tq, p.q, HD, p.h, p.s, b, kWgBlockQ) ||
      !make_map<T>(&tk, p.k, HD, p.kh, p.t, b, Tile::BK) ||
      !make_map<T>(&tv, p.v, HD, p.kh, p.t, b, Tile::BK) ||
      !make_map<T>(&to, p.out, HD, p.h, p.s, b, kWgBlockQ))
    return (int)cudaErrorNotSupported;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.s + kWgBlockQ - 1) / kWgBlockQ, p.h, b);
  flash_wgmma<HD, T><<<grid, kWgThreads, Tile::kSmemBytes, stream>>>(
      tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

template <int HD, int kCap, typename T>
int launch_ws(const Params& p, int b, cudaStream_t stream) {
  using Tile = WsTile<HD>;
  // each tensor is two maps over the same memory: at hd 80 and 96 columns
  // 0-63 and 64-(hd - 1) (at hd 64 the second is never read), at hd 16 and
  // 32 the whole row in the second (the first, the same, is never read)
  constexpr int kCols1 = Tile::kWide > 0 ? 64 : HD;
  constexpr int kCols2 = Tile::kNarrow > 0 ? Tile::kNarrow : 64;
  CUtensorMap tq, tq2, tk, tk2, tv, tv2, to, to2;
  if (!make_map<T>(&tq, p.q, HD, p.h, p.s, b, kWgBlockQ, kCols1) ||
      !make_map<T>(&tq2, p.q, HD, p.h, p.s, b, kWgBlockQ, kCols2) ||
      !make_map<T>(&tk, p.k, HD, p.kh, p.t, b, Tile::BK, kCols1) ||
      !make_map<T>(&tk2, p.k, HD, p.kh, p.t, b, Tile::BK, kCols2) ||
      !make_map<T>(&tv, p.v, HD, p.kh, p.t, b, Tile::BK, kCols1) ||
      !make_map<T>(&tv2, p.v, HD, p.kh, p.t, b, Tile::BK, kCols2) ||
      !make_map<T>(&to, p.out, HD, p.h, p.s, b, 64, kCols1) ||
      !make_map<T>(&to2, p.out, HD, p.h, p.s, b, 64, kCols2))
    return (int)cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_ws<HD, kCap, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::kSmemBytes);
  // more than one block an SM: ask for the carveout that holds them all
  if (err == cudaSuccess && Tile::kMinBlocks > 1)
    err = cudaFuncSetAttribute(flash_wgmma_ws<HD, kCap, T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // one dimension over (batch, head, query tile), in the kernel's order
  const dim3 grid(p.h * b * ((p.s + kWgBlockQ - 1) / kWgBlockQ));
  flash_wgmma_ws<HD, kCap, T>
      <<<grid, kWsThreads, Tile::kSmemBytes, stream>>>(tq, tq2, tk, tk2, tv,
                                                       tv2, to, to2, p);
  return (int)cudaGetLastError();
}

// the 16-bit body past hd 256 (p.hd a multiple of 8)
template <int kCap, typename T>
int launch_wgmma_wide(const Params& p, int b, cudaStream_t stream) {
  using Tile = WideTile;
  CUtensorMap tq, tk, tv;
  if (!make_map<T>(&tq, p.q, p.hd, p.h, p.s, b, kWgBlockQ) ||
      !make_map<T>(&tk, p.k, p.hd, p.kh, p.t, b, Tile::BK) ||
      !make_map<T>(&tv, p.v, p.hd, p.kh, p.t, b, Tile::BK))
    return (int)cudaErrorNotSupported;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_wide<kCap, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  // (query tile, head, batch x value slice)
  const dim3 grid((p.s + kWgBlockQ - 1) / kWgBlockQ, p.h,
                  b * ((p.hd + Tile::DV - 1) / Tile::DV));
  flash_wgmma_wide<kCap, T>
      <<<grid, kWgThreads, Tile::kSmemBytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// the f32 body past hd 256 (p.hd a multiple of 8)
template <int kCap>
int launch_3xtf32_wide(const Params& p, int b, cudaStream_t stream) {
  using Tile = Tf32WideTile;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_3xtf32_wide<kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.s + kBlockQ - 1) / kBlockQ, p.h,
                  b * ((p.hd + Tile::DV - 1) / Tile::DV));
  flash_3xtf32_wide<kCap>
      <<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int kCap>
int launch_wide(int dtype, const Params& p, int b, cudaStream_t stream) {
  if (dtype == 1) return launch_wgmma_wide<kCap, __nv_bfloat16>(p, b, stream);
  if (dtype == 2) return launch_wgmma_wide<kCap, __half>(p, b, stream);
  return launch_3xtf32_wide<kCap>(p, b, stream);
}

// the tensor-core body of a 16-bit type T at head dim HD
template <int HD, typename T>
int launch_16(const Params& p, int b, cudaStream_t stream) {
  if constexpr (HD >= 128) {
    return launch_wgmma<HD, T>(p, b, stream);
  } else {
    return p.softcap > 0.f ? launch_ws<HD, 1, T>(p, b, stream)
                           : launch_ws<HD, 0, T>(p, b, stream);
  }
}

template <int HD>
int launch_hd(int dtype, const Params& p, int b, cudaStream_t stream) {
  if (dtype == 1) return launch_16<HD, __nv_bfloat16>(p, b, stream);
  if (dtype == 2) return launch_16<HD, __half>(p, b, stream);
  using Tile = Tf32Tile<HD>;
  return p.softcap > 0.f
             ? launch(flash_3xtf32<HD, 1>, Tile::kThreads, Tile::kSmemBytes,
                      p, b, stream)
             : launch(flash_3xtf32<HD, 0>, Tile::kThreads, Tile::kSmemBytes,
                      p, b, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  q, out (B, S, H, hd) and k, v
// (B, T, Kh, hd), contiguous, 16-byte aligned; lse null, or (B, H, S)
// float32.  hd: one of 16, 32, 64, 80, 96, 128 and 256, or past 256 a
// multiple of 8 (the bodies past 256 zero-fill to a multiple of 64).
// Returns a cudaError_t; an unsupported head dim or type is
// cudaErrorInvalidValue and launches nothing.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int dtype,
                                      int b, int s, int t, int h, int kh,
                                      int hd, int causal, int window,
                                      float scale, float softcap,
                                      void* stream) {
  if (dtype < 0 || dtype > 2 || b < 1 || s < 1 || t < 1 || kh < 1 ||
      h % kh != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q,  k,      v,      out, static_cast<float*>(lse),
                 s,  t,      h,      kh,  causal,
                 window, hd, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(dtype, p, b, st);
    case 32: return launch_hd<32>(dtype, p, b, st);
    case 64: return launch_hd<64>(dtype, p, b, st);
    case 80: return launch_hd<80>(dtype, p, b, st);
    case 96: return launch_hd<96>(dtype, p, b, st);
    case 128: return launch_hd<128>(dtype, p, b, st);
    case 256: return launch_hd<256>(dtype, p, b, st);
    default:
      if (hd <= 256 || hd % 8) return (int)cudaErrorInvalidValue;
      return softcap > 0.f ? launch_wide<1>(dtype, p, b, st)
                           : launch_wide<0>(dtype, p, b, st);
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

// The tiling of a wgmma body at head dim hd, bf16 and f16 alike (16, 32,
// 64, 80 and 96: flash_wgmma_ws; 128 and 256: flash_wgmma; past 256:
// flash_wgmma_wide, its depth stages): keys a tile, K/V stages and dynamic
// shared memory; returns -1 for another head dim.
extern "C" int flash_attention_tiling(int hd, int* bk, int* stages,
                                      int* smem_bytes) {
  switch (hd) {
    case 16: return tiling<WsTile<16>>(bk, stages, smem_bytes);
    case 32: return tiling<WsTile<32>>(bk, stages, smem_bytes);
    case 64: return tiling<WsTile<64>>(bk, stages, smem_bytes);
    case 80: return tiling<WsTile<80>>(bk, stages, smem_bytes);
    case 96: return tiling<WsTile<96>>(bk, stages, smem_bytes);
    case 128: return tiling<WgTile<128>>(bk, stages, smem_bytes);
    case 256: return tiling<WgTile<256>>(bk, stages, smem_bytes);
    default:
      return hd > 256 && hd % 8 == 0
                 ? tiling<WideTile>(bk, stages, smem_bytes)
                 : -1;
  }
}

// The tiling of the f32 body (flash_3xtf32; past 256 flash_3xtf32_wide, its
// depth chunks in flight) at head dim hd: keys a tile, K/V stages and
// dynamic shared memory; returns -1 for another head dim.
extern "C" int flash_attention_f32_tiling(int hd, int* bk, int* stages,
                                          int* smem_bytes) {
  switch (hd) {
    case 16: return tiling<Tf32Tile<16>>(bk, stages, smem_bytes);
    case 32: return tiling<Tf32Tile<32>>(bk, stages, smem_bytes);
    case 64: return tiling<Tf32Tile<64>>(bk, stages, smem_bytes);
    case 80: return tiling<Tf32Tile<80>>(bk, stages, smem_bytes);
    case 96: return tiling<Tf32Tile<96>>(bk, stages, smem_bytes);
    case 128: return tiling<Tf32Tile<128>>(bk, stages, smem_bytes);
    case 256: return tiling<Tf32Tile<256>>(bk, stages, smem_bytes);
    default:
      return hd > 256 && hd % 8 == 0
                 ? tiling<Tf32WideTile>(bk, stages, smem_bytes)
                 : -1;
  }
}

// y = the f32 body's TF32 rounding of x (n floats on the card).
extern "C" int flash_attention_tf32_round(const void* x, void* y, int n,
                                          void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  tf32_round_probe<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
