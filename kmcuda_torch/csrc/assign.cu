// Lloyd assignment and segment-sum kernels for Hopper (sm_90a).
//
// Replaces the two Lloyd Pallas kernels of the JAX package:
//   kmcuda_tpu/ops/assign_pallas.py:_kernel             (fused_lloyd_pass, B1)
//   kmcuda_tpu/ops/assign_pallas.py:_kernel_assign_only (assign_only_pass, B2)
//
// What it computes is the XLA path of the reference (ops/assign.py
// assign_pass + ops/distance.py scores/argmin_rescored), not the Pallas
// body: scores are clamped to PAD_PENALTY when non-finite, and the two best
// candidates are rescored exactly with the subtract-square distance.
//
// kmt_assign (B2, and the first half of B1): scores on the tensor cores.
//   One block of two warpgroups owns BM = 128 sample rows (64 each) and
//   walks the centroid tiles of BN columns in order; for each tile it walks
//   the feature axis in chunks of 128 bytes (64 bf16 or 32 fp32 features).
//   A ring of shared-memory stages holds each chunk of x and of the panel,
//   filled by 16-byte cp.async with zero-fill past every edge (plain loads
//   where rows are not 16-byte aligned, as for odd f in bf16), and
//   `wgmma.mma_async` reads both operands from there, K-major, into fp32
//   accumulators in registers:
//   - bf16 storage: m64n128k16 f32.bf16.bf16, BN = 128, 3 stages, two
//     blocks per SM.
//   - fp32 storage: error-compensated TF32 (3xTF32), the Hopper analogue
//     of the reference's Precision.HIGHEST (a multi-pass bf16 product on
//     the TPU's matrix unit): v = hi + lo with hi = tf32_rna(v) and
//     lo = tf32_rna(v - hi); each k-step accumulates x_lo.c_hi, x_hi.c_lo,
//     then x_hi.c_hi with m64n128k8 f32.tf32.tf32, BN = 128, 3 stages, one
//     block per SM.  The wrapper splits the panel once per call; each
//     thread splits the x chunks it loaded once they land.  The tensor
//     cores' fp32 accumulation truncates: with all three products in one
//     accumulator over all stages (96 truncating adds over 256 features)
//     the scores drifted past the plain twin's 1e-5 relative on the H100.
//     So each stage starts afresh, with x_hi.c_hi and the two small cross
//     terms in separate accumulators, and adds them to the tile's sums in
//     registers, rounded to nearest.  Single-pass TF32 is never used.
//   Epilogue of each centroid tile, from the accumulator fragment (a thread
//   holds rows lane/4 and lane/4 + 8 of its warp's 16, BN/4 columns):
//   s = |c|^2 - 2 prod (L2) or -prod (cosine), non-finite -> PAD_PENALTY,
//   pushed into a running top-2 per row; columns past k are skipped.
//   After the last tile the four lanes of a quad merge their lists by warp
//   shuffles into a per-block table, and the exact rescore of the two
//   candidates against the fp32 NaN-zeroed centroid table runs on it, 16
//   lanes per row; invalid rows get id k; the reassignment count against
//   `prev` is an integer atomic.
//   A row's score depends only on its own data and the fixed k-step and
//   column-tile order: no split-K across blocks, no float atomics.  So B2
//   over a gathered subset of the rows gives them bitwise what it gives
//   them over all rows, which the Yinyang loop rests on.
// kmt_segment_sum (the rest of B1): sums[a] += x_row, counts[a] += 1 over
//   rows with a < k.  No float atomics: P fixed row ranges, block (slab, p)
//   walks its range in order into partial[p] with each thread owning one
//   feature column, and a second kernel adds the P partials in fixed order,
//   so the sums repeat bitwise from run to run.
//
// Shared-memory layout and wgmma descriptors.  A tile of R rows is stored as
// R rows of 128 bytes (one feature chunk), with the 128-byte swizzle that
// TMA's SWIZZLE_128B writes: the 16-byte unit u of row r sits at byte
// r * 128 + ((u ^ (r % 8)) * 16), and every tile starts 1024-byte aligned,
// so the XOR term is address bits [4, 7) ^ [7, 10), as the hardware applies
// it.  Eight rows form a 1024-byte swizzle atom.  The descriptor of a
// K-major operand is then: start address >> 4 (bits 0-13), leading byte
// offset 1 (16 B; unused, as one k-step of 32 bytes never leaves its
// 128-byte row), stride byte offset 1024 >> 4 = 64 (the next 8-row atom,
// bits 32-45), layout type 1 = 128-byte swizzle (bits 62-63).  The k-step
// s of a chunk (16 bf16 or 8 tf32 = 32 bytes) starts at tile + 32 * s; the
// hardware swizzles the absolute address, so the unit it fetches for row r
// is where the loader put it.  Warpgroup g's A operand starts at row 64 g
// (byte 8192 g, still atom-aligned).
//
// What bounds it on the H100: the product, 2*n*k*f FLOP (three times that
// in TF32 for fp32 storage), on the tensor cores (989 TFLOP/s bf16, 495
// TFLOP/s TF32) against n*f + k*f bytes of input: compute-bound.  The
// design streams both operands so that any f takes one path: the panel is
// re-read from L2 by every row block, (n / BM) * k * f * size bytes, and
// the x slab k / BN times; keeping the x slab resident in shared memory
// would bound f.  BM = 128 with two consumer warpgroups; for bf16, BN = 128
// at two blocks per SM was faster on the H100 than BN = 256 at one block,
// where the epilogue (a compare-select top-2 push per score) and the
// rescore could not overlap the products.  No warp specialisation,
// persistence, clusters or TMA.
// The segment sum is bound by the latency of its in-order read-modify-write
// walk through L2; the scratch is capped by the caller.
//
// Sizes are int64 and row offsets 64-bit: n*f may pass 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;           // sample rows per block, 64 per warpgroup
constexpr int BN = 128;           // centroid columns per tile
constexpr int STAGES = 3;         // depth of the shared-memory ring
constexpr int THREADS = 256;      // two warpgroups
constexpr int ROW_BYTES = 128;    // one swizzled tile row: a feature chunk
constexpr int ATOM_BYTES = 8 * ROW_BYTES;
constexpr int KSTEP_BYTES = 32;   // depth of one wgmma: 16 bf16 or 8 tf32
constexpr int KSTEPS = ROW_BYTES / KSTEP_BYTES;
constexpr int TM = 8;             // rescore: rows per thread
constexpr float PAD_PENALTY = 1e30f;
constexpr float HALF_PAD = 5e29f; // fp32(PAD_PENALTY * 0.5), as the reference
constexpr int SEG_THREADS = 128;

// fp32 storage: x and the panel come as TF32 hi/lo pairs (3xTF32).
template <typename T>
constexpr bool SPLIT = std::is_same<T, float>::value;
// Blocks per SM: bf16 two (128 registers a thread), so that one block's
// epilogue and rescore overlap the other's products; fp32 one (its three
// accumulator sets take 222 registers).
template <typename T>
constexpr int MIN_BLOCKS = SPLIT<T> ? 1 : 2;

template <typename T>
struct Layout {
  static constexpr int X_BYTES = BM * ROW_BYTES;
  static constexpr int P_BYTES = BN * ROW_BYTES;
  // stage: x [x lo] panel [panel lo]
  static constexpr int STAGE_BYTES =
      SPLIT<T> ? 2 * (X_BYTES + P_BYTES) : X_BYTES + P_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (score, id) lexicographic order: lower score first, then lower id.
__device__ __forceinline__ bool lex_less(float s, int a, float t, int b) {
  return s < t || (s == t && a < b);
}

struct Top2 {
  float s1, s2;
  int a1, a2;
};

__device__ __forceinline__ void top2_push(Top2 &t, float s, int a) {
  if (lex_less(s, a, t.s1, t.a1)) {
    t.s2 = t.s1;
    t.a2 = t.a1;
    t.s1 = s;
    t.a1 = a;
  } else if (lex_less(s, a, t.s2, t.a2)) {
    t.s2 = s;
    t.a2 = a;
  }
}

// top2_push for ids that arrive in increasing order (an equal score never
// displaces the earlier, lower id), as selects: no divergent branches in
// the epilogue, which pushes every score.
__device__ __forceinline__ void top2_push_ascending(Top2 &t, float s, int a) {
  const bool lt1 = s < t.s1, lt2 = s < t.s2;
  t.s2 = lt1 ? t.s1 : (lt2 ? s : t.s2);
  t.a2 = lt1 ? t.a1 : (lt2 ? a : t.a2);
  t.s1 = lt1 ? s : t.s1;
  t.a1 = lt1 ? a : t.a1;
}

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma descriptor of a K-major operand in 128-byte swizzled rows (see the
// derivation at the top of the file).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(ATOM_BYTES >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void *src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's generic-proxy writes to shared memory (cp.async
// results, plain stores) before wgmma's async-proxy reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across the wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define KMT_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B^T for a 64 x 128 tile, one k-step of 16 bf16; scale_d = 0
// ignores d's old value.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : KMT_D8(0), KMT_D8(8), KMT_D8(16), KMT_D8(24), KMT_D8(32),
        KMT_D8(40), KMT_D8(48), KMT_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B^T for a 64 x 128 tile, one k-step of 8 tf32.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : KMT_D8(0), KMT_D8(8), KMT_D8(16), KMT_D8(24), KMT_D8(32),
        KMT_D8(40), KMT_D8(48), KMT_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef KMT_D8

// TF32 rounding, to nearest with ties away from zero; low 13 bits zero.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xffffe000u);
}

template <typename T>
struct Bits;
template <>
struct Bits<__nv_bfloat16> {
  using type = uint16_t;
};
template <>
struct Bits<float> {
  using type = uint32_t;
};

// Rows [r0, r0 + ROWS) x features [k0, k0 + 128 bytes) of a row-major
// (rows, f) matrix into a swizzled tile; rows past `rows` and features past
// f are zeros.  Thread t copies the 16-byte units t + e * THREADS.  `vec`:
// every row starts 16-byte aligned, so a unit is one cp.async (zero-fill
// past an edge); otherwise its elements are loaded one by one and stored.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t *tile,
                                          const T *__restrict__ src,
                                          int64_t rows, int64_t r0,
                                          int64_t k0, int64_t f, bool vec) {
  using B = typename Bits<T>::type;
  constexpr int EPU = 16 / sizeof(T);  // elements per 16-byte unit
  const uint32_t base = smem_addr(tile);
#pragma unroll
  for (int e = 0; e < ROWS * 8 / THREADS; ++e) {
    const int idx = threadIdx.x + e * THREADS;
    const int r = idx >> 3, u = idx & 7;
    const int64_t g = r0 + r, c = k0 + u * EPU;
    const int off = r * ROW_BYTES + ((u ^ (r & 7)) << 4);
    if (vec) {
      const bool ok = g < rows && c < f;
      cp_async16(base + off, ok ? src + g * f + c : src, ok ? 16 : 0);
    } else {
      const B *s = reinterpret_cast<const B *>(src);
      union {
        uint4 v;
        B b[EPU];
      } w;
#pragma unroll
      for (int j = 0; j < EPU; ++j)
        w.b[j] = (g < rows && c + j < f) ? s[g * f + c + j] : (B)0;
      *reinterpret_cast<uint4 *>(tile + off) = w.v;
    }
  }
}

// The x units this thread loaded (load_tile<float, BM>'s mapping): hi in
// place, lo into the x-lo tile at the same offset.
__device__ __forceinline__ void split_own_units(uint8_t *xs, uint8_t *xlo) {
#pragma unroll
  for (int e = 0; e < BM * 8 / THREADS; ++e) {
    const int idx = threadIdx.x + e * THREADS;
    const int r = idx >> 3, u = idx & 7;
    const int off = r * ROW_BYTES + ((u ^ (r & 7)) << 4);
    const float4 v = *reinterpret_cast<const float4 *>(xs + off);
    float4 hi, lo;
    hi.x = tf32_rna(v.x);
    hi.y = tf32_rna(v.y);
    hi.z = tf32_rna(v.z);
    hi.w = tf32_rna(v.w);
    lo.x = tf32_rna(v.x - hi.x);
    lo.y = tf32_rna(v.y - hi.y);
    lo.z = tf32_rna(v.z - hi.z);
    lo.w = tf32_rna(v.w - hi.w);
    *reinterpret_cast<float4 *>(xs + off) = hi;
    *reinterpret_cast<float4 *>(xlo + off) = lo;
  }
}

// One stage of products for this warpgroup's 64 rows.  bf16: into `acc`;
// `first`: the stage opens a centroid tile, so its first k-step overwrites
// the accumulators.  fp32 (3xTF32): the stage starts both afresh; x_hi.c_hi
// into `acc`, the small cross terms x_lo.c_hi + x_hi.c_lo into `lo`, so
// that no truncating tensor-core add of the large term meets the small ones.
template <typename T, int NA>
__device__ __forceinline__ void stage_mma(float (&acc)[NA], float (&lo)[NA],
                                          const uint8_t *stage, int wg,
                                          bool first) {
  using L = Layout<T>;
  const uint32_t xh = smem_addr(stage) + wg * 64 * ROW_BYTES;
  if constexpr (SPLIT<T>) {
    const uint32_t xl = xh + L::X_BYTES;
    const uint32_t ph = smem_addr(stage + 2 * L::X_BYTES);
    const uint32_t pl = ph + L::P_BYTES;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const int o = s * KSTEP_BYTES;
      wgmma_tf32(lo, gmma_desc(xl + o), gmma_desc(ph + o), s > 0);
      wgmma_tf32(lo, gmma_desc(xh + o), gmma_desc(pl + o), 1);
      wgmma_tf32(acc, gmma_desc(xh + o), gmma_desc(ph + o), s > 0);
    }
  } else {
    const uint32_t pb = smem_addr(stage + L::X_BYTES);
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s)
      wgmma_bf16(acc, gmma_desc(xh + s * KSTEP_BYTES),
                 gmma_desc(pb + s * KSTEP_BYTES), !(first && s == 0));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<T>)
assign_kernel(const T *__restrict__ x, const T *__restrict__ panel,
              const T *__restrict__ panel_lo, const float *__restrict__ c_sq,
              const float *__restrict__ ctab,
              const uint8_t *__restrict__ valid,
              const int32_t *__restrict__ prev, int32_t *__restrict__ aid_out,
              float *__restrict__ best_out, int32_t *__restrict__ changed,
              int64_t n, int64_t f, int64_t k, int cosine, int vec) {
  using L = Layout<T>;
  constexpr int BK = ROW_BYTES / sizeof(T);  // features per chunk
  extern __shared__ uint8_t smem_raw[];
  __shared__ int block_changed;
  uint8_t *ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  Top2 *tops = reinterpret_cast<Top2 *>(ring + L::RING_BYTES);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  // accumulator rows of this thread: frag_row + 8 * h
  const int frag_row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int quad = lane & 3;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  if (tid == 0) block_changed = 0;

  const int64_t n_kc = (f + BK - 1) / BK;
  const int64_t steps = n_kc * ((k + BN - 1) / BN);
  // the step the producer loads next: chunk ld_kc of the tile at ld_col0
  int64_t ld_t = 0, ld_kc = 0, ld_col0 = 0;
  int ld_slot = 0;
  auto load_next = [&]() {
    if (ld_t < steps) {
      uint8_t *stage = ring + ld_slot * L::STAGE_BYTES;
      const int64_t k0 = ld_kc * BK;
      load_tile<T, BM>(stage, x, n, row0, k0, f, vec);
      if constexpr (SPLIT<T>) {
        uint8_t *ph = stage + 2 * L::X_BYTES;
        load_tile<T, BN>(ph, panel, k, ld_col0, k0, f, vec);
        load_tile<T, BN>(ph + L::P_BYTES, panel_lo, k, ld_col0, k0, f, vec);
      } else {
        load_tile<T, BN>(stage + L::X_BYTES, panel, k, ld_col0, k0, f, vec);
      }
    }
    cp_async_commit();
    ++ld_t;
    if (++ld_kc == n_kc) {
      ld_kc = 0;
      ld_col0 += BN;
    }
    if (++ld_slot == STAGES) ld_slot = 0;
  };

  Top2 top[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    top[h].s1 = top[h].s2 = INFINITY;
    top[h].a1 = top[h].a2 = INT32_MAX;
  }
  // bf16: the current tile's products so far.  fp32: the current stage's
  // x_hi.c_hi (acc) and cross terms (lo), added to the tile's sums (sum)
  // in registers, rounded to nearest, in stage order
  float acc[BN / 2];
  float lo[BN / 2];
  float sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = lo[i] = sum[i] = 0.f;
  // s = csq + mult * prod: |c|^2 - 2 prod (L2) or -prod (cosine)
  const float mult = cosine ? -1.f : -2.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();
  int64_t kc = 0, col0 = 0;
  int slot = 0;
  for (int64_t t = 0; t < steps; ++t) {
    uint8_t *stage = ring + slot * L::STAGE_BYTES;
    cp_async_wait<STAGES - 2>();  // this thread's units of step t landed
    if constexpr (SPLIT<T>) split_own_units(stage, stage + L::X_BYTES);
    fence_proxy_async();
    __syncthreads();  // step t visible; every warpgroup done with t - 1
    load_next();      // step t + STAGES - 1, into the slot t - 1 used

    fence_regs(acc);
    if constexpr (SPLIT<T>) fence_regs(lo);
    wgmma_fence();
    stage_mma<T>(acc, lo, stage, wg, kc == 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if constexpr (SPLIT<T>) {
      fence_regs(lo);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sum[i] = kc == 0 ? acc[i] + lo[i] : sum[i] + (acc[i] + lo[i]);
    }

    if (kc == n_kc - 1) {
      // columns col0 + c, c < width, are centroids; the others score +inf
      // and never enter a list
      const int width = (int)(k - col0 < BN ? k - col0 : BN);
      const float *csq_tile = c_sq + col0;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = i * 8 + quad * 2 + j;
          const bool in = c < width;
          const float ld = __ldg(csq_tile + (in ? c : 0));
          const float csq = cosine ? 0.f : ld;
          const int id = (int)(col0 + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = i * 4 + h * 2 + j;
            const float p = SPLIT<T> ? sum[e] : acc[e];
            float sc = fmaf(mult, p, csq);
            sc = isfinite(sc) ? sc : PAD_PENALTY;
            top2_push_ascending(top[h], in ? sc : INFINITY, id);
          }
        }
      }
    }
    if (++kc == n_kc) {
      kc = 0;
      col0 += BN;
    }
    if (++slot == STAGES) slot = 0;
  }
  cp_async_wait<0>();

  // merge the quad's lists (ids are disjoint, so every lane ends with the
  // same pair) into the block's table
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float os1 = __shfl_xor_sync(0xffffffffu, top[h].s1, off);
      const float os2 = __shfl_xor_sync(0xffffffffu, top[h].s2, off);
      const int oa1 = __shfl_xor_sync(0xffffffffu, top[h].a1, off);
      const int oa2 = __shfl_xor_sync(0xffffffffu, top[h].a2, off);
      top2_push(top[h], os1, oa1);
      top2_push(top[h], os2, oa2);
    }
    if (quad == 0) tops[frag_row + 8 * h] = top[h];
  }
  __syncthreads();

  // exact rescore of the two candidates, 16 lanes per row: lane tx sums
  // the features tx, tx + 16, ... in that order
  const int tx = tid & 15;
  const int ty = tid >> 4;
  int my_changed = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const Top2 tp = tops[ty + 16 * i];
    const int64_t row = row0 + ty + 16 * i;
    const bool row_ok = row < n;
    const int a1 = tp.a1, a2 = tp.a2;
    const bool use_a = row_ok && a1 < k, use_b = row_ok && a2 < k;
    float pa = 0.f, pb = 0.f;
    for (int64_t c = tx; c < f; c += 16) {
      const float xv = row_ok ? to_f(x[row * f + c]) : 0.f;
      if (use_a) {
        const float d = xv - ctab[(int64_t)a1 * f + c];
        pa = fmaf(d, d, pa);
      }
      if (use_b) {
        const float d = xv - ctab[(int64_t)a2 * f + c];
        pb = fmaf(d, d, pb);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      pa += __shfl_xor_sync(0xffffffffu, pa, off);
      pb += __shfl_xor_sync(0xffffffffu, pb, off);
    }
    if (row_ok && tx == 0) {
      const float d2a = (a1 >= k || tp.s1 >= HALF_PAD) ? INFINITY : pa;
      const float d2b = (a2 >= k || tp.s2 >= HALF_PAD) ? INFINITY : pb;
      const bool take_b = d2b < d2a || (d2b == d2a && a2 < a1);
      int aid = take_b ? a2 : a1;
      if (!valid[row]) aid = (int)k;
      aid_out[row] = aid;
      best_out[row] = take_b ? tp.s2 : tp.s1;
      my_changed += aid != prev[row];
    }
  }
  __syncthreads();
  if (my_changed) atomicAdd(&block_changed, my_changed);
  __syncthreads();
  if (tid == 0 && block_changed) atomicAdd(changed, block_changed);
}

// Block (slab, p): thread column c walks rows [p * rows, (p + 1) * rows) in
// order and adds x[r, c] into part[aid[r], c]; part is this range's own
// (k, f) buffer, so no two threads ever touch one element.
template <typename T>
__global__ void __launch_bounds__(SEG_THREADS)
segment_partial_kernel(const T *__restrict__ x,
                       const int32_t *__restrict__ aid,
                       float *__restrict__ partial,
                       int32_t *__restrict__ counts, int64_t n, int64_t f,
                       int64_t k, int64_t rows) {
  const int64_t p = blockIdx.y;
  const int64_t c = (int64_t)blockIdx.x * SEG_THREADS + threadIdx.x;
  const int64_t r0 = p * rows;
  const int64_t r1 = r0 + rows < n ? r0 + rows : n;
  float *__restrict__ part = partial + p * k * f;
  if (blockIdx.x == 0) {
    for (int64_t r = r0 + threadIdx.x; r < r1; r += SEG_THREADS) {
      const int a = aid[r];
      if (a >= 0 && a < k) atomicAdd(&counts[a], 1);
    }
  }
  if (c >= f) return;
  for (int64_t a = 0; a < k; ++a) part[a * f + c] = 0.f;
  for (int64_t r = r0; r < r1; ++r) {
    const int a = aid[r];
    if (a >= 0 && a < k) part[(int64_t)a * f + c] += to_f(x[r * f + c]);
  }
}

__global__ void segment_reduce_kernel(const float *__restrict__ partial,
                                      float *__restrict__ sums,
                                      int64_t parts, int64_t kf) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kf) return;
  float s = 0.f;
  for (int64_t p = 0; p < parts; ++p) s += partial[p * kf + i];
  sums[i] = s;
}

template <typename T>
cudaError_t launch_assign(const void *x, const void *panel,
                          const void *panel_lo, const void *c_sq,
                          const void *ctab, const void *valid,
                          const void *prev, void *aid, void *best,
                          void *changed, int64_t n, int64_t f, int64_t k,
                          int64_t cosine, cudaStream_t stream) {
  using L = Layout<T>;
  constexpr int smem = L::RING_BYTES + BM * (int)sizeof(Top2) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      assign_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const auto aligned = [](const void *p) {
    return p == nullptr || (uintptr_t)p % 16 == 0;
  };
  // every row of x and of the panel 16-byte aligned
  const int vec = aligned(x) && aligned(panel) && aligned(panel_lo) &&
                  (f * (int64_t)sizeof(T)) % 16 == 0;
  const int64_t blocks = (n + BM - 1) / BM;
  assign_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T *)x, (const T *)panel, (const T *)panel_lo,
      (const float *)c_sq, (const float *)ctab, (const uint8_t *)valid,
      (const int32_t *)prev, (int32_t *)aid, (float *)best,
      (int32_t *)changed, n, f, k, (int)cosine, vec);
  return cudaGetLastError();
}

template <typename T>
void launch_segment(const void *x, const void *aid, void *partial, void *sums,
                    void *counts, int64_t n, int64_t f, int64_t k,
                    int64_t parts, cudaStream_t stream) {
  const int64_t rows = (n + parts - 1) / parts;
  // one range writes straight into `sums`; more go through `partial`
  float *target = parts == 1 ? (float *)sums : (float *)partial;
  dim3 grid((unsigned)((f + SEG_THREADS - 1) / SEG_THREADS), (unsigned)parts);
  segment_partial_kernel<T><<<grid, SEG_THREADS, 0, stream>>>(
      (const T *)x, (const int32_t *)aid, target, (int32_t *)counts, n, f, k,
      rows);
  if (parts > 1) {
    const int64_t kf = k * f;
    const int threads = 256;
    segment_reduce_kernel<<<(unsigned)((kf + threads - 1) / threads), threads,
                            0, stream>>>((const float *)partial,
                                         (float *)sums, parts, kf);
  }
}

}  // namespace

extern "C" {

// Scores, top-2 rescored argmin and reassignment count (B2).  fp32 storage
// passes the panel as its TF32 split (`panel` = hi, `panel_lo` = lo); bf16
// storage passes the bf16 panel and a null `panel_lo`.  `changed` must hold
// 0 on entry.  Returns the launch's CUDA error code.
int kmt_assign(const void *x, const void *panel, const void *panel_lo,
               const void *c_sq, const void *ctab, const void *valid,
               const void *prev, void *aid, void *best, void *changed,
               int64_t n, int64_t f, int64_t k, int64_t is_bf16,
               int64_t cosine, void *stream) {
  if (is_bf16)
    return (int)launch_assign<__nv_bfloat16>(
        x, panel, panel_lo, c_sq, ctab, valid, prev, aid, best, changed, n,
        f, k, cosine, (cudaStream_t)stream);
  return (int)launch_assign<float>(x, panel, panel_lo, c_sq, ctab, valid,
                                   prev, aid, best, changed, n, f, k, cosine,
                                   (cudaStream_t)stream);
}

// Segment sums (k, f) fp32 and counts (k,) int32 of x over `aid` (the rest
// of B1).  `counts` must hold 0 on entry; `partial` holds parts * k * f
// floats (unused when parts == 1).
int kmt_segment_sum(const void *x, const void *aid, void *partial, void *sums,
                    void *counts, int64_t n, int64_t f, int64_t k,
                    int64_t parts, int64_t is_bf16, void *stream) {
  if (is_bf16)
    launch_segment<__nv_bfloat16>(x, aid, partial, sums, counts, n, f, k,
                                  parts, (cudaStream_t)stream);
  else
    launch_segment<float>(x, aid, partial, sums, counts, n, f, k, parts,
                          (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

const char *kmt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
