// Lloyd assignment kernel for Hopper (sm_90a).
//
// Replaces the two Lloyd Pallas kernels of the JAX package:
//   kmcuda_tpu/ops/assign_pallas.py:_kernel             (fused_lloyd_pass, B1)
//   kmcuda_tpu/ops/assign_pallas.py:_kernel_assign_only (assign_only_pass, B2)
// B1 is this kernel followed by the segment sum of segment.cu.
//
// What it computes is the XLA path of the reference (ops/assign.py
// assign_pass + ops/distance.py scores/argmin_rescored), not the Pallas
// body: scores are clamped to PAD_PENALTY when non-finite, and the two best
// candidates are rescored exactly with the subtract-square distance.
//
// kmt_assign (B2, and the first half of B1): scores on the tensor cores.
// The streamed kernel (assign_kernel):
//   One block of two warpgroups owns BM = 128 sample rows (64 each) and
//   walks the centroid tiles of BN columns in order; for each tile it walks
//   the feature axis in chunks of 128 bytes (64 bf16 or 32 fp32 features).
//   A ring of shared-memory stages holds each chunk of x and of the panel,
//   filled by 16-byte cp.async with zero-fill past every edge (plain loads
//   where rows are not 16-byte aligned, as for odd f in bf16), and
//   `wgmma.mma_async` reads both operands from there, K-major, into fp32
//   accumulators in registers (tile layout and descriptors: hopper.cuh):
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
// What bounds it on the H100: the product, 2*n*k*f FLOP (three times that
// in TF32 for fp32 storage), on the tensor cores (989 TFLOP/s bf16, 495
// TFLOP/s TF32) against n*f + k*f bytes of input: compute-bound.  In
// practice the epilogue (a compare-select top-2 push per score, about ten
// instructions) and the L2 traffic set the pace.  kmt_assign takes one of
// two routes, chosen by the wrapper from the input alone
// (ops/assign_kernels.assign_route):
//
// The streamed route (assign_kernel, every input): the kernel above.  It
// streams both operands so that any f takes one path: every block of 128
// rows re-reads its x slab from L2 once per centroid tile and the panel
// once, and a wgmma_wait_all after every 64-feature stage leaves no product
// in flight during a tile's epilogue or the block's rescore.  bf16 at
// 8M x 256, k = 1024 moves about 86 GB from L2 to the SMs a launch: x 8 x
// 4.1 GB, the panel 62,500 blocks x 512 KB = 33 GB, the rescore's fp32
// centroid rows 16 GB and x once more.
//
// The persistent route (assign_kernel_ws, bf16 with 64 <= f <= 256 and
// 16-byte aligned rows): one block per SM walks row tiles of WS_BM = 192
// rows in a fixed stride; 512 threads in three roles.
//   - A producer warp streams, by TMA (128-byte swizzle, zero fill past
//     every edge), the panel's 16 KB chunks (128 centroids x 64 features)
//     through a ring of as many stages as shared memory holds (7 at f =
//     256), and each row tile's x once, chunk by chunk, into one resident
//     buffer: a chunk is refilled as soon as the row tile before is done
//     with it.  The resident x tile is what bounds f: NKC = ceil(f / 64) <=
//     4 chunks of 24 KB.
//   - Three consumer warpgroups, 64 rows each, run the same m64n128k16
//     chain per centroid tile as the streamed kernel (from zero, the same
//     k-steps in the same feature order) into one accumulator set each,
//     taking turns to send their products out (named barriers), so that
//     while one pushes an item's scores into its rows' lists (push_tile_ws:
//     the same score per column; four lists a thread, merged by (score, id)
//     at the row tile's end, so the pair is push_tile's), the tensor cores
//     run the other two's products; the quad merge writes each row tile's
//     lists to one of TABLES tables.
//   - Three rescore warps take each table as it fills: the same exact
//     rescore, 16 lanes a row, against the fp32 table; x from global
//     memory, since its resident chunks already hold the next row tile.
//   Same bits as the streamed route: aid, best and changed, for any row
//   subset.  L2 to the SMs at 8M x 256, k = 1024: the panel 41,667 row tiles
//   x 512 KB = 22 GB, x 4.1 GB once by TMA and once by the rescore, the
//   rescore's centroid rows 16 GB: about 46 GB.  At 512 threads a thread
//   has 128 registers (a second accumulator set, to overlap a warpgroup's
//   own epilogue, would not fit beside three warpgroups); three consumer
//   warps a scheduler hide the epilogue's latency, which, not the tensor
//   cores, sets the pace.  No clusters, no multicast, no setmaxnreg (ptxas
//   allocated no more than the launch's registers to a consumer that
//   raised its count).
//
// Sizes are int64 and row offsets 64-bit: n*f may pass 2^31.

#include <cuda.h>  // CUtensorMap and its encoder's types; no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;           // sample rows per block, 64 per warpgroup
constexpr int BN = 128;           // centroid columns per tile
constexpr int STAGES = 3;         // depth of the shared-memory ring
constexpr int THREADS = 256;      // two warpgroups
constexpr int TM = 8;             // rescore: rows per thread
constexpr float PAD_PENALTY = 1e30f;
constexpr float HALF_PAD = 5e29f; // fp32(PAD_PENALTY * 0.5), as the reference

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

// Epilogue of one centroid tile of BN columns from col0, from this thread's
// accumulator fragment p (rows lane/4 and lane/4 + 8 of its warp's 16, BN/4
// columns): s = |c|^2 - 2 prod (L2) or -prod (cosine), non-finite ->
// PAD_PENALTY, pushed into the running top 2 of each of the two rows in
// ascending column order.  Columns past k score +inf and never enter a list.
__device__ __forceinline__ void push_tile(Top2 (&top)[2],
                                          const float (&p)[BN / 2],
                                          const float *__restrict__ c_sq,
                                          int64_t col0, int64_t k, int quad,
                                          int cosine) {
  // s = csq + mult * prod
  const float mult = cosine ? -1.f : -2.f;
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
        float sc = fmaf(mult, p[i * 4 + h * 2 + j], csq);
        sc = isfinite(sc) ? sc : PAD_PENALTY;
        top2_push_ascending(top[h], in ? sc : INFINITY, id);
      }
    }
  }
}

// Merges the lists of a quad's four lanes (ids are disjoint, so every lane
// ends with the same pair).
__device__ __forceinline__ void merge_quad(Top2 (&top)[2]) {
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
  }
}

// A row's result from its two candidates' exact squared distances pa, pb:
// writes its id (k when the row is invalid) and best score; returns 1 when
// the id differs from `prev`.
__device__ __forceinline__ int pick(const Top2 &tp, float pa, float pb,
                                    int64_t k, bool valid, int32_t prev,
                                    int32_t *aid_out, float *best_out) {
  const float d2a = (tp.a1 >= k || tp.s1 >= HALF_PAD) ? INFINITY : pa;
  const float d2b = (tp.a2 >= k || tp.s2 >= HALF_PAD) ? INFINITY : pb;
  const bool take_b = d2b < d2a || (d2b == d2a && tp.a2 < tp.a1);
  int aid = take_b ? tp.a2 : tp.a1;
  if (!valid) aid = (int)k;
  *aid_out = aid;
  *best_out = take_b ? tp.s2 : tp.s1;
  return aid != prev;
}

// top2_push_ascending with the scores' new values as min / max, off the
// predicates' path: the same values and ids for any score that is neither
// NaN nor -0, which no score is (a finite fmaf(mult, prod, csq) with csq
// >= +0 never rounds to -0, and PAD_PENALTY and +inf are positive).
__device__ __forceinline__ void top2_push_minmax(Top2 &t, float s, int a) {
  const bool lt1 = s < t.s1, lt2 = s < t.s2;
  t.a2 = lt1 ? t.a1 : (lt2 ? a : t.a2);
  t.a1 = lt1 ? a : t.a1;
  t.s2 = fminf(fmaxf(s, t.s1), t.s2);
  t.s1 = fminf(s, t.s1);
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
      load_tile<T, BM, THREADS>(stage, x, n, row0, k0, f, vec);
      if constexpr (SPLIT<T>) {
        uint8_t *ph = stage + 2 * L::X_BYTES;
        load_tile<T, BN, THREADS>(ph, panel, k, ld_col0, k0, f, vec);
        load_tile<T, BN, THREADS>(ph + L::P_BYTES, panel_lo, k, ld_col0, k0,
                                  f, vec);
      } else {
        load_tile<T, BN, THREADS>(stage + L::X_BYTES, panel, k, ld_col0, k0,
                                  f, vec);
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
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();
  int64_t kc = 0, col0 = 0;
  int slot = 0;
  for (int64_t t = 0; t < steps; ++t) {
    uint8_t *stage = ring + slot * L::STAGE_BYTES;
    cp_async_wait<STAGES - 2>();  // this thread's units of step t landed
    if constexpr (SPLIT<T>)
      split_own_units<BM, THREADS>(stage, stage + L::X_BYTES);
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
      if constexpr (SPLIT<T>)
        push_tile(top, sum, c_sq, col0, k, quad, cosine);
      else
        push_tile(top, acc, c_sq, col0, k, quad, cosine);
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
  merge_quad(top);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (quad == 0) tops[frag_row + 8 * h] = top[h];
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
    if (row_ok && tx == 0)
      my_changed += pick(tp, pa, pb, k, valid[row], prev[row], aid_out + row,
                         best_out + row);
  }
  __syncthreads();
  if (my_changed) atomicAdd(&block_changed, my_changed);
  __syncthreads();
  if (tid == 0 && block_changed) atomicAdd(changed, block_changed);
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

// ---- The persistent route: bf16, 64 <= f <= 256, 16-byte aligned rows ----

// warps 0-11: three consumer warpgroups; warp 12: the producer; warps
// 13-15: the rescore
constexpr int WS_CONSUMERS = 3;
constexpr int WS_BM = 64 * WS_CONSUMERS;  // rows of a row tile
constexpr int WS_THREADS = 512;
constexpr int PRODUCER_TID = 128 * WS_CONSUMERS;
constexpr int RESCORE_TID = PRODUCER_TID + 32;
constexpr int RESCORE_GROUPS = (WS_THREADS - RESCORE_TID) / 16;
constexpr int X_CHUNK = WS_BM * ROW_BYTES;  // 192 rows of 64 bf16: 24 KB
constexpr int P_CHUNK = BN * ROW_BYTES;     // 128 centroids of 64: 16 KB
constexpr int SMEM_PER_BLOCK = 232448;      // the H100's opt-in maximum

// Shared memory of the persistent kernel for NKC 64-feature chunks: the
// row tile's x (one buffer, refilled chunk by chunk), a ring of panel
// chunks (as many stages as fit), TABLES top-2 tables, the mbarriers.
constexpr int TABLES = 4;
template <int NKC>
struct WsLayout {
  static constexpr int X_BYTES = NKC * X_CHUNK;
  static constexpr int TOPS_BYTES = TABLES * WS_BM * (int)sizeof(Top2);
  static constexpr int BAR_BYTES = 512;
  static constexpr int STAGES =
      (SMEM_PER_BLOCK - 1024 - X_BYTES - TOPS_BYTES - BAR_BYTES) / P_CHUNK;
  static constexpr int SMEM =
      1024 + X_BYTES + STAGES * P_CHUNK + TOPS_BYTES + BAR_BYTES;
  static_assert(STAGES > NKC, "a ring stage beyond one tile's chunks");
  static_assert((2 * STAGES + 2 * NKC + 2 * TABLES) * 8 + 4 <= BAR_BYTES,
                "barrier region");
  // rescore: rows a 16-lane group has in flight (12 NKC loads a row),
  // within the 128 registers a thread has at 512 threads
  static constexpr int RROWS = NKC >= 3 ? 2 : NKC == 2 ? 3 : 4;
};

// Epilogue of one centroid tile for the persistent kernel: the same score
// per column as push_tile (fmaf(mult, prod, csq), non-finite ->
// PAD_PENALTY, +inf past k; c_sq comes padded to a multiple of BN
// columns), computed for the whole fragment first, then
// pushed into four running lists a thread, top[h][i & 1]: its two rows by
// the tile's even and odd 8-column groups, each fed ascending ids.  Four
// short chains instead of two long ones; merged in lexicographic order at
// the row tile's end (finish_lists), they give push_tile's pair: the two
// lowest (score, id).
__device__ __forceinline__ void push_tile_ws(Top2 (&top)[2][2],
                                             float (&p)[BN / 2],
                                             const float *__restrict__ c_sq,
                                             int col0, int width,
                                             int quad, int cosine) {
  const float mult = cosine ? -1.f : -2.f;
  const float *csq_tile = c_sq + col0 + quad * 2;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const float2 ld =
        __ldg(reinterpret_cast<const float2 *>(csq_tile + i * 8));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float csq = j ? ld.y : ld.x;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = i * 4 + h * 2 + j;
        const float sc = fmaf(mult, p[e], csq);
        p[e] = isfinite(sc) ? sc : PAD_PENALTY;
      }
    }
  }
  if (width < BN) {
    // the last tile's columns past k score +inf and never enter a list
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (i * 8 + quad * 2 + j >= width) p[i * 4 + h * 2 + j] = INFINITY;
  }
  // each group of four consecutive pushes goes to four different lists
  const int id0 = col0 + quad * 2;
#pragma unroll
  for (int i = 0; i < BN / 8; i += 2)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          top2_push_minmax(top[h][g], p[(i + g) * 4 + h * 2 + j],
                           id0 + (i + g) * 8 + j);
}

// The persistent kernel's shared memory, from its 1024-byte aligned base:
// one pointer, every part at a fixed offset.  Its mbarriers: per ring stage
// full (the producer's bytes) and empty (the 12 consumer warps); per x
// chunk xfull (its bytes) and xempty (the 12 consumer warps, once the row
// tile's last products are complete); per table b of row tile t (b = t %
// TABLES) tfull (the 384 consumer threads, once the row tile's lists are
// in it) and rdone (the 96 rescore threads, once they are done with it).
template <int NKC>
struct WsSmem {
  using L = WsLayout<NKC>;
  static constexpr int STAGES = L::STAGES;
  static constexpr int TOPS_OFF = L::X_BYTES + STAGES * P_CHUNK;
  static constexpr int BAR_OFF = TOPS_OFF + L::TOPS_BYTES;
  uint8_t *base;
  __device__ __forceinline__ uint8_t *x(int c) const {
    return base + c * X_CHUNK;
  }
  __device__ __forceinline__ uint8_t *ring(int s) const {
    return base + L::X_BYTES + s * P_CHUNK;
  }
  __device__ __forceinline__ Top2 *tops(int b) const {
    return reinterpret_cast<Top2 *>(base + TOPS_OFF) + b * WS_BM;
  }
  __device__ __forceinline__ uint64_t *bar(int i) const {
    return reinterpret_cast<uint64_t *>(base + BAR_OFF) + i;
  }
  __device__ __forceinline__ uint64_t *full(int s) const { return bar(s); }
  __device__ __forceinline__ uint64_t *empty(int s) const {
    return bar(STAGES + s);
  }
  __device__ __forceinline__ uint64_t *xfull(int c) const {
    return bar(2 * STAGES + c);
  }
  __device__ __forceinline__ uint64_t *xempty(int c) const {
    return bar(2 * STAGES + NKC + c);
  }
  __device__ __forceinline__ uint64_t *tfull(int b) const {
    return bar(2 * STAGES + 2 * NKC + b);
  }
  __device__ __forceinline__ uint64_t *rdone(int b) const {
    return bar(2 * STAGES + 2 * NKC + TABLES + b);
  }
  __device__ __forceinline__ int *block_changed() const {
    return reinterpret_cast<int *>(bar(2 * STAGES + 2 * NKC + 2 * TABLES));
  }
};

// A consumer warpgroup of the persistent kernel: 64 rows of each row tile
// (rows 64 cw ..), every centroid tile in order, one accumulator set.
// Item q is row tile q / nct (of this block's) against centroid tile
// q % nct.  The three warpgroups send their products out in turn, so that
// while one pushes an item's scores into its lists, the tensor cores run
// the others' products.  All members are registers once inlined.
template <int NKC>
struct WsConsumer {
  using L = WsLayout<NKC>;
  static constexpr int STAGES = L::STAGES;
  WsSmem<NKC> sm;
  const float *__restrict__ c_sq;
  int k, cosine, nct, cw, lane, quad, frag_row;
  int s = 0, rel = 0;  // ring stage consumed next, released next
  uint32_t ph = 0;
  int t = 0, j = 0;    // the item in hand
  Top2 top[2][2];

  __device__ __forceinline__ void reset_top() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        top[h][g].s1 = top[h][g].s2 = INFINITY;
        top[h][g].a1 = top[h][g].a2 = INT32_MAX;
      }
  }

  // The item's products into acc, in this warpgroup's turn (named barrier
  // 2 + cw): per chunk, four k-steps of m64n128k16, the tile's first from
  // zero, in feature order; the first item of a row tile waits for each x
  // chunk's refill.  `pass`: hand the turn on.
  __device__ __forceinline__ void issue(float (&acc)[BN / 2], bool pass) {
    named_sync(2 + cw, 256);
    const uint32_t xa = smem_addr(sm.x(0)) + cw * 64 * ROW_BYTES;
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      if (j == 0) mbar_wait(sm.xfull(c), (uint32_t)(t & 1));
      mbar_wait(sm.full(s), ph);
      const uint32_t pa = smem_addr(sm.ring(s));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint64_t da = gmma_desc(xa + c * X_CHUNK + ks * KSTEP_BYTES);
        const uint64_t db = gmma_desc(pa + ks * KSTEP_BYTES);
        if (c == 0 && ks == 0)
          wgmma_bf16_first(acc, da, db);
        else
          wgmma_bf16(acc, da, db, 1);
      }
      wgmma_commit();
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    if (pass) named_arrive(2 + (cw + 1) % WS_CONSUMERS, 256);
  }

  // Once the item's products are complete: its ring stages go back, and
  // where it ends its row tile, the x chunks; then its scores go into the
  // lists, and at the row tile's end the lists go to a table.
  __device__ __forceinline__ void finish(float (&acc)[BN / 2]) {
    wgmma_wait_all();
    for (int c = 0; c < NKC; ++c) {
      if (lane == 0) mbar_arrive(sm.empty(rel));
      if (++rel == STAGES) rel = 0;
    }
    if (j == nct - 1 && lane == 0)
      for (int c = 0; c < NKC; ++c) mbar_arrive(sm.xempty(c));
    fence_regs(acc);
    const int col0 = j * BN;
    const int width = k - col0 < BN ? k - col0 : BN;
    push_tile_ws(top, acc, c_sq, col0, width, quad, cosine);
    if (++j == nct) {
      j = 0;
      finish_lists(t++);
    }
  }

  // each row's four lists merged into one, then the quad's (ids are
  // disjoint, so every lane ends with the same pair), into table t %
  // TABLES once the rescore of row tile t - TABLES is done with it
  __device__ __forceinline__ void finish_lists(int t) {
    Top2 m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = top[h][0];
      top2_push(m[h], top[h][1].s1, top[h][1].a1);
      top2_push(m[h], top[h][1].s2, top[h][1].a2);
    }
    merge_quad(m);
    const int b = t % TABLES;
    mbar_wait(sm.rdone(b), (uint32_t)((t / TABLES) & 1) ^ 1);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (quad == 0) sm.tops(b)[frag_row + 8 * h] = m[h];
    mbar_arrive(sm.tfull(b));
    reset_top();
  }
};

// The rescore warps: for each row tile, once its lists are in a table,
// the exact rescore of every row's two candidates against the fp32 table,
// 16 lanes a row, lane tx summing the features tx, tx + 16, ... in that
// order; x comes from global memory (the resident chunks are refilled as
// soon as the row tile's products are done); RROWS rows a 16-lane group in
// flight.  Returns this thread's count of reassigned rows.
template <int NKC, bool FULL>
__device__ __forceinline__ int rescore_tiles(
    const __nv_bfloat16 *__restrict__ x, WsSmem<NKC> sm,
    const float *__restrict__ ctab, const uint8_t *__restrict__ valid,
    const int32_t *__restrict__ prev, int32_t *__restrict__ aid_out,
    float *__restrict__ best_out, int64_t n, int64_t f, int64_t k,
    int64_t my_tiles) {
  using L = WsLayout<NKC>;
  constexpr int R = L::RROWS;
  constexpr int PER = RESCORE_GROUPS * R;  // rows the groups take at once
  constexpr int FL = NKC * 4;              // features a lane sums
  const int rt = threadIdx.x - RESCORE_TID;
  const int g = rt >> 4, tx = rt & 15;
  int my_changed = 0;
  for (int64_t t = 0; t < my_tiles; ++t) {
    const int b = (int)(t % TABLES);
    mbar_wait(sm.tfull(b), (uint32_t)((t / TABLES) & 1));
    const int64_t row0 = ((int64_t)blockIdx.x + t * gridDim.x) * WS_BM;
    // the same number of rounds in every group, so the shuffles converge
    for (int r0 = g; r0 - g < WS_BM; r0 += PER) {
      // every load unconditional, from a clamped address, so that all of
      // them are in flight before the first use; the arithmetic below
      // reads only what the row's flags allow
      Top2 tp[R];
      float ca[R][FL], cb[R][FL];
      __nv_bfloat16 xv[R][FL];
      uint8_t vrow[R];
      int32_t prow[R];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int r = r0 + RESCORE_GROUPS * m;
        tp[m] = sm.tops(b)[r < WS_BM ? r : 0];
        const int64_t row = r < WS_BM && row0 + r < n ? row0 + r : 0;
        const __nv_bfloat16 *xr = x + row * f;
        const float *pa = ctab + (tp[m].a1 < k ? tp[m].a1 : k) * f;
        const float *pb = ctab + (tp[m].a2 < k ? tp[m].a2 : k) * f;
        vrow[m] = valid[row];
        prow[m] = prev[row];
#pragma unroll
        for (int i = 0; i < FL; ++i) {
          // FULL: f is 64 NKC, every feature a lane reads is in its row
          const int c = FULL ? tx + 16 * i : (tx + 16 * i < f ? tx + 16 * i
                                                                : 0);
          xv[m][i] = xr[c];
          ca[m][i] = __ldg(pa + c);
          cb[m][i] = __ldg(pb + c);
        }
      }
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int r = r0 + RESCORE_GROUPS * m;
        const int64_t row = row0 + r;
        const bool row_ok = r < WS_BM && row < n;
        const bool use_a = row_ok && tp[m].a1 < k;
        const bool use_b = row_ok && tp[m].a2 < k;
        // with FULL every sum runs whole (a sum of a row or candidate that
        // does not count is never read: pick sees a >= k, or no row)
        float pa = 0.f, pb = 0.f;
#pragma unroll
        for (int i = 0; i < FL; ++i) {
          const float xf = to_f(xv[m][i]);
          const float da = xf - ca[m][i], db = xf - cb[m][i];
          if (FULL) {
            pa = fmaf(da, da, pa);
            pb = fmaf(db, db, pb);
          } else if (tx + 16 * i < f) {
            if (use_a) pa = fmaf(da, da, pa);
            if (use_b) pb = fmaf(db, db, pb);
          }
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          pa += __shfl_xor_sync(0xffffffffu, pa, off);
          pb += __shfl_xor_sync(0xffffffffu, pb, off);
        }
        if (row_ok && tx == 0)
          my_changed += pick(tp[m], pa, pb, k, vrow[m] != 0, prow[m],
                             aid_out + row, best_out + row);
      }
    }
    mbar_arrive(sm.rdone(b));
  }
  return my_changed;
}

template <int NKC>
__global__ void __launch_bounds__(WS_THREADS, 1)
assign_kernel_ws(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap panel_map,
                 const __nv_bfloat16 *__restrict__ x,
                 const float *__restrict__ c_sq,
                 const float *__restrict__ ctab,
                 const uint8_t *__restrict__ valid,
                 const int32_t *__restrict__ prev,
                 int32_t *__restrict__ aid_out, float *__restrict__ best_out,
                 int32_t *__restrict__ changed, int64_t n, int64_t f,
                 int64_t k, int cosine) {
  using L = WsLayout<NKC>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  WsSmem<NKC> sm;
  sm.base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 4 * WS_CONSUMERS);
    }
    for (int c = 0; c < NKC; ++c) {
      mbar_init(sm.xfull(c), 1);
      mbar_init(sm.xempty(c), 4 * WS_CONSUMERS);
    }
    for (int b = 0; b < TABLES; ++b) {
      mbar_init(sm.tfull(b), 128 * WS_CONSUMERS);
      mbar_init(sm.rdone(b), WS_THREADS - RESCORE_TID);
    }
    *sm.block_changed() = 0;
    fence_mbar_init();
  }
  __syncthreads();

  // this block's row tiles: blockIdx.x + t * gridDim.x, t < my_tiles
  const int64_t n_tiles = (n + WS_BM - 1) / WS_BM;
  const int64_t my_tiles =
      (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int nct = (int)((k + BN - 1) / BN);  // centroid tiles

  // warp-uniform as the compiler sees it: the consumers' branch holds
  // wgmma, which needs converged warps
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (warp < 4 * WS_CONSUMERS) {
    WsConsumer<NKC> w;
    w.sm = sm;
    w.c_sq = c_sq;
    w.k = (int)k;
    w.cosine = cosine;
    w.nct = nct;
    w.cw = warp >> 2;
    w.lane = tid & 31;
    w.quad = w.lane & 3;
    // accumulator rows of this thread in the row tile: frag_row + 8 * h
    w.frag_row = w.cw * 64 + (warp & 3) * 16 + (w.lane >> 2);
    w.reset_top();
    // the turns go 0, 1, 2, 0, ...: the last warpgroup opens the first,
    // and hands on none after its last item
    const int64_t n_items = my_tiles * nct;
    if (w.cw == WS_CONSUMERS - 1) named_arrive(2, 256);
    float acc[BN / 2];
    for (int64_t q = 0; q < n_items; ++q) {
      w.issue(acc, w.cw < WS_CONSUMERS - 1 || q + 1 < n_items);
      w.finish(acc);
    }
  } else if (warp == 4 * WS_CONSUMERS) {
    // the producer: one thread streams the panel chunks in the consumers'
    // order, and each x chunk of the next row tile as soon as the row
    // tile before is done with it, whichever is free first
    if (tid == PRODUCER_TID) {
      int64_t xt = 0;  // the x chunk sent next: chunk xc of row tile xt
      int xc = 0;
      const auto send_x = [&]() {
        mbar_expect_tx(sm.xfull(xc), X_CHUNK);
        tma_load_2d(sm.x(xc), &x_map, sm.xfull(xc), xc * 64,
                    (int)(((int64_t)blockIdx.x + xt * gridDim.x) * WS_BM));
        if (++xc == NKC) {
          xc = 0;
          ++xt;
        }
      };
      const auto x_free = [&]() {
        return xt < my_tiles &&
               mbar_test(sm.xempty(xc), (uint32_t)(xt & 1) ^ 1);
      };
      int s = 0;
      uint32_t ph = 0;
      for (int64_t t = 0; t < my_tiles; ++t)
        for (int j = 0; j < nct; ++j)
          for (int c = 0; c < NKC; ++c) {
            do {
              while (x_free()) send_x();
            } while (!mbar_try_wait(sm.empty(s), ph ^ 1));
            mbar_expect_tx(sm.full(s), P_CHUNK);
            tma_load_2d(sm.ring(s), &panel_map, sm.full(s),
                        c * 64, j * BN);
            if (++s == STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
      while (xt < my_tiles) {
        mbar_wait(sm.xempty(xc), (uint32_t)(xt & 1) ^ 1);
        send_x();
      }
    }
  } else {
    const int mine =
        f == 64 * NKC
            ? rescore_tiles<NKC, true>(x, sm, ctab, valid, prev,
                                       aid_out, best_out, n, f, k, my_tiles)
            : rescore_tiles<NKC, false>(x, sm, ctab, valid, prev,
                                        aid_out, best_out, n, f, k,
                                        my_tiles);
    if (mine) atomicAdd(sm.block_changed(), mine);
    named_sync(1, WS_THREADS - RESCORE_TID);
    if (tid == RESCORE_TID && *sm.block_changed())
      atomicAdd(changed, *sm.block_changed());
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library links without -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap *, CUtensorMapDataType,
                                 cuuint32_t, void *, const cuuint64_t *,
                                 const cuuint64_t *, const cuuint32_t *,
                                 const cuuint32_t *, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void *p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major (rows, f) bf16 matrix as boxes of box_rows rows x 64
// features, 128-byte swizzled, zeros past its edges.
cudaError_t encode_rows(CUtensorMap *map, const void *ptr, int64_t rows,
                        int64_t f, uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)f, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)f * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void *>(ptr),
      dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NKC>
cudaError_t launch_ws(const void *x, const void *panel, const void *c_sq,
                      const void *ctab, const void *valid, const void *prev,
                      void *aid, void *best, void *changed, int64_t n,
                      int64_t f, int64_t k, int64_t cosine,
                      cudaStream_t stream) {
  using L = WsLayout<NKC>;
  CUtensorMap x_map, panel_map;
  cudaError_t err = encode_rows(&x_map, x, n, f, WS_BM);
  if (err == cudaSuccess) err = encode_rows(&panel_map, panel, k, f, BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(assign_kernel_ws<NKC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + WS_BM - 1) / WS_BM;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  assign_kernel_ws<NKC><<<grid, WS_THREADS, L::SMEM, stream>>>(
      x_map, panel_map, (const __nv_bfloat16 *)x, (const float *)c_sq,
      (const float *)ctab,
      (const uint8_t *)valid, (const int32_t *)prev, (int32_t *)aid,
      (float *)best, (int32_t *)changed, n, f, k, (int)cosine);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scores, top-2 rescored argmin and reassignment count (B2).  fp32 storage
// passes the panel as its TF32 split (`panel` = hi, `panel_lo` = lo); bf16
// storage passes the bf16 panel and a null `panel_lo`.  `changed` must hold
// 0 on entry.  `route` 0 is the streamed kernel; 1 the persistent one,
// which takes bf16 with 64 <= f <= 256 and 16-byte aligned rows only, and
// `c_sq` padded to a multiple of 128 entries (zeros for cosine).  Returns
// the launch's CUDA error code (cudaErrorInvalidValue for a route the
// input does not fit).
int kmt_assign(const void *x, const void *panel, const void *panel_lo,
               const void *c_sq, const void *ctab, const void *valid,
               const void *prev, void *aid, void *best, void *changed,
               int64_t n, int64_t f, int64_t k, int64_t is_bf16,
               int64_t cosine, int64_t route, void *stream) {
  if (route == 1) {
    // the persistent route takes only what it was built for
    if (!is_bf16 || f < 64 || f > 256 || f % 8 != 0 ||
        (uintptr_t)x % 16 != 0 || (uintptr_t)panel % 16 != 0 ||
        (uintptr_t)c_sq % 8 != 0)
      return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch ((f + 63) / 64) {
      case 1:
        return (int)launch_ws<1>(x, panel, c_sq, ctab, valid, prev, aid, best,
                                 changed, n, f, k, cosine, s);
      case 2:
        return (int)launch_ws<2>(x, panel, c_sq, ctab, valid, prev, aid, best,
                                 changed, n, f, k, cosine, s);
      case 3:
        return (int)launch_ws<3>(x, panel, c_sq, ctab, valid, prev, aid, best,
                                 changed, n, f, k, cosine, s);
      default:
        return (int)launch_ws<4>(x, panel, c_sq, ctab, valid, prev, aid, best,
                                 changed, n, f, k, cosine, s);
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_assign<__nv_bfloat16>(
        x, panel, panel_lo, c_sq, ctab, valid, prev, aid, best, changed, n,
        f, k, cosine, (cudaStream_t)stream);
  return (int)launch_assign<float>(x, panel, panel_lo, c_sq, ctab, valid,
                                   prev, aid, best, changed, n, f, k, cosine,
                                   (cudaStream_t)stream);
}

const char *kmt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
