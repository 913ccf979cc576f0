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
// TFLOP/s TF32) against n*f + k*f bytes of input: compute-bound.  The
// design streams both operands so that any f takes one path: the panel is
// re-read from L2 by every row block, (n / BM) * k * f * size bytes, and
// the x slab k / BN times; keeping the x slab resident in shared memory
// would bound f.  BM = 128 with two consumer warpgroups; for bf16, BN = 128
// at two blocks per SM was faster on the H100 than BN = 256 at one block,
// where the epilogue (a compare-select top-2 push per score) and the
// rescore could not overlap the products.  No warp specialisation,
// persistence, clusters or TMA.
//
// Sizes are int64 and row offsets 64-bit: n*f may pass 2^31.

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
  // s = csq + mult * prod: |c|^2 - 2 prod (L2) or -prod (cosine)
  const float mult = cosine ? -1.f : -2.f;

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

const char *kmt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
