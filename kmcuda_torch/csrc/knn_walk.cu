// Pruned kNN walk kernel for Hopper (sm_90a).
//
// Replaces the kNN walk Pallas kernel of the JAX package:
//   kmcuda_tpu/ops/knn_pallas.py:_kernel (walk, B3; merge _extract_k)
//
// kmt_knn_walk, one block per query chunk (the TPU's one program per
// chunk).  The block reads its own tour (tile order, sorted bounds, step
// bound) and walks it: step r covers the `group` tiles
// tile_order[r*group ...] and runs only while bound[r*group] <= tau and the
// bound is below STOP_BOUND; tau is the max over the chunk of the running
// buffer's column kn - 1, recomputed after each step, so tau moves at step
// granularity as in the reference and the examined count matches it.  For
// each step the members stream in sub-tiles of BN = 64 rows against the
// chunk's queries in panels of PANEL = 256 rows, and the dot products of a
// (panel, sub-tile) pair run on the tensor cores (below), into a (BN x 256)
// shared block.  Each thread then owns one query row: it turns the dots
// into true distances (L2 sqrt(max(|m|^2 - 2 dot + |q|^2, 0)); cosine
// acos(clip(dot)) in fp32 storage, and in bf16 storage the angle of that
// same L2 chord, 2 asin(min(t / 2, 1)), the measure of the exact rescore:
// bf16 rows of unit vectors are not of unit norm, and for near neighbours
// the angle of the dot is mostly that rounding), applies the (1 + SLACK)
// margin and the bf16 envelope (to the chord, before the angle),
// masks self and padding to +inf, and inserts a candidate into its row of
// the sorted (distance, id) buffer only if it is lexicographically below
// the current kk-th entry — so a masked member (+inf, id >= 0) never
// displaces the (+inf, -1) sentinel.  The buffer (column-major per chunk,
// conflict-free) sits in shared memory when kk * chunk fits, else in a
// global scratch; there is no kk bound.  Invalid query rows start at -inf
// and are never updated, so they never raise tau.  Each active step adds
// sum(tile_nvalid of its tiles) * n_qvalid to the chunk's int64 examined
// count.
//
// Products (the machinery of assign.cu, from hopper.cuh): the panel is the
// M side, two warpgroups of 128 rows (two m64 tiles each), the sub-tile the
// N side (m64n64).  Both stream through a 2-stage ring of 128-byte-swizzled
// K-major tiles, one 128-byte feature chunk (32 fp32 or 64 bf16 features)
// a stage, filled by cp.async (plain loads where rows are not 16-byte
// aligned) with zero-fill past every edge:
// - bf16 storage: m64n64k16 f32.bf16.bf16; products of bf16 values are
//   exact in fp32, as the reference's default-precision bf16 walk.  Each
//   stage starts a fresh accumulator, and the stage sums are added in
//   registers, rounded to nearest.
// - fp32 storage: 3xTF32 (the reference's Precision.HIGHEST), each thread
//   splitting the query and member units it loaded into TF32 hi and lo
//   once they land; per stage q_lo.m_hi + q_hi.m_lo and q_hi.m_hi go into
//   separate fresh accumulators (m64n64k8 f32.tf32.tf32), and the stage
//   sums are added in registers, rounded to nearest, as kmt_assign does.
//   Single-pass TF32 is never used.
// The accumulator fragments are stored to the dots block, which aliases the
// ring (idle once a pair's products are done); the per-row epilogue then
// reads it as before.  Shared memory, fp32: a stage holds 256 query rows
// and 64 member rows, each as hi and lo, at 128 bytes: (512 + 128) * 128 B
// = 80 KB; two stages 160 KB; the dots block (64 x 260 fp32, 65 KB) fits
// in the ring; with the member norms and positions and 1 KB of alignment
// 161.5 KB, leaving 65.5 KB of the 227 KB for the buffer (kk * chunk * 8
// bytes; 64 KB at kk = 32, chunk = 256).  bf16: 40 KB a stage, 80 KB,
// leaving 145.5 KB (kk <= 72).  kmt_knn_walk_smem_buffer_bytes gives the
// wrapper this limit per dtype.
//
// What bounds it on the H100: the dot products, 2 * f operations per
// examined (query, member) pair, at the tensor cores' rate (989 TFLOP/s
// bf16; 495 / 3 TF32 for fp32-grade products), with the query panel read
// again from L2 for every member sub-tile; the insertion is a compare per
// candidate and O(kk) only when it enters.  No TMA, warp specialisation,
// persistence or clusters; the walk's length depends on the data, and
// chunks are independent blocks.
//
// Sizes are int64 and row offsets 64-bit (member row * f passes 2^31
// beyond 8M x 256); member positions are int32 (M < 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;        // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int PANEL = 256;          // query rows per product panel (M)
constexpr int BN = 64;              // members per sub-tile (N)
constexpr int STAGES = 2;           // depth of the shared-memory ring
constexpr int DSTRIDE = PANEL + 4;  // dots row: conflict-free fragment stores
constexpr float INFLATE = 1.00001f;                // fp32(1 + SLACK)
// bf16 storage: the chord t = sqrt(|m|^2 - 2 dot + |q|^2) is raised by
// sqrt(EPS_ENV (|q|^2 + |m|^2)), above the dot form's rounding here and in
// pass 1 together (knn_prune.EPS_ENV derives it)
constexpr float EPS_ENV = 0.00390625f;             // 2^-8
constexpr float STOP_BOUND = 1e28f;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, a block's limit on sm_90

// fp32 storage: products in 3xTF32 from the hi/lo split of both operands.
template <typename T>
constexpr bool SPLIT = std::is_same<T, float>::value;

template <typename T>
struct Layout {
  static constexpr int Q_BYTES = PANEL * ROW_BYTES;
  static constexpr int M_BYTES = BN * ROW_BYTES;
  // stage: queries [queries lo] members [members lo]
  static constexpr int STAGE_BYTES =
      SPLIT<T> ? 2 * (Q_BYTES + M_BYTES) : Q_BYTES + M_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static_assert(BN * DSTRIDE * 4 <= RING_BYTES, "dots alias the ring");
  // 1 KB of alignment slack, the ring, the member norms and positions;
  // the buffer follows when it sits in shared memory
  static constexpr size_t BASE_SMEM = 1024 + RING_BYTES + BN * 8;
};

// max over the chunk's rows of column kn - 1 of the buffer; every thread
// gets the same value
__device__ float chunk_tau(const float *bd, int64_t kn, int64_t chunk,
                           float *warp_max) {
  float m = -INFINITY;
  for (int64_t row = threadIdx.x; row < chunk; row += THREADS)
    m = fmaxf(m, bd[(kn - 1) * chunk + row]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __syncthreads();  // earlier readers of warp_max are done
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float t = warp_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) t = fmaxf(t, warp_max[w]);
  return t;
}

// One feature chunk of products for this warpgroup's 128 query rows (two
// m64 tiles) against the sub-tile, into fresh accumulators.  bf16: into
// `acc`.  fp32 (3xTF32): q_hi.m_hi into `acc`, the small cross terms
// q_lo.m_hi + q_hi.m_lo into `lo`.
template <typename T>
__device__ __forceinline__ void stage_mma(float (&acc)[2][32],
                                          float (&lo)[2][32],
                                          const uint8_t *stage, int wg) {
  using L = Layout<T>;
  const uint32_t qh = smem_addr(stage) + wg * 128 * ROW_BYTES;
  if constexpr (SPLIT<T>) {
    const uint32_t ql = qh + L::Q_BYTES;
    const uint32_t mh = smem_addr(stage + 2 * L::Q_BYTES);
    const uint32_t ml = mh + L::M_BYTES;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const int o = s * KSTEP_BYTES;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int a = mt * 64 * ROW_BYTES + o;
        wgmma_tf32_n64(lo[mt], gmma_desc(ql + a), gmma_desc(mh + o), s > 0);
        wgmma_tf32_n64(lo[mt], gmma_desc(qh + a), gmma_desc(ml + o), 1);
        wgmma_tf32_n64(acc[mt], gmma_desc(qh + a), gmma_desc(mh + o), s > 0);
      }
    }
  } else {
    const uint32_t mb = smem_addr(stage + L::Q_BYTES);
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wgmma_bf16_n64(acc[mt],
                       gmma_desc(qh + mt * 64 * ROW_BYTES + s * KSTEP_BYTES),
                       gmma_desc(mb + s * KSTEP_BYTES), s > 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
walk_kernel(const T *__restrict__ xq, const float *__restrict__ xq_sq,
            const int32_t *__restrict__ q_pos,
            const uint8_t *__restrict__ q_valid,
            const int32_t *__restrict__ n_qvalid,
            const int32_t *__restrict__ n_steps,
            const int32_t *__restrict__ tile_order,
            const float *__restrict__ sorted_min,
            const int32_t *__restrict__ tile_nvalid,
            const T *__restrict__ xm, const float *__restrict__ xm_sq,
            const int32_t *__restrict__ m_spos, int32_t *__restrict__ bi_out,
            int64_t *__restrict__ ex_out, int32_t *__restrict__ steps_out,
            float *__restrict__ scratch_d, int32_t *__restrict__ scratch_i,
            int64_t f, int64_t chunk, int64_t nte, int64_t kk, int64_t kn,
            int64_t tile_m, int64_t group, int cosine, int envelope,
            int buf_in_smem, int vec) {
  using L = Layout<T>;
  constexpr int BK = ROW_BYTES / sizeof(T);  // features per chunk
  extern __shared__ uint8_t smem_raw[];
  __shared__ float warp_max[WARPS];
  uint8_t *ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float *dots = reinterpret_cast<float *>(ring);  // [BN][DSTRIDE]
  float *msq_s = reinterpret_cast<float *>(ring + L::RING_BYTES);  // [BN]
  int32_t *mspos_s = reinterpret_cast<int32_t *>(msq_s + BN);      // [BN]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  // accumulator rows of this thread: frag_row + 64 * mt + 8 * h
  const int frag_row = wg * 128 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int quad = lane & 3;
  const int64_t c = blockIdx.x;
  const int64_t q0 = c * chunk;
  const T *xq_c = xq + q0 * f;
  const int32_t *order = tile_order + c * nte;
  const float *bound = sorted_min + c * nte;

  // the chunk's buffer, column-major: entry j of row r at [j * chunk + r]
  float *bd;
  int32_t *bix;
  if (buf_in_smem) {
    bd = reinterpret_cast<float *>(mspos_s + BN);
    bix = reinterpret_cast<int32_t *>(bd + kk * chunk);
  } else {
    bd = scratch_d + c * kk * chunk;
    bix = scratch_i + c * kk * chunk;
  }
  for (int64_t e = tid; e < kk * chunk; e += THREADS) {
    bd[e] = q_valid[q0 + e % chunk] ? INFINITY : -INFINITY;
    bix[e] = -1;
  }
  __syncthreads();
  float tau = chunk_tau(bd, kn, chunk, warp_max);

  const int64_t steps_max = n_steps[c];
  const int64_t nq = n_qvalid[c];
  const int64_t gm = group * tile_m;
  const int64_t n_kc = (f + BK - 1) / BK;
  int64_t examined = 0;
  int64_t s = 0;
  for (; s < steps_max; ++s) {
    const int64_t r = s * group;
    const float b = bound[r];
    if (!(b <= tau && b < STOP_BOUND)) break;
    for (int64_t m0 = 0; m0 < gm; m0 += BN) {
      // tile_m is a multiple of BN, so a sub-tile lies in one tile
      const int64_t mrow0 =
          (int64_t)order[r + m0 / tile_m] * tile_m + m0 % tile_m;
      if (tid < BN) {
        msq_s[tid] = xm_sq[mrow0 + tid];
        mspos_s[tid] = m_spos[mrow0 + tid];
      }
      for (int64_t p0 = 0; p0 < chunk; p0 += PANEL) {
        auto load = [&](int64_t kc, int slot) {
          uint8_t *st = ring + slot * L::STAGE_BYTES;
          const int64_t k0 = kc * BK;
          load_tile<T, PANEL, THREADS>(st, xq_c, chunk, p0, k0, f, vec);
          load_tile<T, BN, THREADS>(st + (SPLIT<T> ? 2 : 1) * L::Q_BYTES, xm,
                                    mrow0 + BN, mrow0, k0, f, vec);
        };
        // the chunk's products (bf16; fp32: q_hi.m_hi) in acc, fp32's cross
        // terms in lo, added to the pair's sums (sum) in registers, rounded
        // to nearest, in chunk order: the tensor cores' fp32 accumulation
        // truncates, and no chunk adds more than four k-steps that way
        float acc[2][32], lo[2][32], sum[2][32];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 32; ++i)
            acc[mt][i] = lo[mt][i] = sum[mt][i] = 0.f;
        load(0, 0);
        cp_async_commit();
        for (int64_t kc = 0; kc < n_kc; ++kc) {
          const int slot = (int)(kc & 1);
          // chunk kc + 1 into the slot chunk kc - 1 used: every warpgroup
          // finished with it before the last __syncthreads
          if (kc + 1 < n_kc) load(kc + 1, slot ^ 1);
          cp_async_commit();
          cp_async_wait<1>();  // this thread's units of chunk kc landed
          uint8_t *st = ring + slot * L::STAGE_BYTES;
          if constexpr (SPLIT<T>) {
            split_own_units<PANEL, THREADS>(st, st + L::Q_BYTES);
            split_own_units<BN, THREADS>(st + 2 * L::Q_BYTES,
                                         st + 2 * L::Q_BYTES + L::M_BYTES);
          }
          fence_proxy_async();
          __syncthreads();  // chunk kc visible to both warpgroups
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            fence_regs(acc[mt]);
            if constexpr (SPLIT<T>) fence_regs(lo[mt]);
          }
          wgmma_fence();
          stage_mma<T>(acc, lo, st, wg);
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            fence_regs(acc[mt]);
            if constexpr (SPLIT<T>) {
              fence_regs(lo[mt]);
#pragma unroll
              for (int i = 0; i < 32; ++i)
                sum[mt][i] = kc == 0 ? acc[mt][i] + lo[mt][i]
                                     : sum[mt][i] + (acc[mt][i] + lo[mt][i]);
            } else {
#pragma unroll
              for (int i = 0; i < 32; ++i)
                sum[mt][i] = kc == 0 ? acc[mt][i] : sum[mt][i] + acc[mt][i];
            }
          }
          __syncthreads();  // both warpgroups done reading chunk kc
        }
        // the ring is idle: the fragments into the dots block
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < BN / 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int e = i * 4 + h * 2 + j;
                dots[(i * 8 + quad * 2 + j) * DSTRIDE + frag_row + 64 * mt +
                     8 * h] = sum[mt][e];
              }
        __syncthreads();

        const int64_t row = p0 + tid;
        if (row < chunk && q_valid[q0 + row]) {
          const float qsq = xq_sq[q0 + row];
          const int32_t qp = q_pos[q0 + row];
          float *bcol = bd + row;
          int32_t *icol = bix + row;
          float kd = bcol[(kk - 1) * chunk];
          int32_t ki = icol[(kk - 1) * chunk];
          for (int j = 0; j < BN; ++j) {
            const float dot = dots[j * DSTRIDE + tid];
            const float msq = msq_s[j];
            float d;
            if (cosine && SPLIT<T>)
              d = acosf(fminf(fmaxf(dot, -1.f), 1.f));
            else
              d = sqrtf(fmaxf(
                  __fadd_rn(__fsub_rn(msq, __fmul_rn(2.f, dot)), qsq), 0.f));
            d = __fmul_rn(d, INFLATE);
            if (envelope)
              d = __fadd_rn(d,
                            sqrtf(__fmul_rn(EPS_ENV, __fadd_rn(qsq, msq))));
            if (cosine && !SPLIT<T>) {  // bf16: the angle of the chord
              const float h = __fmul_rn(0.5f, d);
              d = __fmul_rn(2.f, asinf(h > 1.f ? 1.f : h));  // NaN stays
            }
            const int32_t mp = (int32_t)(mrow0 + j);
            if (mp == qp || mspos_s[j] < 0) d = INFINITY;
            if (d < kd || (d == kd && mp < ki)) {
              int64_t p = kk - 1;
              while (p > 0) {
                const float pd = bcol[(p - 1) * chunk];
                const int32_t pi = icol[(p - 1) * chunk];
                if (pd < d || (pd == d && pi < mp)) break;
                bcol[p * chunk] = pd;
                icol[p * chunk] = pi;
                --p;
              }
              bcol[p * chunk] = d;
              icol[p * chunk] = mp;
              kd = bcol[(kk - 1) * chunk];
              ki = icol[(kk - 1) * chunk];
            }
          }
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      int64_t nv = 0;
      for (int64_t g = 0; g < group; ++g) nv += tile_nvalid[order[r + g]];
      examined += nv * nq;
    }
    tau = chunk_tau(bd, kn, chunk, warp_max);
  }
  if (tid == 0) {
    ex_out[c] = examined;
    steps_out[c] = (int32_t)s;
  }
  for (int64_t e = tid; e < kk * chunk; e += THREADS) {
    const int64_t row = e / kk, j = e % kk;
    bi_out[(q0 + row) * kk + j] = bix[j * chunk + row];
  }
}

template <typename T>
int launch_walk(const void *xq, const void *xq_sq, const void *q_pos,
                const void *q_valid, const void *n_qvalid,
                const void *n_steps, const void *tile_order,
                const void *sorted_min, const void *tile_nvalid,
                const void *xm, const void *xm_sq, const void *m_spos,
                void *bi, void *examined, void *steps, void *scratch_d,
                void *scratch_i, int64_t nchunks, int64_t f, int64_t chunk,
                int64_t nte, int64_t kk, int64_t kn, int64_t tile_m,
                int64_t group, int64_t cosine, int64_t envelope,
                int64_t buf_in_smem, cudaStream_t stream) {
  const size_t smem = Layout<T>::BASE_SMEM +
                      (buf_in_smem ? (size_t)(kk * chunk) * 8 : 0);
  if (smem + WARPS * sizeof(float) > MAX_SMEM || tile_m % BN ||
      nchunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto aligned = [](const void *p) { return (uintptr_t)p % 16 == 0; };
  // every query and member row 16-byte aligned
  const int vec = aligned(xq) && aligned(xm) &&
                  (f * (int64_t)sizeof(T)) % 16 == 0;
  walk_kernel<T><<<(unsigned)nchunks, THREADS, smem, stream>>>(
      (const T *)xq, (const float *)xq_sq, (const int32_t *)q_pos,
      (const uint8_t *)q_valid, (const int32_t *)n_qvalid,
      (const int32_t *)n_steps, (const int32_t *)tile_order,
      (const float *)sorted_min, (const int32_t *)tile_nvalid,
      (const T *)xm, (const float *)xm_sq, (const int32_t *)m_spos,
      (int32_t *)bi, (int64_t *)examined, (int32_t *)steps,
      (float *)scratch_d, (int32_t *)scratch_i, f, chunk, nte, kk, kn,
      tile_m, group, (int)cosine, (int)envelope, (int)buf_in_smem, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The walk over a batch of nchunks query chunks (B3).  Writes the kk
// candidate packed positions per query row (bi, row-major (nchunks * chunk,
// kk), -1 = empty), the examined count (int64) and the steps taken (int32)
// per chunk.  scratch_d/scratch_i hold nchunks * kk * chunk entries when
// buf_in_smem is 0.  Returns cudaGetLastError() after the launch.
int kmt_knn_walk(const void *xq, const void *xq_sq, const void *q_pos,
                 const void *q_valid, const void *n_qvalid,
                 const void *n_steps, const void *tile_order,
                 const void *sorted_min, const void *tile_nvalid,
                 const void *xm, const void *xm_sq, const void *m_spos,
                 void *bi, void *examined, void *steps, void *scratch_d,
                 void *scratch_i, int64_t nchunks, int64_t f, int64_t chunk,
                 int64_t nte, int64_t kk, int64_t kn, int64_t tile_m,
                 int64_t group, int64_t is_bf16, int64_t cosine,
                 int64_t envelope, int64_t buf_in_smem, void *stream) {
  if (is_bf16)
    return launch_walk<__nv_bfloat16>(
        xq, xq_sq, q_pos, q_valid, n_qvalid, n_steps, tile_order, sorted_min,
        tile_nvalid, xm, xm_sq, m_spos, bi, examined, steps, scratch_d,
        scratch_i, nchunks, f, chunk, nte, kk, kn, tile_m, group, cosine,
        envelope, buf_in_smem, (cudaStream_t)stream);
  return launch_walk<float>(
      xq, xq_sq, q_pos, q_valid, n_qvalid, n_steps, tile_order, sorted_min,
      tile_nvalid, xm, xm_sq, m_spos, bi, examined, steps, scratch_d,
      scratch_i, nchunks, f, chunk, nte, kk, kn, tile_m, group, cosine,
      envelope, buf_in_smem, (cudaStream_t)stream);
}

// The largest (distance, id) buffer, kk * chunk * 8 bytes, that the walk
// keeps in shared memory beside its ring (fp32: 67,040 bytes, kk <= 32 at
// chunk 256; bf16: 148,960 bytes, kk <= 72); a larger one goes to the
// global scratch.
int64_t kmt_knn_walk_smem_buffer_bytes(int64_t is_bf16) {
  const size_t base = is_bf16 ? Layout<__nv_bfloat16>::BASE_SMEM
                              : Layout<float>::BASE_SMEM;
  return (int64_t)(MAX_SMEM - WARPS * sizeof(float) - base);
}

}  // extern "C"
