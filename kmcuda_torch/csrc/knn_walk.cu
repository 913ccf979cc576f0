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
// each step the members stream through shared memory in sub-tiles of BN
// rows x BK features (any f, ragged edge masked) against the chunk's
// queries in panels of 256 rows: dot products in fp32 FMA, 8x8 register
// tile per thread, written to a (BN x 256) shared block.  Each thread then
// owns one query row: it turns the dots into true distances (L2
// sqrt(max(|m|^2 - 2 dot + |q|^2, 0)), cosine acos(clip(dot))), applies the
// (1 + SLACK) margin and the bf16 envelope, masks self and padding to +inf,
// and inserts a candidate into its row of the sorted (distance, id) buffer
// only if it is lexicographically below the current kk-th entry — so a
// masked member (+inf, id >= 0) never displaces the (+inf, -1) sentinel.
// The buffer (column-major per chunk, conflict-free) sits in shared memory
// when kk * chunk fits, else in a global scratch; there is no kk bound.
// Invalid query rows start at -inf and are never updated, so they never
// raise tau.  Each active step adds sum(tile_nvalid of its tiles) *
// n_qvalid to the chunk's int64 examined count.
//
// What bounds it on the H100: the dot products, 2 * f FLOP per examined
// (query, member) pair on the fp32 CUDA cores, with the query panel read
// again from L2 for every sub-tile; the insertion is a compare per
// candidate and O(kk) only when it enters.  This first design is simple:
// no tensor cores, no TMA, one 256-thread block per chunk; the walk's
// length depends on the data, and chunks are independent blocks.
//
// Sizes are int64 and row offsets 64-bit (member row * f passes 2^31
// beyond 8M x 256); member positions are int32 (M < 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PANEL = 256;          // query rows per product panel
constexpr int BN = 64;              // members per sub-tile
constexpr int BK = 16;              // features per shared-memory stage
constexpr int TM = PANEL / 32;      // rows per thread: lane + 32 * i
constexpr int TN = BN / WARPS;      // columns per thread: warp + 8 * j
constexpr int QS_STRIDE = PANEL + 1;
constexpr int MS_STRIDE = BN + 1;
constexpr float INFLATE = 1.00001f;                // fp32(1 + SLACK)
constexpr float EPS_ENV = 0.00390625f;             // 2^-8, bf16 storage
constexpr float COS_ENV = 0.08838834764831845f;    // sqrt(2 * 2^-8)
constexpr float STOP_BOUND = 1e28f;
constexpr size_t BASE_SMEM =
    sizeof(float) * (BK * QS_STRIDE + BK * MS_STRIDE + BN * PANEL + BN) +
    sizeof(int32_t) * BN;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, a block's limit on sm_90

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
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
            int buf_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float *qs = reinterpret_cast<float *>(smem_raw);   // [BK][QS_STRIDE]
  float *ms = qs + BK * QS_STRIDE;                     // [BK][MS_STRIDE]
  float *dots = ms + BK * MS_STRIDE;                   // [BN][PANEL]
  float *msq_s = dots + BN * PANEL;                    // [BN]
  int32_t *mspos_s = reinterpret_cast<int32_t *>(msq_s + BN);  // [BN]
  __shared__ float warp_max[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t c = blockIdx.x;
  const int64_t q0 = c * chunk;
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
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
        for (int64_t k0 = 0; k0 < f; k0 += BK) {
          for (int e = tid; e < PANEL * BK; e += THREADS) {
            const int row = e / BK, kq = e % BK;
            const int64_t qrow = p0 + row, col = k0 + kq;
            qs[kq * QS_STRIDE + row] =
                (qrow < chunk && col < f) ? to_f(xq[(q0 + qrow) * f + col])
                                          : 0.f;
          }
          for (int e = tid; e < BN * BK; e += THREADS) {
            const int m = e / BK, kq = e % BK;
            const int64_t col = k0 + kq;
            ms[kq * MS_STRIDE + m] =
                col < f ? to_f(xm[(mrow0 + m) * f + col]) : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int kq = 0; kq < BK; ++kq) {
            float a[TM], bb[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = qs[kq * QS_STRIDE + lane + 32 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) bb[j] = ms[kq * MS_STRIDE + warp + WARPS * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            dots[(warp + WARPS * j) * PANEL + lane + 32 * i] = acc[i][j];
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
            const float dot = dots[j * PANEL + tid];
            const float msq = msq_s[j];
            float d;
            if (cosine)
              d = acosf(fminf(fmaxf(dot, -1.f), 1.f));
            else
              d = sqrtf(fmaxf(
                  __fadd_rn(__fsub_rn(msq, __fmul_rn(2.f, dot)), qsq), 0.f));
            d = __fmul_rn(d, INFLATE);
            if (envelope)
              d = __fadd_rn(d, cosine ? COS_ENV
                                      : sqrtf(__fmul_rn(EPS_ENV,
                                                        __fadd_rn(qsq, msq))));
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
  const size_t smem =
      BASE_SMEM + (buf_in_smem ? (size_t)(kk * chunk) * 8 : 0);
  if (smem > MAX_SMEM || tile_m % BN || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  walk_kernel<T><<<(unsigned)nchunks, THREADS, smem, stream>>>(
      (const T *)xq, (const float *)xq_sq, (const int32_t *)q_pos,
      (const uint8_t *)q_valid, (const int32_t *)n_qvalid,
      (const int32_t *)n_steps, (const int32_t *)tile_order,
      (const float *)sorted_min, (const int32_t *)tile_nvalid,
      (const T *)xm, (const float *)xm_sq, (const int32_t *)m_spos,
      (int32_t *)bi, (int64_t *)examined, (int32_t *)steps,
      (float *)scratch_d, (int32_t *)scratch_i, f, chunk, nte, kk, kn,
      tile_m, group, (int)cosine, (int)envelope, (int)buf_in_smem);
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

}  // extern "C"
