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
// kmt_assign (B2, and the first half of B1), one block per 128 sample rows:
//   prod = x . c in fp32 FMA over centroid tiles staged in shared memory
//   (the reference kmcuda's `cstep` tiling), 8x8 register tile per thread;
//   s = |c|^2 - 2 prod (L2) or -prod (cosine), non-finite -> PAD_PENALTY;
//   running top-2 per row with lowest-id tie-break, merged across the 16
//   lanes that share a row by warp shuffles; exact rescore of the two
//   candidates against the fp32 NaN-zeroed centroid table; invalid rows get
//   id k; the reassignment count against `prev` is an integer atomic.
// kmt_segment_sum (the rest of B1): sums[a] += x_row, counts[a] += 1 over
//   rows with a < k.  No float atomics: P fixed row ranges, block (slab, p)
//   walks its range in order into partial[p] with each thread owning one
//   feature column, and a second kernel adds the P partials in fixed order,
//   so the sums repeat bitwise from run to run.
//
// What bounds it on the H100: the score product is 2*n*k*f FLOP done on the
// fp32 CUDA cores (67 TFLOP/s peak), far above the n*f + k*f bytes it must
// read, so it is compute-bound; this first design keeps it simple (no
// tensor cores, no TMA) and relies on the register tile for reuse.  The
// segment sum is bound by the latency of its in-order read-modify-write
// walk through L2; the scratch is capped by the caller.
//
// Sizes are int64 and row offsets 64-bit: n*f may pass 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // sample rows per block
constexpr int BN = 128;           // centroid columns per tile
constexpr int BK = 16;            // features per shared-memory stage
constexpr int TM = 8;             // rows per thread
constexpr int TN = 8;             // columns per thread
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int CS_STRIDE = BN + 2; // stride % 32 == 2: conflict-free stores
constexpr float PAD_PENALTY = 1e30f;
constexpr float HALF_PAD = 5e29f; // fp32(PAD_PENALTY * 0.5), as the reference
constexpr int SEG_THREADS = 128;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const T *__restrict__ x, const T *__restrict__ panel,
              const float *__restrict__ c_sq, const float *__restrict__ ctab,
              const uint8_t *__restrict__ valid,
              const int32_t *__restrict__ prev, int32_t *__restrict__ aid_out,
              float *__restrict__ best_out, int32_t *__restrict__ changed,
              int64_t n, int64_t f, int64_t k, int cosine) {
  __shared__ float xs[BM][BK];
  __shared__ float cs[BK][CS_STRIDE];
  __shared__ int block_changed;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column lane; the 16 lanes of a half-warp
  const int ty = tid >> 4;   // share rows ty + 16 * i
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  if (tid == 0) block_changed = 0;

  Top2 top[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    top[i].s1 = top[i].s2 = INFINITY;
    top[i].a1 = top[i].a2 = INT32_MAX;
  }

  for (int64_t col0 = 0; col0 < k; col0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int64_t k0 = 0; k0 < f; k0 += BK) {
#pragma unroll
      for (int e = 0; e < BM * BK / THREADS; ++e) {
        const int idx = tid + e * THREADS;
        const int m = idx / BK, kk = idx % BK;
        const int64_t r = row0 + m, c = k0 + kk;
        xs[m][kk] = (r < n && c < f) ? to_f(x[r * f + c]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < BN * BK / THREADS; ++e) {
        const int idx = tid + e * THREADS;
        const int nn = idx / BK, kk = idx % BK;
        const int64_t cc = col0 + nn, c = k0 + kk;
        cs[kk][nn] = (cc < k && c < f) ? to_f(panel[cc * f + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = cs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t col = col0 + tx + 16 * j;
      if (col >= k) continue;
      const float csq = c_sq[col];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float s = cosine ? -acc[i][j] : csq - 2.f * acc[i][j];
        if (!isfinite(s)) s = PAD_PENALTY;
        top2_push(top[i], s, (int)col);
      }
    }
  }

  int my_changed = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    // merge the 16 lanes' top-2 lists of this row (ids are disjoint, so the
    // merged pair is the same on every lane)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float os1 = __shfl_xor_sync(0xffffffffu, top[i].s1, off);
      const float os2 = __shfl_xor_sync(0xffffffffu, top[i].s2, off);
      const int oa1 = __shfl_xor_sync(0xffffffffu, top[i].a1, off);
      const int oa2 = __shfl_xor_sync(0xffffffffu, top[i].a2, off);
      top2_push(top[i], os1, oa1);
      top2_push(top[i], os2, oa2);
    }
    const int64_t row = row0 + ty + 16 * i;
    const bool row_ok = row < n;
    const int a1 = top[i].a1, a2 = top[i].a2;
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
      const float d2a = (a1 >= k || top[i].s1 >= HALF_PAD) ? INFINITY : pa;
      const float d2b = (a2 >= k || top[i].s2 >= HALF_PAD) ? INFINITY : pb;
      const bool take_b = d2b < d2a || (d2b == d2a && a2 < a1);
      int aid = take_b ? a2 : a1;
      if (!valid[row]) aid = (int)k;
      aid_out[row] = aid;
      best_out[row] = take_b ? top[i].s2 : top[i].s1;
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
void launch_assign(const void *x, const void *panel, const void *c_sq,
                   const void *ctab, const void *valid, const void *prev,
                   void *aid, void *best, void *changed, int64_t n,
                   int64_t f, int64_t k, int64_t cosine,
                   cudaStream_t stream) {
  const int64_t blocks = (n + BM - 1) / BM;
  assign_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T *)x, (const T *)panel, (const float *)c_sq,
      (const float *)ctab, (const uint8_t *)valid, (const int32_t *)prev,
      (int32_t *)aid, (float *)best, (int32_t *)changed, n, f, k,
      (int)cosine);
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

// Scores, top-2 rescored argmin and reassignment count (B2).  `changed`
// must hold 0 on entry.  Returns cudaGetLastError() after the launch.
int kmt_assign(const void *x, const void *panel, const void *c_sq,
               const void *ctab, const void *valid, const void *prev,
               void *aid, void *best, void *changed, int64_t n, int64_t f,
               int64_t k, int64_t is_bf16, int64_t cosine, void *stream) {
  if (is_bf16)
    launch_assign<__nv_bfloat16>(x, panel, c_sq, ctab, valid, prev, aid, best,
                                 changed, n, f, k, cosine,
                                 (cudaStream_t)stream);
  else
    launch_assign<float>(x, panel, c_sq, ctab, valid, prev, aid, best,
                         changed, n, f, k, cosine, (cudaStream_t)stream);
  return (int)cudaGetLastError();
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
