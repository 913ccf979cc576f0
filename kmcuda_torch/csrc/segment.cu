// Segment sum for Hopper (sm_90a): the centroid sums and counts of a Lloyd
// pass, sums[a] += x_row and counts[a] += 1 over the rows with 0 <= a < k.
//
// Replaces the one-hot (K, F) sums and counts of the Lloyd Pallas kernel of
// the JAX package:
//   kmcuda_tpu/ops/assign_pallas.py:_kernel (fused_lloyd_pass, B1; B1')
// B1 is kmt_assign (assign.cu) followed by this.
//
// kmt_segment_sum reads x once, in cluster order, and writes each output
// once.  The wrapper gives the cut (ops/assign_kernels.segment_plan, a
// pure function of the shape): placement blocks of R >= k rows, reduction
// chunks of C sorted positions, TX threads across a row's features.
//   1. count:  block b counts its rows [b R, (b + 1) R) per cluster (shared
//      memory when k fits, else its own column of the table; integer
//      atomics, one per run of equal ids in a warp) into the cluster-major
//      table hist[c][b].
//   2. scan:   one block per cluster turns its row of the table into
//      exclusive prefixes over the blocks, in block order; the row's total
//      is counts[c].
//   3. starts: one block scans the counts into start[0..k]; start[k] is the
//      number of valid rows.
//   4. place:  block b writes its rows' ids into the cluster-sorted
//      permutation, ascending by row id within each cluster: its offsets are
//      start[c] + hist[c][b]; within the block it takes its rows 256 at a
//      time, each warp ranks its lanes' equal ids (__match_any_sync) and the
//      warps take their offsets in warp order.  No rank depends on
//      scheduling.
//   5. reduce: block (chunk group, feature slab); each of its TY rows of
//      threads takes one chunk of C sorted positions, each thread V
//      consecutive features (16 bytes), and sums every segment in ascending
//      position, gathering whole rows (16-byte loads where rows are
//      aligned).  A segment wholly inside the chunk goes straight to `sums`;
//      one that crosses a chunk edge leaves one partial per chunk (slot 0 if
//      it began before the chunk, else slot 1).
//   6. fix:    one block per cluster adds the partials of a crossing segment
//      in chunk order, and writes zeros for an empty cluster.
// No float atomics: the summation order is a pure function of (aid, n, f,
// k), so the sums repeat bitwise from run to run.  The cut balances skewed
// clusters: a cluster holding most of the rows spreads over many chunks.
//
// What bounds it on the H100: one read of x (n * f * size bytes) and of the
// ids, one write of the (k, f) fp32 sums: memory.  The permutation, the
// table and the partials are O(n + k + chunks * f) integers and floats;
// their traffic is a few ints per row beside the row's f values.
//
// Sizes are int64 and row offsets 64-bit (row * f passes 2^31 beyond
// 8M x 256); positions and counts are int32 (n < 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr int SMEM_K = 12288;   // clusters counted in 48 KB of shared memory
constexpr int UNROLL = 8;       // reduction: rows in flight per thread

// Exclusive prefix of v over the block (NT threads, in thread order) and
// the block's total; `warp_tot` holds NT / 32 ints.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int *warp_tot,
                                                    int &total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < NT / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += o;
    }
    if (lane < NT / 32) warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? warp_tot[warp - 1] : 0;
  total = warp_tot[NT / 32 - 1];
  __syncthreads();  // warp_tot may be reused
  return before + incl - v;
}

__global__ void __launch_bounds__(THREADS)
seg_count_kernel(const int32_t *__restrict__ aid, int32_t *__restrict__ hist,
                 int64_t n, int64_t k, int64_t rows, int64_t nb) {
  extern __shared__ int32_t cnt_s[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool smem = k <= SMEM_K;
  int32_t *cnt = smem ? cnt_s : hist + b;
  const int64_t stride = smem ? 1 : nb;
  for (int64_t c = threadIdx.x; c < k; c += THREADS) cnt[c * stride] = 0;
  __syncthreads();
  const int64_t r0 = b * rows;
  const int64_t r1 = r0 + rows < n ? r0 + rows : n;
  for (int64_t base = r0 + warp * 32; base < r1; base += THREADS) {
    const int64_t r = base + lane;
    const int a = r < r1 ? aid[r] : -1;
    const bool ok = a >= 0 && a < k;
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? a : -1);
    if (ok && lane == __ffs(peers) - 1)
      atomicAdd(&cnt[(int64_t)a * stride], __popc(peers));
  }
  __syncthreads();
  if (smem)
    for (int64_t c = threadIdx.x; c < k; c += THREADS)
      hist[c * nb + b] = cnt_s[c];
}

__global__ void __launch_bounds__(THREADS)
seg_scan_kernel(int32_t *__restrict__ hist, int32_t *__restrict__ counts,
                int64_t nb) {
  __shared__ int warp_tot[WARPS];
  int32_t *row = hist + (int64_t)blockIdx.x * nb;
  int carry = 0;
  for (int64_t j0 = 0; j0 < nb; j0 += THREADS) {
    const int64_t j = j0 + threadIdx.x;
    const int v = j < nb ? row[j] : 0;
    int total;
    const int ex = block_exclusive_scan<THREADS>(v, warp_tot, total);
    if (j < nb) row[j] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(SCAN_THREADS)
seg_starts_kernel(const int32_t *__restrict__ counts,
                  int32_t *__restrict__ start, int64_t k) {
  __shared__ int warp_tot[SCAN_THREADS / 32];
  int carry = 0;
  for (int64_t c0 = 0; c0 < k; c0 += SCAN_THREADS) {
    const int64_t c = c0 + threadIdx.x;
    const int v = c < k ? counts[c] : 0;
    int total;
    const int ex = block_exclusive_scan<SCAN_THREADS>(v, warp_tot, total);
    if (c < k) start[c] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) start[k] = carry;
}

__global__ void __launch_bounds__(THREADS)
seg_place_kernel(const int32_t *__restrict__ aid, int32_t *__restrict__ hist,
                 const int32_t *__restrict__ start,
                 int32_t *__restrict__ perm, int32_t *__restrict__ seg,
                 int64_t n, int64_t k, int64_t rows, int64_t nb) {
  extern __shared__ int32_t off_s[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool smem = k <= SMEM_K;
  // the next free position of each cluster for this block's rows
  int32_t *off = smem ? off_s : hist + b;
  const int64_t stride = smem ? 1 : nb;
  for (int64_t c = threadIdx.x; c < k; c += THREADS)
    off[c * stride] = start[c] + hist[c * nb + b];
  __syncthreads();
  const int64_t r0 = b * rows;
  const int64_t r1 = r0 + rows < n ? r0 + rows : n;
  const unsigned lower = (1u << lane) - 1u;
  for (int64_t t0 = r0; t0 < r1; t0 += THREADS) {
    const int64_t r = t0 + threadIdx.x;
    const int a = r < r1 ? aid[r] : -1;
    const bool ok = a >= 0 && a < k;
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? a : -1);
    int pos = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (warp == w) {
        if (ok) pos = off[(int64_t)a * stride] + __popc(peers & lower);
        __syncwarp();
        if (ok && lane == __ffs(peers) - 1)
          off[(int64_t)a * stride] += __popc(peers);
      }
      __syncthreads();
    }
    if (ok) {
      perm[pos] = (int32_t)r;
      seg[pos] = a;
    }
  }
}

// V consecutive features [c0, c0 + V) of row r as fp32; zeros past f.
template <typename T, int V>
__device__ __forceinline__ void load_row(float (&v)[V],
                                         const T *__restrict__ x, int64_t r,
                                         int64_t f, int64_t c0, bool vec) {
  const T *p = x + r * f + c0;
  if (vec && c0 + V <= f) {
    const uint4 u = __ldg(reinterpret_cast<const uint4 *>(p));
    const T *t = reinterpret_cast<const T *>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = c0 + i < f ? to_f(p[i]) : 0.f;
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float *__restrict__ dst,
                                           const float (&v)[V], int64_t f,
                                           int64_t c0) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c0 + i < f) dst[c0 + i] = v[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
seg_reduce_kernel(const T *__restrict__ x, const int32_t *__restrict__ perm,
                  const int32_t *__restrict__ seg,
                  const int32_t *__restrict__ start,
                  float *__restrict__ partial, float *__restrict__ sums,
                  int64_t f, int64_t k, int64_t chunk, int64_t nchunks,
                  int vec) {
  constexpr int V = 16 / sizeof(T);
  const int64_t j = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t nvalid = start[k];
  const int64_t p0 = j * chunk;
  if (j >= nchunks || p0 >= nvalid) return;
  const int64_t p1 = p0 + chunk < nvalid ? p0 + chunk : nvalid;
  const int64_t c0 = ((int64_t)blockIdx.y * blockDim.x + threadIdx.x) * V;

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  int cur = seg[p0];
  // the chunk's first segment began in an earlier chunk
  bool head = p0 > 0 && seg[p0 - 1] == cur;
  auto flush = [&](bool tail) {
    float *dst = head ? partial + (j * 2) * f
                 : tail ? partial + (j * 2 + 1) * f
                        : sums + (int64_t)cur * f;
    store_cols<V>(dst, acc, f, c0);
  };
  for (int64_t q = p0; q < p1; q += UNROLL) {
    int32_t rr[UNROLL], aa[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = q + u < p1;
      rr[u] = in ? perm[q + u] : 0;
      aa[u] = in ? seg[q + u] : -1;
    }
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (aa[u] >= 0) {
        load_row<T, V>(v[u], x, rr[u], f, c0, vec);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (aa[u] < 0) continue;
      if (aa[u] != cur) {
        flush(false);
        head = false;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.f;
        cur = aa[u];
      }
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += v[u][i];
    }
  }
  flush(p1 < nvalid && seg[p1] == cur);
}

__global__ void __launch_bounds__(THREADS)
seg_fix_kernel(const int32_t *__restrict__ start,
               const float *__restrict__ partial, float *__restrict__ sums,
               int64_t f, int64_t chunk) {
  const int64_t c = blockIdx.x;
  const int64_t s = start[c], e = start[c + 1];
  float *out = sums + c * f;
  if (s == e) {
    for (int64_t i = threadIdx.x; i < f; i += THREADS) out[i] = 0.f;
    return;
  }
  const int64_t j0 = s / chunk, j1 = (e - 1) / chunk;
  if (j0 == j1) return;  // written by its chunk
  for (int64_t i = threadIdx.x; i < f; i += THREADS) {
    float v = partial[(j0 * 2 + 1) * f + i];
    for (int64_t j = j0 + 1; j <= j1; ++j) v += partial[(j * 2) * f + i];
    out[i] = v;
  }
}

#define KMT_CHECK()                                  \
  do {                                               \
    const cudaError_t e = cudaGetLastError();        \
    if (e != cudaSuccess) return (int)e;             \
  } while (0)

template <typename T>
int launch_segment(const void *x, const void *aid, void *iscratch,
                   void *fscratch, void *sums, void *counts, int64_t n,
                   int64_t f, int64_t k, int64_t rows, int64_t chunk,
                   int64_t tx, int64_t n_iscratch, int64_t n_fscratch,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (n < 1 || f < 1 || k < 1 || rows < k || rows % 32 || chunk < 1 ||
      tx < 1 || THREADS % tx)
    return (int)cudaErrorInvalidValue;
  const int64_t nb = (n + rows - 1) / rows;
  const int64_t nchunks = (n + chunk - 1) / chunk;
  const int64_t ty = THREADS / tx;
  const int64_t slabs = (f + tx * V - 1) / (tx * V);
  // the caller's scratch must hold the layout below
  if (n_iscratch < k * nb + k + 1 + 2 * n || n_fscratch < 2 * nchunks * f ||
      slabs > 65535 || (nchunks + ty - 1) / ty > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // integer scratch: hist (k * nb) | start (k + 1) | perm (n) | seg (n)
  int32_t *hist = (int32_t *)iscratch;
  int32_t *start = hist + k * nb;
  int32_t *perm = start + k + 1;
  int32_t *seg = perm + n;
  const size_t cnt_smem = k <= SMEM_K ? (size_t)k * 4 : 0;
  const auto a = (const int32_t *)aid;
  seg_count_kernel<<<(unsigned)nb, THREADS, cnt_smem, stream>>>(
      a, hist, n, k, rows, nb);
  KMT_CHECK();
  seg_scan_kernel<<<(unsigned)k, THREADS, 0, stream>>>(hist,
                                                       (int32_t *)counts, nb);
  KMT_CHECK();
  seg_starts_kernel<<<1, SCAN_THREADS, 0, stream>>>((const int32_t *)counts,
                                                    start, k);
  KMT_CHECK();
  seg_place_kernel<<<(unsigned)nb, THREADS, cnt_smem, stream>>>(
      a, hist, start, perm, seg, n, k, rows, nb);
  KMT_CHECK();
  const auto aligned = [](const void *p) { return (uintptr_t)p % 16 == 0; };
  const int vec = aligned(x) && (f * (int64_t)sizeof(T)) % 16 == 0;
  dim3 grid((unsigned)((nchunks + ty - 1) / ty), (unsigned)slabs);
  dim3 block((unsigned)tx, (unsigned)ty);
  seg_reduce_kernel<T><<<grid, block, 0, stream>>>(
      (const T *)x, perm, seg, start, (float *)fscratch, (float *)sums, f, k,
      chunk, nchunks, vec);
  KMT_CHECK();
  seg_fix_kernel<<<(unsigned)k, THREADS, 0, stream>>>(
      start, (const float *)fscratch, (float *)sums, f, chunk);
  KMT_CHECK();
  return 0;
}

#undef KMT_CHECK

}  // namespace

extern "C" {

// Segment sums (k, f) fp32 and counts (k,) int32 of x over `aid` (B1'),
// cut as ops/assign_kernels.segment_plan gives: `rows` rows per placement
// block (rows >= k, a multiple of 32), `chunk` sorted positions per
// reduction chunk, `tx` threads across the features (a divisor of 256).
// `iscratch` holds n_iscratch int32 and `fscratch` n_fscratch floats; the
// cut needs ceil(n / rows) * k + k + 1 + 2 n and 2 * ceil(n / chunk) * f.
// Returns cudaErrorInvalidValue for a cut it does not take or scratch too
// short for it, else the first CUDA error code of the six launches, or 0.
int kmt_segment_sum(const void *x, const void *aid, void *iscratch,
                    void *fscratch, void *sums, void *counts, int64_t n,
                    int64_t f, int64_t k, int64_t rows, int64_t chunk,
                    int64_t tx, int64_t n_iscratch, int64_t n_fscratch,
                    int64_t is_bf16, void *stream) {
  if (is_bf16)
    return launch_segment<__nv_bfloat16>(
        x, aid, iscratch, fscratch, sums, counts, n, f, k, rows, chunk, tx,
        n_iscratch, n_fscratch, (cudaStream_t)stream);
  return launch_segment<float>(x, aid, iscratch, fscratch, sums, counts, n,
                               f, k, rows, chunk, tx, n_iscratch, n_fscratch,
                               (cudaStream_t)stream);
}

}  // extern "C"
