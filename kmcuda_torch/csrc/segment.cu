// Segment sum for Hopper (sm_90a): the centroid sums and counts of a Lloyd
// pass, sums[a] += x_row and counts[a] += 1 over the rows with 0 <= a < k;
// and, over a list of moved rows, the delta of a sparse Lloyd iteration.
//
// kmt_segment_sum replaces the one-hot (K, F) sums and counts of the Lloyd
// Pallas kernel of the JAX package:
//   kmcuda_tpu/ops/assign_pallas.py:_kernel (fused_lloyd_pass, B1; B1')
// B1 is kmt_assign (assign.cu) followed by this.
//
// kmt_delta_sum replaces the JAX package's moved-row delta, XLA work on the
// TPU's matrix unit inside the sparse arm of lloyd_run_pallas:
//   kmcuda_tpu/ops/compact.py:delta_compacted (and its chunk_delta, a
//   one-hot difference product over chunks of 2048 compacted rows)
// It takes the moved rows as an ascending list L (m,) and gives
//   d_sums[c] = sum_{r in L, new[r] = c} x_r - sum_{r in L, old[r] = c} x_r
// with fp32 accumulation, and d_counts the same difference of counts.  It
// is the segment sum below run once over 2 m signed entries: entry p < m
// is row L[p] with id new[L[p]], adding; entry m + p is row L[p] with id
// old[L[p]], subtracting (the placement stores its row as ~L[p], the
// reduction negates the row's values).  Within a cluster the new side's
// entries come first, in list order, then the old side's: the summation
// order is a pure function of (L, new[L], old[L], f, k).  What bounds it:
// each moved row is read once a side (2 m f size bytes), beside O(m + k f)
// ids and sums; memory.
//
// Both read x once, in cluster order, and write each output once.  The
// wrapper gives the cut (ops/assign_kernels.segment_plan, a pure function
// of the shape): placement blocks of R entries (a side's entries cut alone,
// so a block holds one side), reduction chunks of C sorted positions, TX
// threads across a row's features.  Every pass is sized by the entries,
// the table or the chunks, none by k alone:
//   1. count:  block b counts its entries per cluster (shared memory when k
//      fits, else its own column of the table; integer atomics, one per run
//      of equal ids in a warp) into the cluster-major table hist[c][b].
//   2. scan:   an exclusive scan of the flattened table in two launches
//      (tile sums, then each tile's scan after the sum of the tiles before
//      it): entry [c][b] becomes the first position of block b's entries of
//      cluster c, start[c] + the entries of c in blocks before b; the
//      table's total (the entries with an id in [0, k)) follows it.
//   3. counts: counts[c] from the scanned table (the delta: the new side's
//      blocks less the old side's), and the sums zeroed, so an empty
//      cluster's row stays 0.
//   4. place:  block b writes its entries' rows into the cluster-sorted
//      permutation, in entry order within each cluster: within the block it
//      takes its entries 256 at a time, each warp ranks its lanes' equal
//      ids (__match_any_sync) and the warps take their offsets in warp
//      order.  No rank depends on scheduling, and integer positions do not
//      depend on the cut.
//   5. reduce: block (chunk group, feature slab); each of its TY rows of
//      threads takes one chunk of C sorted positions, each thread V
//      consecutive features (16 bytes), and sums every segment in ascending
//      position, gathering whole rows (16-byte loads where rows are
//      aligned).  A segment wholly inside the chunk goes straight to `sums`;
//      one that crosses a chunk edge leaves one partial per chunk (slot 0 if
//      it began before the chunk, else slot 1).
//   6. fix:    one block per chunk; the block of the chunk where a crossing
//      segment begins adds its partials in chunk order (at most one segment
//      per edge).
// No float atomics: the summation order is a pure function of (aid, n, f,
// k) and the chunk (the placement blocks move no position), so the sums
// repeat bitwise from run to run.  The cut balances skewed clusters: a
// cluster holding most of the rows spreads over many chunks.
//
// What bounds it on the H100: one read of x (n * f * size bytes) and of the
// ids, one write of the (k, f) fp32 sums: memory.  The permutation, the
// table and the partials are O(n + table + chunks * f) integers and floats;
// their traffic is a few ints per row beside the row's f values.
//
// Sizes are int64 and row offsets 64-bit (row * f passes 2^31 beyond
// 8M x 256); positions and counts are int32 (entries < 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_TILE = 4 * SCAN_THREADS;   // table entries a scan block takes
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

// The entries the segment sum runs over.  Without a list (B1'), entry p is
// row p with id aid[p].  With one (the delta), the entries come in `sides`
// runs of `side` = m: entry s m + p is row list[p] with id new[list[p]]
// (s = 0) or old[list[p]] (s = 1); a listed row outside [0, n) has no id.
struct Entries {
  const int32_t *aid, *list, *assign_new, *assign_old;
  int64_t side, n;
};

// Row and id of local entry i of side s.
__device__ __forceinline__ void entry_at(const Entries &e, int s, int64_t i,
                                         int32_t &row, int &a) {
  if (e.list == nullptr) {
    row = (int32_t)i;
    a = e.aid[i];
    return;
  }
  row = e.list[i];
  a = row >= 0 && row < e.n ? (s ? e.assign_old : e.assign_new)[row] : -1;
}

// Block b's side and its local entries [r0, r1): a side's entries are cut
// alone into blocks of `rows`, nbs blocks a side.
__device__ __forceinline__ int block_range(const Entries &e, int64_t b,
                                           int64_t rows, int64_t nbs,
                                           int64_t &r0, int64_t &r1) {
  const int s = (int)(b / nbs);
  r0 = (b - s * nbs) * rows;
  r1 = r0 + rows < e.side ? r0 + rows : e.side;
  return s;
}

__global__ void __launch_bounds__(THREADS)
seg_count_kernel(Entries e, int32_t *__restrict__ hist, int64_t k,
                 int64_t rows, int64_t nbs, int64_t nb) {
  extern __shared__ int32_t cnt_s[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool smem = k <= SMEM_K;
  int32_t *cnt = smem ? cnt_s : hist + b;
  const int64_t stride = smem ? 1 : nb;
  for (int64_t c = threadIdx.x; c < k; c += THREADS) cnt[c * stride] = 0;
  __syncthreads();
  int64_t r0, r1;
  const int side = block_range(e, b, rows, nbs, r0, r1);
  for (int64_t base = r0 + warp * 32; base < r1; base += THREADS) {
    const int64_t r = base + lane;
    int32_t row;
    int a = -1;
    if (r < r1) entry_at(e, side, r, row, a);
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

// Tile j's sum of the table's entries [j SCAN_TILE, (j + 1) SCAN_TILE).
__global__ void __launch_bounds__(SCAN_THREADS)
seg_tile_kernel(const int32_t *__restrict__ table, int32_t *__restrict__ tsum,
                int64_t len) {
  __shared__ int warp_tot[SCAN_THREADS / 32];
  const int64_t i0 = (int64_t)blockIdx.x * SCAN_TILE + 4 * threadIdx.x;
  int v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) v += i0 + e < len ? table[i0 + e] : 0;
  int total;
  block_exclusive_scan<SCAN_THREADS>(v, warp_tot, total);
  if (threadIdx.x == 0) tsum[blockIdx.x] = total;
}

// Tile j of the table in place: its exclusive prefix after the tiles before
// it; the last tile also writes the table's total to table[len].
__global__ void __launch_bounds__(SCAN_THREADS)
seg_scan_kernel(int32_t *__restrict__ table,
                const int32_t *__restrict__ tsum, int64_t len,
                int64_t ntiles) {
  __shared__ int warp_tot[SCAN_THREADS / 32];
  int before = 0;
  for (int64_t t = threadIdx.x; t < blockIdx.x; t += SCAN_THREADS)
    before += tsum[t];
  int prefix;
  block_exclusive_scan<SCAN_THREADS>(before, warp_tot, prefix);
  const int64_t i0 = (int64_t)blockIdx.x * SCAN_TILE + 4 * threadIdx.x;
  int v[4], mine = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = i0 + e < len ? table[i0 + e] : 0;
    mine += v[e];
  }
  int total;
  int run = prefix + block_exclusive_scan<SCAN_THREADS>(mine, warp_tot, total);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (i0 + e < len) table[i0 + e] = run;
    run += v[e];
  }
  if (blockIdx.x == ntiles - 1 && threadIdx.x == 0)
    table[len] = prefix + total;
}

// counts[c] from the scanned table (with two sides, the new side's blocks
// [0, nbs) less the old side's), and the (k, f) sums zeroed.
__global__ void __launch_bounds__(THREADS)
seg_counts_kernel(const int32_t *__restrict__ table,
                  int32_t *__restrict__ counts, float *__restrict__ sums,
                  int64_t k, int64_t f, int64_t nbs, int64_t nb) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < k * f;
       i += stride) {
    sums[i] = 0.f;
    if (i >= k) continue;
    const int32_t first = table[i * nb], last = table[(i + 1) * nb];
    if (nb == nbs) {
      counts[i] = last - first;
    } else {
      const int32_t mid = table[i * nb + nbs];
      counts[i] = (mid - first) - (last - mid);
    }
  }
}

// The permutation holds each position's row (~row for a subtracting entry),
// so the reduction gathers that row of x.
__global__ void __launch_bounds__(THREADS)
seg_place_kernel(Entries e, int32_t *__restrict__ hist,
                 int32_t *__restrict__ perm, int32_t *__restrict__ seg,
                 int64_t k, int64_t rows, int64_t nbs, int64_t nb) {
  extern __shared__ int32_t off_s[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool smem = k <= SMEM_K;
  // the next free position of each cluster for this block's entries (the
  // scanned table; without shared memory, its own column in place)
  int32_t *off = smem ? off_s : hist + b;
  const int64_t stride = smem ? 1 : nb;
  if (smem)
    for (int64_t c = threadIdx.x; c < k; c += THREADS)
      off_s[c] = hist[c * nb + b];
  __syncthreads();
  int64_t r0, r1;
  const int side = block_range(e, b, rows, nbs, r0, r1);
  const unsigned lower = (1u << lane) - 1u;
  for (int64_t t0 = r0; t0 < r1; t0 += THREADS) {
    const int64_t r = t0 + threadIdx.x;
    int32_t row = 0;
    int a = -1;
    if (r < r1) entry_at(e, side, r, row, a);
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
      perm[pos] = side ? ~row : row;
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

// SIGNED: the entries may subtract (the delta); B1' runs without, so its
// reduction is the unsigned one instruction for instruction.
template <typename T, bool SIGNED>
__global__ void __launch_bounds__(THREADS)
seg_reduce_kernel(const T *__restrict__ x, const int32_t *__restrict__ perm,
                  const int32_t *__restrict__ seg,
                  const int32_t *__restrict__ total,
                  float *__restrict__ partial, float *__restrict__ sums,
                  int64_t f, int64_t chunk, int64_t nchunks, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int64_t j = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t nvalid = *total;
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
        // a subtracting entry (the delta's old side) holds ~row
        const bool neg = SIGNED && rr[u] < 0;
        load_row<T, V>(v[u], x, neg ? ~rr[u] : rr[u], f, c0, vec);
        if (neg) {
#pragma unroll
          for (int i = 0; i < V; ++i) v[u][i] = -v[u][i];
        }
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

// One block per chunk: where the chunk's last segment begins in this chunk
// and runs past its end, the segment's partials in chunk order (this
// chunk's slot 1, then slot 0 of each later chunk it covers) into `sums`.
// The segment's last chunk comes first from a binary search of the sorted
// ids, so the adds' loads do not wait on one another.
__global__ void __launch_bounds__(THREADS)
seg_fix_kernel(const int32_t *__restrict__ seg,
               const int32_t *__restrict__ total,
               const float *__restrict__ partial, float *__restrict__ sums,
               int64_t f, int64_t chunk) {
  __shared__ int64_t last_s;
  const int64_t j = blockIdx.x;
  const int64_t nvalid = *total;
  const int64_t p0 = j * chunk, p1 = p0 + chunk;
  if (p1 >= nvalid) return;
  const int c = seg[p1 - 1];
  if (seg[p1] != c) return;   // the chunk's last segment ends at its edge
  if (p0 > 0 && seg[p0] == c && seg[p0 - 1] == c)
    return;                   // it began in an earlier chunk, which adds it
  if (threadIdx.x == 0) {
    // the segment's last position: seg ascends, seg[p1] == c
    int64_t lo = p1, hi = nvalid - 1;
    while (lo < hi) {
      const int64_t mid = lo + (hi - lo + 1) / 2;
      if (seg[mid] == c) lo = mid; else hi = mid - 1;
    }
    last_s = lo / chunk;
  }
  __syncthreads();
  const int64_t last = last_s;
  for (int64_t i = threadIdx.x; i < f; i += THREADS) {
    float v = partial[(j * 2 + 1) * f + i];
#pragma unroll 8
    for (int64_t q = j + 1; q <= last; ++q) v += partial[(q * 2) * f + i];
    sums[(int64_t)c * f + i] = v;
  }
}

#define KMT_CHECK()                                  \
  do {                                               \
    const cudaError_t err = cudaGetLastError();      \
    if (err != cudaSuccess) return (int)err;         \
  } while (0)

// The segment sum of x over the entries `e` (`sides` runs of e.side; see
// Entries): sums (k, f) fp32, counts (k,) int32 (with two sides, the first
// side's less the second's).  The cut: `rows` entries a placement block,
// `chunk` sorted positions a reduction chunk, `tx` threads across f.
template <typename T>
int launch_segment(const void *x, const Entries &e, int sides,
                   void *iscratch, void *fscratch, void *sums, void *counts,
                   int64_t f, int64_t k, int64_t rows, int64_t chunk,
                   int64_t tx, int64_t n_iscratch, int64_t n_fscratch,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t total = sides * e.side;
  // row ids and positions are int32
  if (e.side < 1 || total > INT32_MAX || e.n > INT32_MAX || f < 1 || k < 1 ||
      rows < 32 || rows % 32 || chunk < 1 || tx < 1 || THREADS % tx)
    return (int)cudaErrorInvalidValue;
  const int64_t nbs = (e.side + rows - 1) / rows;
  const int64_t nb = sides * nbs;
  const int64_t len = k * nb;
  const int64_t ntiles = (len + SCAN_TILE - 1) / SCAN_TILE;
  const int64_t nchunks = (total + chunk - 1) / chunk;
  const int64_t ty = THREADS / tx;
  const int64_t slabs = (f + tx * V - 1) / (tx * V);
  // the caller's scratch must hold the layout below
  if (n_iscratch < len + 1 + ntiles + 2 * total ||
      n_fscratch < 2 * nchunks * f || slabs > 65535 || nb > 0x7fffffff ||
      ntiles > 0x7fffffff || (nchunks + ty - 1) / ty > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // integer scratch: table (len + its total) | tile sums | perm | seg
  int32_t *table = (int32_t *)iscratch;
  int32_t *tsum = table + len + 1;
  int32_t *perm = tsum + ntiles;
  int32_t *seg = perm + total;
  const size_t cnt_smem = k <= SMEM_K ? (size_t)k * 4 : 0;
  seg_count_kernel<<<(unsigned)nb, THREADS, cnt_smem, stream>>>(
      e, table, k, rows, nbs, nb);
  KMT_CHECK();
  seg_tile_kernel<<<(unsigned)ntiles, SCAN_THREADS, 0, stream>>>(table, tsum,
                                                                 len);
  KMT_CHECK();
  seg_scan_kernel<<<(unsigned)ntiles, SCAN_THREADS, 0, stream>>>(
      table, tsum, len, ntiles);
  KMT_CHECK();
  const int64_t zblocks = (k * f + THREADS - 1) / THREADS;
  seg_counts_kernel<<<(unsigned)(zblocks < 4096 ? zblocks : 4096), THREADS, 0,
                      stream>>>(table, (int32_t *)counts, (float *)sums, k, f,
                                nbs, nb);
  KMT_CHECK();
  seg_place_kernel<<<(unsigned)nb, THREADS, cnt_smem, stream>>>(
      e, table, perm, seg, k, rows, nbs, nb);
  KMT_CHECK();
  const auto aligned = [](const void *p) { return (uintptr_t)p % 16 == 0; };
  const int vec = aligned(x) && (f * (int64_t)sizeof(T)) % 16 == 0;
  dim3 grid((unsigned)((nchunks + ty - 1) / ty), (unsigned)slabs);
  dim3 block((unsigned)tx, (unsigned)ty);
  if (sides == 1)
    seg_reduce_kernel<T, false><<<grid, block, 0, stream>>>(
        (const T *)x, perm, seg, table + len, (float *)fscratch,
        (float *)sums, f, chunk, nchunks, vec);
  else
    seg_reduce_kernel<T, true><<<grid, block, 0, stream>>>(
        (const T *)x, perm, seg, table + len, (float *)fscratch,
        (float *)sums, f, chunk, nchunks, vec);
  KMT_CHECK();
  seg_fix_kernel<<<(unsigned)nchunks, THREADS, 0, stream>>>(
      seg, table + len, (const float *)fscratch, (float *)sums, f, chunk);
  KMT_CHECK();
  return 0;
}

#undef KMT_CHECK

int segment_sum(const void *x, const Entries &e, int sides, void *iscratch,
                void *fscratch, void *sums, void *counts, int64_t f,
                int64_t k, int64_t rows, int64_t chunk, int64_t tx,
                int64_t n_iscratch, int64_t n_fscratch, int64_t is_bf16,
                void *stream) {
  if (is_bf16)
    return launch_segment<__nv_bfloat16>(
        x, e, sides, iscratch, fscratch, sums, counts, f, k, rows, chunk, tx,
        n_iscratch, n_fscratch, (cudaStream_t)stream);
  return launch_segment<float>(x, e, sides, iscratch, fscratch, sums, counts,
                               f, k, rows, chunk, tx, n_iscratch, n_fscratch,
                               (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Segment sums (k, f) fp32 and counts (k,) int32 of x over `aid` (B1'),
// cut as ops/assign_kernels.segment_plan gives: `rows` entries per
// placement block (a multiple of 32), `chunk` sorted positions per
// reduction chunk, `tx` threads across the features (a divisor of 256).
// `iscratch` holds n_iscratch int32 and `fscratch` n_fscratch floats; the
// cut needs k nb + 1 + ceil(k nb / 4096) + 2 n (nb = ceil(n / rows)) and
// 2 ceil(n / chunk) f.  Returns cudaErrorInvalidValue for n >= 2^31 rows, a
// cut it does not take or scratch too short for it, else the first CUDA
// error code of its launches, or 0.
int kmt_segment_sum(const void *x, const void *aid, void *iscratch,
                    void *fscratch, void *sums, void *counts, int64_t n,
                    int64_t f, int64_t k, int64_t rows, int64_t chunk,
                    int64_t tx, int64_t n_iscratch, int64_t n_fscratch,
                    int64_t is_bf16, void *stream) {
  const Entries e{(const int32_t *)aid, nullptr, nullptr, nullptr, n, n};
  return segment_sum(x, e, 1, iscratch, fscratch, sums, counts, f, k,
                            rows, chunk, tx, n_iscratch, n_fscratch, is_bf16,
                            stream);
}

// The centroid delta of a sparse Lloyd iteration: d_sums (k, f) fp32 and
// d_counts (k,) int32 over the m >= 1 rows of the ascending int32 list
// `rows` of x (n, f): rows with assign_new = c add, rows with assign_old = c
// subtract; ids outside [0, k) add nothing.  One segment sum over the 2 m
// signed entries, cut as ops/assign_kernels.segment_plan(m, f, k, size,
// sides=2) gives (`rows_per_block` entries of one side a block); the
// scratch holds n_iscratch int32 and n_fscratch floats, at least k nb + 1 +
// ceil(k nb / 4096) + 4 m (nb = 2 ceil(m / rows_per_block)) and
// 2 ceil(2 m / chunk) f.  Returns cudaErrorInvalidValue for m < 1, m > n,
// 2 m >= 2^31, a cut it does not take or scratch too short, else the first
// CUDA error code of its launches, or 0.
int kmt_delta_sum(const void *x, const void *rows, const void *assign_new,
                  const void *assign_old, void *iscratch, void *fscratch,
                  void *d_sums, void *d_counts, int64_t n, int64_t m,
                  int64_t f, int64_t k, int64_t rows_per_block,
                  int64_t chunk, int64_t tx, int64_t n_iscratch,
                  int64_t n_fscratch, int64_t is_bf16, void *stream) {
  if (m < 1 || m > n)
    return (int)cudaErrorInvalidValue;
  const Entries e{nullptr, (const int32_t *)rows,
                  (const int32_t *)assign_new, (const int32_t *)assign_old,
                  m, n};
  return segment_sum(x, e, 2, iscratch, fscratch, d_sums, d_counts, f,
                            k, rows_per_block, chunk, tx, n_iscratch,
                            n_fscratch, is_bf16, stream);
}

}  // extern "C"
