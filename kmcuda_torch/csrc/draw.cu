// The weighted draw of a k-means++ step for Hopper (sm_90a): one row index
// ~ Categorical(w) by inverse CDF, in a summation order fixed by n alone.
//
// Replaces the draw of the init loops, which the JAX package leaves to XLA
// (no Pallas kernel):
//   kmcuda_tpu/models/initialization.py:87 _weighted_draw (block sums, a
//   cumsum of them, a searchsorted, one block's cumsum and searchsorted),
// and the port's earlier torch composition of the same (kept as
// chip_profile.py torch_weighted_draw), whose torch.cumsum on a CUDA tensor
// adds its prefixes in an order that scheduling sets, so a draw near a row
// boundary moved from run to run.
//
// Contract (ops/init_kernels.weighted_draw_reference is the plain twin and
// gives the same index bitwise): w (n,) fp32 >= 0, valid (n,) bool, u (1,)
// fp32 in [0, 1).  total = the sum of w; if total is not > 0 (every valid
// row already chosen) the draw runs over valid (as 0/1) instead.  t = u *
// total, held below the total, so a row of weight 0 is never drawn while
// any weight is positive.
//
// The order.  The rows form a fixed tree: quads of 4 rows, lines of 32
// quads, chunks of 32 lines (C = 4096 rows, the last chunk ragged: rows past
// n weigh 0), groups of R = ceil(P / 1024) consecutive chunk partials (P =
// ceil(n / C)), 32 supergroups of 32 groups, the root over the 32
// supergroups.  Every node's value is its children's values added left to
// right from 0 in fp32: (((0 + v0) + v1) + ...).  The pick descends from
// the root: at a node, t is held below the node's own total (the largest
// float under it), the child is the first whose running sum exceeds t (the
// last child if none does, which only NaN or inf weights give), and t
// loses the running sum before that child.  A running sum over
// non-negative values never falls, and a child of value 0 leaves it
// unchanged, so a zero-weight child is never taken, and t never leaves the
// chosen child.  No float atomics, no library scan: the index is a
// function of (w, valid, u) and n only.
//
// Launch 1 (P blocks of 1024 threads): block j sums chunk j into partial[j]
// (thread q its quad, warp l its line by a shuffle chain, warp 0 the
// chunk) and counts its valid rows into vcount[j] (int32, exact).
// Launch 2 (one block of 1024 threads): the group and supergroup sums, the
// root's total (over the counts if the weights' total is not > 0), the
// descent to a chunk; the chunk's quads and lines again from w (or valid);
// the descent to a row.  It writes the int64 index and, when given x and
// out_row, copies row x[index] (fp32 or bf16 storage) as fp32 into out_row.
//
// What bounds it on the H100: one read of w (4 n bytes), one of valid (n
// bytes, needed only when the weights are all zero), one row: memory.  A
// simple design: launch 1 reads 16 + 4 bytes a thread; launch 2 is a few
// microseconds of one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 4096;     // rows a partial covers
constexpr int THREADS = 1024;   // a thread a quad of 4 rows
constexpr int GROUPS = 1024;    // the root's leaves: 32 supergroups x 32
constexpr unsigned FULL = 0xffffffffu;

// Running sums over the warp's lanes continuing from `carry`: lane l gets
// (((carry + v_0) + v_1) + ... + v_l), every lane the total in `total`.
__device__ __forceinline__ float chain(float carry, float v, float &total) {
  const int lane = threadIdx.x & 31;
  float c = carry, mine = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    c = __fadd_rn(c, __shfl_sync(FULL, v, i));
    if (lane == i) mine = c;
  }
  total = c;
  return mine;
}

// The pick at one node, by one warp (all lanes call, with the same t): the
// node's `count` >= 1 children val(0..count-1), summed left to right from
// 0.  Returns the child and leaves t relative to it (see the header).
template <typename F>
__device__ int64_t node_pick(F val, int64_t count, float &t) {
  const int lane = threadIdx.x & 31;
  float carry = 0.f, total;
  for (int64_t s = 0; s < count; s += 32) {
    chain(carry, s + lane < count ? val(s + lane) : 0.f, total);
    carry = total;
  }
  const float lim = nextafterf(carry, 0.f);
  t = t < lim ? t : lim;
  carry = 0.f;
  float last_before = 0.f;   // the running sum before the last child
  for (int64_t s = 0; s < count; s += 32) {
    const float mine =
        chain(carry, s + lane < count ? val(s + lane) : 0.f, total);
    const unsigned hit = __ballot_sync(FULL, mine > t);
    if (hit) {
      const int i = __ffs(hit) - 1;
      const float prev = __shfl_sync(FULL, mine, i > 0 ? i - 1 : 0);
      t = __fsub_rn(t, i > 0 ? prev : carry);
      return s + i;
    }
    const int64_t pen = count - 2 - s;   // the second-to-last child's lane
    const float at_pen = __shfl_sync(FULL, mine, pen >= 0 && pen < 32
                                                     ? (int)pen : 0);
    if (pen >= 0 && pen < 32) last_before = at_pen;
    else if (pen == -1) last_before = carry;
    carry = total;
  }
  t = __fsub_rn(t, last_before);
  return count - 1;
}

// Leaf i of the draw: w[i], or valid[i] as 0/1; 0 past n.
__device__ __forceinline__ float leaf(const float *__restrict__ w,
                                      const uint8_t *__restrict__ valid,
                                      int64_t i, int64_t n, bool use_valid) {
  if (i >= n) return 0.f;
  return use_valid ? (valid[i] ? 1.f : 0.f) : w[i];
}

__global__ void __launch_bounds__(THREADS)
    draw_partials_kernel(const float *__restrict__ w,
                         const uint8_t *__restrict__ valid,
                         float *__restrict__ partial,
                         int32_t *__restrict__ vcount, int64_t n, int vec) {
  __shared__ float line_s[32];
  __shared__ int count_s[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * CHUNK + 4 * threadIdx.x;
  float v[4];
  int nv = 0;
  if (vec && r0 + 3 < n) {
    const float4 a = __ldg(reinterpret_cast<const float4 *>(w + r0));
    const uchar4 b = *reinterpret_cast<const uchar4 *>(valid + r0);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    nv = (b.x != 0) + (b.y != 0) + (b.z != 0) + (b.w != 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = r0 + e < n ? w[r0 + e] : 0.f;
      nv += r0 + e < n && valid[r0 + e] != 0;
    }
  }
  float quad = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) quad = __fadd_rn(quad, v[e]);
  float line;
  chain(0.f, quad, line);
  nv = __reduce_add_sync(FULL, nv);
  if (lane == 0) {
    line_s[warp] = line;
    count_s[warp] = nv;
  }
  __syncthreads();
  if (warp == 0) {
    float total;
    chain(0.f, line_s[lane], total);
    const int cnt = __reduce_add_sync(FULL, count_s[lane]);
    if (lane == 0) {
      partial[blockIdx.x] = total;
      vcount[blockIdx.x] = cnt;
    }
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ void copy_row(const T *__restrict__ x, float *__restrict__ out,
                         int64_t idx, int64_t f) {
  for (int64_t c = threadIdx.x; c < f; c += THREADS)
    out[c] = to_float<T>(x[idx * f + c]);
}

__global__ void __launch_bounds__(THREADS)
    draw_pick_kernel(const float *__restrict__ w,
                     const uint8_t *__restrict__ valid,
                     const float *__restrict__ u,
                     const float *__restrict__ partial,
                     const int32_t *__restrict__ vcount,
                     int64_t *__restrict__ idx_out, const void *x,
                     float *__restrict__ out_row, int64_t n, int64_t f,
                     int is_bf16) {
  __shared__ float group_s[GROUPS];
  __shared__ float super_s[32];
  __shared__ float quad_s[THREADS];
  __shared__ float line_s[32];
  __shared__ float total_s, t_s;
  __shared__ int64_t chunk_s, idx_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t P = (n + CHUNK - 1) / CHUNK;
  const int64_t R = (P + GROUPS - 1) / GROUPS;
  bool use_valid = false;
  for (;;) {
    // group g: its R partials in order; supergroup s: its 32 groups
    float g = 0.f;
    for (int64_t i = 0; i < R; ++i) {
      const int64_t j = threadIdx.x * R + i;
      const float p =
          j < P ? (use_valid ? (float)vcount[j] : partial[j]) : 0.f;
      g = __fadd_rn(g, p);
    }
    group_s[threadIdx.x] = g;
    float sup;
    chain(0.f, g, sup);
    if (lane == 0) super_s[warp] = sup;
    __syncthreads();
    if (warp == 0) {
      float total;
      chain(0.f, super_s[lane], total);
      if (lane == 0) total_s = total;
    }
    __syncthreads();
    if (total_s > 0.f || use_valid) break;
    use_valid = true;   // no positive weight: draw over the valid rows
    __syncthreads();
  }
  if (warp == 0) {
    float t = __fmul_rn(u[0], total_s);
    const int64_t s = node_pick([&](int64_t i) { return super_s[i]; }, 32, t);
    const int64_t g =
        s * 32 + node_pick([&](int64_t i) { return group_s[s * 32 + i]; },
                           32, t);
    const int64_t j =
        g * R + node_pick(
                    [&](int64_t i) {
                      const int64_t c = g * R + i;
                      return c < P ? (use_valid ? (float)vcount[c]
                                                : partial[c])
                                   : 0.f;
                    },
                    R, t);
    if (lane == 0) {
      chunk_s = j;
      t_s = t;
    }
  }
  __syncthreads();
  // the chosen chunk's quads and lines, as launch 1 summed them
  const int64_t base = chunk_s * CHUNK;
  float quad = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    quad = __fadd_rn(quad, leaf(w, valid, base + 4 * threadIdx.x + e, n,
                                use_valid));
  quad_s[threadIdx.x] = quad;
  float line;
  chain(0.f, quad, line);
  if (lane == 0) line_s[warp] = line;
  __syncthreads();
  if (warp == 0) {
    float t = t_s;
    const int64_t l = node_pick([&](int64_t i) { return line_s[i]; }, 32, t);
    const int64_t q = node_pick(
        [&](int64_t i) { return quad_s[l * 32 + i]; }, 32, t);
    const int64_t first = base + l * 128 + q * 4;
    const int64_t r = node_pick(
        [&](int64_t i) { return leaf(w, valid, first + i, n, use_valid); }, 4,
        t);
    const int64_t idx = first + r < n ? first + r : n - 1;
    if (lane == 0) {
      *idx_out = idx;
      idx_s = idx;
    }
  }
  if (out_row == nullptr) return;
  __syncthreads();
  if (is_bf16)
    copy_row((const __nv_bfloat16 *)x, out_row, idx_s, f);
  else
    copy_row((const float *)x, out_row, idx_s, f);
}

}  // namespace

extern "C" {

// One weighted draw (see above): idx (1,) int64 <- the drawn row of w (n,)
// fp32 >= 0 (over valid (n,) bool when no weight is positive) at the
// uniform u (1,) fp32; with x (n, f) (fp32, or bf16 when is_bf16) and
// out_row (f,) fp32, also out_row <- x[idx] as fp32.  `scratch` holds
// n_scratch int32, at least 2 ceil(n / 4096) (the partials and the valid
// counts).  Two launches on `stream`; returns cudaErrorInvalidValue for
// n < 1, short scratch or only one of x / out_row, else the first CUDA
// error code of the launches, or 0.
int kmt_weighted_draw(const void *w, const void *valid, const void *u,
                      void *scratch, void *idx, const void *x, void *out_row,
                      int64_t n, int64_t f, int64_t is_bf16,
                      int64_t n_scratch, void *stream) {
  const int64_t P = (n + CHUNK - 1) / CHUNK;
  if (n < 1 || P > 0x7fffffff || n_scratch < 2 * P ||
      (x == nullptr) != (out_row == nullptr) || (x != nullptr && f < 1))
    return (int)cudaErrorInvalidValue;
  float *partial = (float *)scratch;
  int32_t *vcount = (int32_t *)scratch + P;
  const int vec = (uintptr_t)w % 16 == 0 && (uintptr_t)valid % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  draw_partials_kernel<<<(unsigned)P, THREADS, 0, s>>>(
      (const float *)w, (const uint8_t *)valid, partial, vcount, n, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  draw_pick_kernel<<<1, THREADS, 0, s>>>(
      (const float *)w, (const uint8_t *)valid, (const float *)u, partial,
      vcount, (int64_t *)idx, x, (float *)out_row, n, f, (int)is_bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
