// The k-means++ / AFK-MC2 step for Hopper (sm_90a): the distance of every
// row of x to one new centroid c, folded into the running minimum.
//
// Replaces the step of the init loops of the JAX package, which XLA fuses
// there (no Pallas kernel):
//   kmcuda_tpu/ops/distance.py:point_distances (the product at :220, bf16
//   x read once with fp32 accumulation), inside the on-device fori_loop of
//   kmcuda_tpu/models/initialization.py:162-167;
// and the reference kmcuda's kmeans_plus_plus kernel (kmeans.cu:43-67).
//
// Per row i, with c rounded to the storage dtype for the product and |c|^2
// taken from the fp32 c:
//   prod = sum_j x[i][j] * c[j]                      (fp32 accumulation)
//   d    = sqrt(max(x_sq[i] - 2 prod + |c|^2, 0))     (L2)
//   d    = acos(clip(prod, -1, 1))                    (cosine)
//   first step: m[i] = valid[i] ? d : 0;   later: m[i] = minimum(m[i], d)
// (minimum as torch.minimum: a NaN in either gives NaN).  Invalid rows are
// zero rows (prepare() zeroed them) and hold 0 from the first step on.
//
// What bounds it on the H100: one read of x in its storage dtype, of x_sq
// and of valid, one read and one write of m; n * (f * size + 4 + 1 + 8)
// bytes at 3.35 TB/s (2 f operations a row are nothing beside them).  So
// the design is about bytes only: x is read once with 16-byte loads, up to
// four row groups of a warp in flight at a time (at most 32 rows, a round),
// the round's x_sq, valid and m loaded ahead by one lane per row, which
// also writes the row's m; nothing else is written.  At least four blocks
// of eight warps stay resident on an SM (64 registers a thread at most).
//
// Layout.  A row is taken by L lanes (the least power of two with L * V >=
// f, at most 32; V = 16 / sizeof(T) elements, one 16-byte chunk), so a warp
// holds 32 / L rows; lane l of a row takes chunks l, l + L, l + 2L, ... and
// sums its elements in order with fmaf, then the L lanes add by xor
// shuffles.  Rows whose 16-byte chunks are not aligned (f * size not a
// multiple of 16, or x not 16-byte aligned) load the same elements one by
// one, in the same order, so a row's distance is a pure function of the
// row, c and f: not of n, of the row's offset or of x's alignment.  c is
// read through the read-only cache and |c|^2 is summed once per block in a
// fixed order.  No atomics, no shared memory beyond |c|^2; launched on the
// caller's stream, allocates nothing.  Row offsets are 64-bit (n * f passes
// 2^31 at 40M x 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;          // row groups of a warp in flight
constexpr int MIN_BLOCKS = 4;        // resident blocks an SM must hold
constexpr int64_t MAX_BLOCKS = 16384;
constexpr unsigned FULL = 0xffffffffu;

// c rounded to the storage dtype, as a float
__device__ __forceinline__ float storage_round(float v, float) { return v; }
__device__ __forceinline__ float storage_round(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A chunk of V elements of the storage dtype, packed in 16 bytes: element
// e sits in 32-bit word e / (4 / size), at bit (e % (4 / size)) * 8 size
__device__ __forceinline__ unsigned word(const uint4 &r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}
__device__ __forceinline__ float element(const uint4 &r, int e, float) {
  return __uint_as_float(word(r, e));
}
__device__ __forceinline__ float element(const uint4 &r, int e,
                                         __nv_bfloat16) {
  // a bf16 is the high half of the float it widens to
  return __uint_as_float(((word(r, e / 2) >> (16 * (e % 2))) & 0xffffu)
                         << 16);
}
__device__ __forceinline__ void put(uint4 &r, int e, float v) {
  const unsigned b = __float_as_uint(v);
  if (e == 0) r.x = b; else if (e == 1) r.y = b; else if (e == 2) r.z = b;
  else r.w = b;
}
__device__ __forceinline__ void put(uint4 &r, int e, __nv_bfloat16 v) {
  const unsigned b = (unsigned)__bfloat16_as_ushort(v) << (16 * (e % 2));
  const int w = e / 2;
  if (w == 0) r.x |= b; else if (w == 1) r.y |= b; else if (w == 2) r.z |= b;
  else r.w |= b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    point_min_kernel(const T *__restrict__ x, const float *__restrict__ x_sq,
                     const uint8_t *__restrict__ valid,
                     const float *__restrict__ c, float *__restrict__ m,
                     int64_t n, int64_t f, int lanes, int vec, int cosine,
                     int first) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float c_sq_smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    float s = 0.f;
    for (int64_t j = lane; j < f; j += 32) s = fmaf(c[j], c[j], s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) c_sq_smem = s;
  }
  __syncthreads();
  const float c_sq = c_sq_smem;

  const int rpg = 32 / lanes;            // rows of a group (one per L lanes)
  const int sub = lane / lanes;          // this lane's row in the group
  const int part = lane % lanes;         // this lane's place in the row
  // groups in flight: at most UNROLL, and at most 32 rows, so that each
  // row of the round has a lane of its own for the epilogue
  const int nu = rpg * UNROLL <= 32 ? UNROLL : 32 / rpg;
  const int round_rows = nu * rpg;
  const int64_t nchunk = (f + (int64_t)lanes * V - 1) / ((int64_t)lanes * V);
  const int64_t stride = (int64_t)gridDim.x * WARPS * round_rows;

  for (int64_t first_row = ((int64_t)blockIdx.x * WARPS + warp) * round_rows;
       first_row < n; first_row += stride) {
    // the epilogue's inputs, one row per lane, loaded ahead
    const int64_t mine = first_row + lane;
    const bool has_row = lane < round_rows && mine < n;
    float my_sq = 0.f, my_m = 0.f;
    bool my_valid = false;
    if (has_row) {
      if (!cosine) my_sq = x_sq[mine];
      if (first)
        my_valid = valid[mine] != 0;
      else
        my_m = m[mine];
    }
    float acc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc[u] = 0.f;
    for (int64_t j = 0; j < nchunk; ++j) {
      const int64_t col = (j * lanes + part) * V;
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        const int64_t row = first_row + u * rpg + sub;
        if (u >= nu || row >= n) continue;
        const T *p = x + row * f + col;
        if (vec) {
          if (col < f) raw[u] = __ldcs(reinterpret_cast<const uint4 *>(p));
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (col + e < f) put(raw[u], e, p[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float ce =
            col + e < f ? storage_round(__ldg(c + col + e), T()) : 0.f;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          acc[u] = fmaf(element(raw[u], e, T()), ce, acc[u]);
      }
    }
    // add the L lanes of each row, then hand row u * rpg + s of the round
    // to lane u * rpg + s
    float prod = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      for (int o = lanes / 2; o > 0; o >>= 1)
        acc[u] += __shfl_xor_sync(FULL, acc[u], o);
      const float v = __shfl_sync(FULL, acc[u], (lane % rpg) * lanes);
      if (lane / rpg == u) prod = v;
    }
    if (!has_row) continue;
    float d;
    if (cosine) {
      // clip as torch.clamp: NaN passes through
      const float q = prod < -1.f ? -1.f : (prod > 1.f ? 1.f : prod);
      d = acosf(q);
    } else {
      // x_sq - 2 prod is exact in one fma (-2 prod is exact), then + |c|^2
      float t = __fadd_rn(fmaf(-2.f, prod, my_sq), c_sq);
      t = t < 0.f ? 0.f : t;
      d = __fsqrt_rn(t);
    }
    // minimum as torch.minimum: NaN if either is
    m[mine] = first ? (my_valid ? d : 0.f)
                    : ((d < my_m || d != d) ? d : my_m);
  }
}

template <typename T>
cudaError_t launch_point_min(const void *x, const void *x_sq,
                             const void *valid, const void *c, void *m,
                             int64_t n, int64_t f, int64_t cosine,
                             int64_t first, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  int lanes = 1;
  while (lanes < 32 && (int64_t)lanes * V < f) lanes <<= 1;
  const int vec = (uintptr_t)x % 16 == 0 && (f * (int64_t)sizeof(T)) % 16 == 0;
  const int rpg = 32 / lanes;
  const int64_t round_rows = rpg * UNROLL <= 32 ? rpg * UNROLL : 32;
  const int64_t warps = (n + round_rows - 1) / round_rows;
  int64_t blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  point_min_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T *)x, (const float *)x_sq, (const uint8_t *)valid,
      (const float *)c, (float *)m, n, f, lanes, vec, (int)cosine,
      (int)first);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One k-means++ / AFK-MC2 step: m <- where(valid, d, 0) when `first`, else
// minimum(m, d), d the distance of each row of x (n, f; fp32 or bf16) to
// the fp32 point c (f,).  x_sq (n,) fp32, valid (n,) bool, m (n,) fp32 in
// place.  Returns the launch's CUDA error code.
int kmt_point_min(const void *x, const void *x_sq, const void *valid,
                  const void *c, void *m, int64_t n, int64_t f,
                  int64_t is_bf16, int64_t cosine, int64_t first,
                  void *stream) {
  if (n <= 0) return 0;
  if (is_bf16)
    return (int)launch_point_min<__nv_bfloat16>(
        x, x_sq, valid, c, m, n, f, cosine, first, (cudaStream_t)stream);
  return (int)launch_point_min<float>(x, x_sq, valid, c, m, n, f, cosine,
                                      first, (cudaStream_t)stream);
}

}  // extern "C"
