// Hopper (sm_90a) building blocks shared by the tensor-core kernels:
// 128-byte-swizzled K-major tiles in shared memory filled by cp.async (or
// plain loads), their wgmma descriptors, the wgmma instructions, fences and
// the TF32 split of 3xTF32 products.  Used by assign.cu (kmt_assign) and
// knn_walk.cu (kmt_knn_walk).
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
// is where the loader put it.  An A operand of 64 rows starting at row 64 g
// starts at byte 8192 g, still atom-aligned.
//
// Accumulator fragment of an m64nN wgmma: thread t of the warpgroup holds
// rows 16 * (t / 32 % 4) + t % 32 / 4 + 8 h (h = 0, 1) and columns
// 8 i + 2 (t % 4) + j (j = 0, 1) in register 4 i + 2 h + j.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_BYTES = 128;    // one swizzled tile row: a feature chunk
constexpr int ATOM_BYTES = 8 * ROW_BYTES;
constexpr int KSTEP_BYTES = 32;   // depth of one wgmma: 16 bf16 or 8 tf32
constexpr int KSTEPS = ROW_BYTES / KSTEP_BYTES;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// d (+)= A . B^T for a 64 x 64 tile, one k-step of 16 bf16.
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : KMT_D8(0), KMT_D8(8), KMT_D8(16), KMT_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B^T for a 64 x 64 tile, one k-step of 8 tf32.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : KMT_D8(0), KMT_D8(8), KMT_D8(16), KMT_D8(24)
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
// f are zeros.  Thread t of NT copies the 16-byte units t + e * NT.  `vec`:
// every row starts 16-byte aligned, so a unit is one cp.async (zero-fill
// past an edge); otherwise its elements are loaded one by one and stored.
template <typename T, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint8_t *tile,
                                          const T *__restrict__ src,
                                          int64_t rows, int64_t r0,
                                          int64_t k0, int64_t f, bool vec) {
  using B = typename Bits<T>::type;
  constexpr int EPU = 16 / sizeof(T);  // elements per 16-byte unit
  const uint32_t base = smem_addr(tile);
#pragma unroll
  for (int e = 0; e < ROWS * 8 / NT; ++e) {
    const int idx = threadIdx.x + e * NT;
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

// The fp32 units this thread loaded (load_tile<float, ROWS, NT>'s
// mapping): TF32 hi in place, lo into `lo_tile` at the same offset.
template <int ROWS, int NT>
__device__ __forceinline__ void split_own_units(uint8_t *tile,
                                                uint8_t *lo_tile) {
#pragma unroll
  for (int e = 0; e < ROWS * 8 / NT; ++e) {
    const int idx = threadIdx.x + e * NT;
    const int r = idx >> 3, u = idx & 7;
    const int off = r * ROW_BYTES + ((u ^ (r & 7)) << 4);
    const float4 v = *reinterpret_cast<const float4 *>(tile + off);
    float4 hi, lo;
    hi.x = tf32_rna(v.x);
    hi.y = tf32_rna(v.y);
    hi.z = tf32_rna(v.z);
    hi.w = tf32_rna(v.w);
    lo.x = tf32_rna(v.x - hi.x);
    lo.y = tf32_rna(v.y - hi.y);
    lo.z = tf32_rna(v.z - hi.z);
    lo.w = tf32_rna(v.w - hi.w);
    *reinterpret_cast<float4 *>(tile + off) = hi;
    *reinterpret_cast<float4 *>(lo_tile + off) = lo;
  }
}

}  // namespace
