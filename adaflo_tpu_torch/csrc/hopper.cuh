// Asynchronous copies, barriers and the tensor memory accelerator (TMA) of
// NVIDIA Hopper (sm_90a), shared by the port's CUDA sources
// (coupled_matvec.cu, probe_kernels.cu).
//
// Under ADAFLO_EMULATED (the CPU tests' g++ build, tests/torch_emulation.py:
// one thread per block) every copy is a plain copy that writes what the
// hardware would write (the TMA tile with its 128-byte swizzle included), and
// every barrier and fence is a no-op.

#pragma once

#include <stdint.h>
#ifdef ADAFLO_EMULATED
#include <cmath>
#else
#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)
#include <cuda_bf16.h>
#endif

namespace {

#ifndef ADAFLO_EMULATED
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
#endif

// ---- asynchronous copies into shared memory: cp.async (sm_80), bulk
//      copies and mbarriers (sm_90) ------------------------------------------
template <typename T>
__device__ __forceinline__ void async_copy(T* dst, const T* src, bool zero) {
#ifdef ADAFLO_EMULATED
  *dst = zero ? T(0) : *src;
#else
  // .ca: .cg takes only 16-byte copies; a source size of 0 zero-fills
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(zero ? 0u : (unsigned)sizeof(T)) : "memory");
#endif
}

__device__ __forceinline__ void async_commit() {
#ifndef ADAFLO_EMULATED
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void async_wait() {
#ifndef ADAFLO_EMULATED
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
#ifndef ADAFLO_EMULATED
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// this thread's arrival, with the bytes its bulk copies bring
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar, unsigned bytes) {
#ifndef ADAFLO_EMULATED
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(bytes) : "memory");
#endif
}

// this thread's arrival, no bytes
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
#ifndef ADAFLO_EMULATED
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b) : "memory");
#endif
}

// wait for the completion of the barrier's phase of this parity; a wait of
// more than 2^34 clocks (seconds) is a deadlock, and traps: the launch then
// fails with an error instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
#ifndef ADAFLO_EMULATED
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
    if (done) break;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
#endif
}

// 1D bulk copy (TMA) of `bytes` (a multiple of 16) from 16-byte aligned
// global to 16-byte aligned shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
#ifdef ADAFLO_EMULATED
  memcpy(dst, src, bytes);
#else
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
#endif
}

// ---- roundings spelled out ----------------------------------------------------
// x y + z with one rounding, and x y rounded on its own: where the order of
// a result's roundings must not be left to the compiler's contraction
template <typename T>
__device__ __forceinline__ T fma_rn(T x, T y, T z) {
#ifdef ADAFLO_EMULATED
  return std::fma(x, y, z);
#else
  if constexpr (sizeof(T) == 8) return __fma_rn(x, y, z);
  else return __fmaf_rn(x, y, z);
#endif
}
template <typename T>
__device__ __forceinline__ T mul_rn(T x, T y) {
#ifdef ADAFLO_EMULATED
  return x * y;
#else
  if constexpr (sizeof(T) == 8) return __dmul_rn(x, y);
  else return __fmul_rn(x, y);
#endif
}

// ---- a value in a form of its own ------------------------------------------------
// x with (zero & salt) or-ed into its low 32 bits by one LOP3: x itself, as
// zero is 0, but the compiler cannot know that (zero derives from a kernel
// argument that is 0 at every launch), and calls with different salts are
// different expressions, so neither nvcc nor ptxas merges what is computed
// from them. K7 takes each statement's first coefficient through it, so
// that its repeated statements are all computed. (An empty asm register
// pass, asm volatile("" : "+f"(x)), does not do it: nvcc copies the value
// into the asm's register, and ptxas sees through the copy and merges the
// statements.) The g++ build of the CPU tests computes the same bits in
// C++.
template <typename T>
__device__ __forceinline__ T salted(T x, unsigned zero, unsigned salt) {
#ifdef ADAFLO_EMULATED
  if constexpr (sizeof(T) == 8) {
    uint64_t b;
    memcpy(&b, &x, 8);
    b |= zero & salt;
    memcpy(&x, &b, 8);
  } else {
    uint32_t b;
    memcpy(&b, &x, 4);
    b |= zero & salt;
    memcpy(&x, &b, 4);
  }
  return x;
#else
  if constexpr (sizeof(T) == 8) {
    double y;
    asm("{\n.reg .b32 lo, hi;\nmov.b64 {lo, hi}, %1;\nlop3.b32 lo, %2, %3, lo, 0xEA;\n"
        "mov.b64 %0, {lo, hi};\n}\n"
        : "=d"(y) : "d"(x), "r"(zero), "r"(salt));
    return y;
  } else {
    unsigned b = __float_as_uint(x);
    asm("lop3.b32 %0, %1, %2, %0, 0xEA;\n" : "+r"(b) : "r"(zero), "r"(salt));  // (a & b) | c
    return __uint_as_float(b);
  }
#endif
}

// ---- barriers of a subset of the block and fences ---------------------------
// named barrier `id` (1..15; 0 is __syncthreads) over `count` threads, a
// multiple of 32
__device__ __forceinline__ void named_sync(int id, int count) {
#ifndef ADAFLO_EMULATED
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
#endif
}

__device__ __forceinline__ void warp_sync() {
#ifndef ADAFLO_EMULATED
  __syncwarp();
#endif
}

// this thread's writes to shared memory (generic proxy) made visible to the
// async proxy (TMA, wgmma)
__device__ __forceinline__ void fence_proxy_async() {
#ifndef ADAFLO_EMULATED
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// ---- the 128-byte swizzle ----------------------------------------------------
// TMA's CU_TENSOR_MAP_SWIZZLE_128B and wgmma's 128B layout (PTX ISA,
// "Tensor swizzling modes"; CuTe Swizzle<3,4,3>): in shared memory rows of
// 128 bytes, byte address bits [4, 7) (the 16-byte unit of the row) are
// XORed with bits [7, 10) (the row mod 8), within 1024-byte aligned atoms of
// 8 rows. The offset of `byte` of `row` from a 1024-byte aligned base:
__host__ __device__ constexpr int swz128(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// ---- 2D tiles by the TMA -------------------------------------------------------
// A tile map describes a row-major (rows, cols) array and a box of 128 bytes
// of a row x box_rows rows; a load of the box at column x, row y lands in
// shared memory as box_rows rows of 128 bytes, 128-byte swizzled, and a
// store writes such rows back.
#ifdef ADAFLO_EMULATED
struct TileMap {
  const unsigned char* base;
  long long ld;  // row stride in bytes
  int elem;      // bytes of an element
  int box_rows;
};
#else
using TileMap = CUtensorMap;
#endif

// the box at (column x, row y) into 1024-byte aligned `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const TileMap* map, int x, int y,
                                            uint64_t* bar) {
#ifdef ADAFLO_EMULATED
  unsigned char* d = (unsigned char*)dst;
  for (int r = 0; r < map->box_rows; ++r)
    for (int u = 0; u < 8; ++u)
      memcpy(d + swz128(r, 16 * u), map->base + (y + r) * map->ld + (long long)x * map->elem + 16 * u,
             16);
#else
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar)) : "memory");
#endif
}

// the box at (column x, row y) from 1024-byte aligned `src`, 128-byte
// swizzled as tma_load_2d leaves it, under the L2 cache policy `policy`
// (createpolicy); completes in this thread's bulk group
__device__ __forceinline__ void tma_store_2d(const TileMap* map, int x, int y, const void* src,
                                             uint64_t policy) {
#ifdef ADAFLO_EMULATED
  (void)policy;
  const unsigned char* s = (const unsigned char*)src;
  unsigned char* base = const_cast<unsigned char*>(map->base);
  for (int r = 0; r < map->box_rows; ++r)
    for (int u = 0; u < 8; ++u)
      memcpy(base + (y + r) * map->ld + (long long)x * map->elem + 16 * u, s + swz128(r, 16 * u),
             16);
#else
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%1, %2}], [%3], "
      "%4;\n" ::"l"(map), "r"(x), "r"(y), "r"(smem_u32(src)), "l"(policy) : "memory");
#endif
}

// an L2 cache policy that evicts first what it covers: for an output written
// once and not read again
__device__ __forceinline__ uint64_t l2_evict_first() {
#ifdef ADAFLO_EMULATED
  return 0;
#else
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
#endif
}

__device__ __forceinline__ void bulk_commit() {
#ifndef ADAFLO_EMULATED
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
#ifndef ADAFLO_EMULATED
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
#endif
}

#ifndef ADAFLO_EMULATED
template <typename T>
struct TmaType;
template <>
struct TmaType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct TmaType<double> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
};
template <>
struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver (libcuda) function, through the runtime's
// entry-point query, so that the library links nothing beyond the runtime
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}
#endif

// The tile map of the row-major (rows, cols) array of T at `base` (16-byte
// aligned, cols * sizeof(T) a multiple of 16), boxes of 128 bytes x box_rows.
template <typename T>
int make_tile_map(TileMap* map, const void* base, long long cols, int rows, int box_rows) {
#ifdef ADAFLO_EMULATED
  (void)rows;
  *map = TileMap{(const unsigned char*)base, cols * (long long)sizeof(T), (int)sizeof(T), box_rows};
  return 0;
#else
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, TmaType<T>::value, 2, const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
#endif
}

}  // namespace
