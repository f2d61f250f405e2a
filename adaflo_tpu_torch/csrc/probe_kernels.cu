// Contraction-rate and matrix-unit probes for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's probe scripts:
//   K7  scripts/probe_sf.py:83   run_vpu.kernel     row_fma_kernel
//   K8  scripts/probe_sf.py:142  run_copies.kernel  row_copies_kernel
//   K9  scripts/probe_sf.py:169  run_mxu.kernel     dense_dot_kernel, resident
//   K10 scripts/probe_sf.py:295  run_sfeval.kernel  sf_eval_kernel
//   K5  scripts/probe_mxu.py:93  pkern (pall)       dense_dot_kernel, streamed
//
// The JAX probes (except K5) re-run one VMEM-resident block at every grid
// step, so their time is compute alone. Here a grid step is not a loop
// (identical work inside one thread would be hoisted): every kernel is
// launched over steps x column tiles thread blocks, each of which loads its
// columns (with the halo of its shifts) from L2 into shared memory or
// registers and does one step's work on them. Every step writes the same
// output with the same values, as the TPU kernels do. Timing two work levels
// (the probe drivers' slopes) cancels the loads, as it cancelled the TPU's
// refetch.
//
// The work must survive the compiler. The JAX statements repeat themselves
// (K7's statement k and k + 8 read the same rows, and k + 24 also at the
// same shift; K10's qy and qx planes compute the same values), and Mosaic
// runs every one. Here every statement reads its operands from shared memory
// through a volatile pointer, so nvcc loads and computes every statement:
// the rate measured is that of FMA statements fed from shared memory, the
// counterpart of VMEM-fed VPU statements. (An empty asm with a memory
// clobber between the statements did not do it: nvcc still merged K7's,
// 24 LDS for 96 statements.) K10 stores every q row it computes, so no stage
// is dead. The instruction counts per instance are in PERF.md
// (scripts/sass_counts.py).
//
// Bounds on an H100 SXM at its 700 W limit (NVIDIA data sheet): 3.35 TB/s
// HBM3; 67 TFLOP/s float32 and 34 TFLOP/s float64 on the CUDA cores; 495
// TFLOP/s TF32, 989 bf16 and 67 float64 (DMMA) on the tensor cores. The
// probe drivers (adaflo_tpu_torch/scripts/probe_sf.py, probe_mxu.py) compute
// each configuration's bound from its shapes (scripts/probe_bounds.py).
//
// All kernels are strided loops over their work items, so that the g++
// emulation of the CPU tests (one thread per block) runs them; the tensor-core
// passes (mma.sync) are inline PTX, which that emulation cannot run, and are
// left out under ADAFLO_EMULATED, where their C entries return an error.

#include <cuda_runtime.h>
#include <stdint.h>
#ifndef ADAFLO_EMULATED
#include <cuda_bf16.h>
#endif

namespace {

constexpr int kTile = 64;  // output columns of one thread block
constexpr int kSY = 2401;  // flat z stride of the 49^3 anchor raster
constexpr int kSX = 49;    // flat y stride

template <typename T>
__device__ __forceinline__ T* shared_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

template <typename K>
int allow_shared(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// ---------------------------------------------------------------------------
// K7: N_OPS three-term row statements,
//   acc += 0.31 x[r0 + r, c + sh] + 0.47 x[r0 + 8 + r, c] + 0.22 x[r0 + 16 + r, c]
// over the (24, block) output, r0 = (24 k) mod 64, sh = 1 + k mod 3 when
// SHIFTED, from a (96, block + 128) input.
// Bound: operations, (6 N_OPS - 1) flops per output element and step. Each
// statement reads three operands from shared memory for six flops, so shared
// memory (128 B per clock per SM) feeds the FMA units below their peak.
// Design: a block stages the 96 rows of its 64 columns (+3 for the shift) in
// shared memory; a thread keeps 6 of the 24 rows of one column in registers
// and reads every operand of every statement from shared memory.
constexpr int kFmaRows = 24, kFmaIn = 96, kFmaHalo = 3, kFmaThreads = 256;

template <typename T, int N_OPS, bool SHIFTED>
__global__ void __launch_bounds__(kFmaThreads)
row_fma_kernel(const T* __restrict__ x, T* __restrict__ out, int ldx, int block,
               int tiles) {
  constexpr int W = kTile + kFmaHalo;
  constexpr int RG = kFmaRows / 4;  // rows per work item
  T* s = shared_base<T>();
  const volatile T* vs = s;  // every statement loads its operands
  const int c0 = (int)(blockIdx.x % tiles) * kTile;  // blockIdx.x / tiles: the step
  for (int i = threadIdx.x; i < kFmaIn * W; i += blockDim.x)
    s[i] = x[(long long)(i / W) * ldx + c0 + i % W];
  __syncthreads();
  for (int w = threadIdx.x; w < kTile * 4; w += blockDim.x) {
    const int col = w % kTile, rg = w / kTile;
    T acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = T(0);
#pragma unroll
    for (int k = 0; k < N_OPS; ++k) {
      const int r0 = (k * kFmaRows) % 64;
      const int sh = SHIFTED ? 1 + k % 3 : 0;
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const int r = rg + 4 * i;
        const T a = vs[(r0 + r) * W + col + sh];
        const T b = vs[(r0 + 8 + r) * W + col];
        const T c = vs[(r0 + 16 + r) * W + col];
        acc[i] += T(0.31) * a + T(0.47) * b + T(0.22) * c;
      }
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) out[(long long)(rg + 4 * i) * block + c0 + col] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// K8: out[k, c] = x[row_k, off_k + c] for the first N_ROWS entries of the
// 89-entry parity rows table of scripts/probe_sf.py:128-140: 3 components x
// 27 Q2 nodes (parity row c 8 + 4 (z%2) + 2 (y%2) + x%2, offset
// (z/2) 2401 + (y/2) 49 + x/2), then 8 Q1 nodes of row 24.
// Bound: bytes (a copy). Design: the table is compile-time (copy_row,
// copy_off), so every copy is a load and a store at a constant offset; one
// thread per column, consecutive threads on consecutive addresses.
__host__ __device__ constexpr int copy_row(int k) {
  return k < 81 ? (k / 27) * 8 + 4 * ((k % 27 / 9) % 2) + 2 * ((k % 9 / 3) % 2) + (k % 3) % 2
                : 24;
}
__host__ __device__ constexpr int copy_off(int k) {
  return k < 81 ? (k % 27 / 9 / 2) * kSY + (k % 9 / 3 / 2) * kSX + (k % 3) / 2
                : ((k - 81) / 4) * kSY + ((k - 81) % 4 / 2) * kSX + (k - 81) % 2;
}

template <typename T, int N_ROWS>
__global__ void __launch_bounds__(kTile)
row_copies_kernel(const T* __restrict__ x, T* __restrict__ out, int ldx, int block,
                  int tiles) {
  const int c0 = (int)(blockIdx.x % tiles) * kTile;
  for (int col = threadIdx.x; col < kTile; col += blockDim.x) {
#pragma unroll
    for (int k = 0; k < N_ROWS; ++k)
      out[(long long)k * block + c0 + col] =
          x[(long long)copy_row(k) * ldx + copy_off(k) + c0 + col];
  }
}

// ---------------------------------------------------------------------------
// K9 and K5: O = A X, A (M, K), X (K, ldx), accumulated in float32 (float64
// for kPrecF64). One kernel, two entries: resident (K9: every grid step reads
// the same (K, block) X, grid steps x column tiles blocks) and streamed (K5:
// the column tiles cover all of X once).
// Precisions: kPrecF32 IEEE float32 FMAs on the CUDA cores (the "highest"
// product); kPrecTF32 mma.sync m16n8k8 TF32 (inputs rounded to TF32, the
// counterpart of the TPU's float32 "default"); kPrecBF16 mma.sync m16n8k16
// (inputs rounded to bf16, float32 accumulation); kPrecF64 mma.sync m8n8k4
// DMMA, float64.
// Bound: operations (2 M K per column), or bytes for bf16/TF32 when K is
// small. Design: a block stages its (K, 64) tile of X once (converted to the
// staged type), then walks over M in passes of 32 rows of A, each staged in
// shared memory; a pass is 16 float32 FMAs per k for each of 128 threads, or
// 4 warps of mma.sync, each warp a 16 x 32 part of the 32 x 64 output tile.
constexpr int kPrecF32 = 0, kPrecTF32 = 1, kPrecBF16 = 2, kPrecF64 = 3;
constexpr int kDotRows = 32, kDotThreads = 128, kPadA = 4, kPadB = 8;

template <int PREC>
struct Stage;
template <>
struct Stage<kPrecF32> {
  using T = float;
  __device__ static float cvt(float v) { return v; }
};
template <>
struct Stage<kPrecF64> {
  using T = double;
  __device__ static double cvt(double v) { return v; }
};
#ifndef ADAFLO_EMULATED
template <>
struct Stage<kPrecTF32> {
  using T = float;
  __device__ static float cvt(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return __uint_as_float(r);
  }
};
template <>
struct Stage<kPrecBF16> {
  using T = __nv_bfloat16;
  __device__ static T cvt(float v) { return __float2bfloat16_rn(v); }
  __device__ static T cvt(__nv_bfloat16 v) { return v; }
};
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
#endif
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(double* p, double v) { *p = v; }

template <int K, typename TO>
__device__ void dot_pass_simt(const float* sA, const float* sB, TO* O, long long ldo) {
  constexpr int LDA = K + kPadA, LDB = kTile + kPadB;
  for (int w = threadIdx.x; w < 128; w += blockDim.x) {
    const int ty = w / 16, tx = w % 16;  // rows 4 ty .. 4 ty + 3, columns tx + 16 j
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[(4 * ty + i) * LDA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[k * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) put(O + (4 * ty + i) * ldo + tx + 16 * j, acc[i][j]);
  }
}

#ifndef ADAFLO_EMULATED
// mma.sync fragments (PTX ISA, "Matrix fragments for mma.m16n8k8/k16/m8n8k4"):
// lane = 4 g + t; the accumulator of an m16n8 tile holds rows g, g + 8 and
// columns 2 t, 2 t + 1.
template <int K, typename TO>
__device__ void dot_pass_tf32(const float* sA, const float* sB, TO* O, long long ldo) {
  constexpr int LDA = K + kPadA, LDB = kTile + kPadB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp / 2) * 16, wc = (warp % 2) * 32;
  float acc[4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t a[4];
    a[0] = __float_as_uint(sA[(wr + g) * LDA + k0 + t]);
    a[1] = __float_as_uint(sA[(wr + g + 8) * LDA + k0 + t]);
    a[2] = __float_as_uint(sA[(wr + g) * LDA + k0 + t + 4]);
    a[3] = __float_as_uint(sA[(wr + g + 8) * LDA + k0 + t + 4]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = wc + 8 * n + g;
      const uint32_t b0 = __float_as_uint(sB[(k0 + t) * LDB + col]);
      const uint32_t b1 = __float_as_uint(sB[(k0 + t + 4) * LDB + col]);
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]), "+f"(acc[n][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = wc + 8 * n + 2 * t;
    put(O + (wr + g) * ldo + col, acc[n][0]);
    put(O + (wr + g) * ldo + col + 1, acc[n][1]);
    put(O + (wr + g + 8) * ldo + col, acc[n][2]);
    put(O + (wr + g + 8) * ldo + col + 1, acc[n][3]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int K, typename TO>
__device__ void dot_pass_bf16(const __nv_bfloat16* sA, const __nv_bfloat16* sB, TO* O,
                              long long ldo) {
  constexpr int LDA = K + kPadA, LDB = kTile + kPadB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp / 2) * 16, wc = (warp % 2) * 32;
  float acc[4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const __nv_bfloat16* r0 = sA + (wr + g) * LDA + k0 + 2 * t;
    const __nv_bfloat16* r1 = sA + (wr + g + 8) * LDA + k0 + 2 * t;
    const uint32_t a0 = pack_bf16(r0[0], r0[1]), a1 = pack_bf16(r1[0], r1[1]);
    const uint32_t a2 = pack_bf16(r0[8], r0[9]), a3 = pack_bf16(r1[8], r1[9]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const __nv_bfloat16* bc = sB + (k0 + 2 * t) * LDB + wc + 8 * n + g;
      const uint32_t b0 = pack_bf16(bc[0], bc[LDB]);
      const uint32_t b1 = pack_bf16(bc[8 * LDB], bc[9 * LDB]);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]), "+f"(acc[n][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = wc + 8 * n + 2 * t;
    put(O + (wr + g) * ldo + col, acc[n][0]);
    put(O + (wr + g) * ldo + col + 1, acc[n][1]);
    put(O + (wr + g + 8) * ldo + col, acc[n][2]);
    put(O + (wr + g + 8) * ldo + col + 1, acc[n][3]);
  }
}

template <int K>
__device__ void dot_pass_f64(const double* sA, const double* sB, double* O, long long ldo) {
  constexpr int LDA = K + kPadA, LDB = kTile + kPadB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp / 2) * 16, wc = (warp % 2) * 32;
  double acc[2][4][2] = {};
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 4) {
    const double a0 = sA[(wr + g) * LDA + k0 + t];
    const double a1 = sA[(wr + 8 + g) * LDA + k0 + t];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const double b = sB[(k0 + t) * LDB + wc + 8 * n + g];
      asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                   : "+d"(acc[0][n][0]), "+d"(acc[0][n][1])
                   : "d"(a0), "d"(b));
      asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                   : "+d"(acc[1][n][0]), "+d"(acc[1][n][1])
                   : "d"(a1), "d"(b));
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      double* o = O + (wr + 8 * m + g) * ldo + wc + 8 * n + 2 * t;
      o[0] = acc[m][n][0];
      o[1] = acc[m][n][1];
    }
}
#endif  // ADAFLO_EMULATED

template <int PREC, int M, int K>
constexpr size_t dot_shared_bytes() {
  return (size_t)(K * (kTile + kPadB) + kDotRows * (K + kPadA)) *
         sizeof(typename Stage<PREC>::T);
}

template <int PREC, int M, int K, typename TI, typename TO>
__global__ void __launch_bounds__(kDotThreads)
dense_dot_kernel(const TI* __restrict__ A, const TI* __restrict__ X, TO* __restrict__ O,
                 long long ldx, int tiles) {
  static_assert(M % kDotRows == 0 && K % 16 == 0, "M a multiple of 32, K of 16");
  using S = typename Stage<PREC>::T;
  constexpr int LDA = K + kPadA, LDB = kTile + kPadB;
  S* sB = shared_base<S>();
  S* sA = sB + K * LDB;
  const long long c0 = (long long)(blockIdx.x % tiles) * kTile;
  for (int i = threadIdx.x; i < K * kTile; i += blockDim.x)
    sB[(i / kTile) * LDB + i % kTile] = Stage<PREC>::cvt(X[(i / kTile) * ldx + c0 + i % kTile]);
#pragma unroll
  for (int m0 = 0; m0 < M; m0 += kDotRows) {
    __syncthreads();  // the previous pass has read sA
    for (int i = threadIdx.x; i < kDotRows * K; i += blockDim.x)
      sA[(i / K) * LDA + i % K] = Stage<PREC>::cvt(A[(m0 + i / K) * K + i % K]);
    __syncthreads();
    TO* o = O + m0 * ldx + c0;
    if constexpr (PREC == kPrecF32) dot_pass_simt<K>(sA, sB, o, ldx);
#ifndef ADAFLO_EMULATED
    else if constexpr (PREC == kPrecTF32) dot_pass_tf32<K>(sA, sB, o, ldx);
    else if constexpr (PREC == kPrecBF16) dot_pass_bf16<K>(sA, sB, o, ldx);
    else dot_pass_f64<K>(sA, sB, o, ldx);
#endif
  }
}

// ---------------------------------------------------------------------------
// K10: the three-stage sum-factorized evaluation of scripts/probe_sf.py:204
// (_sf_eval_body) from the (32, block + 2560) parity slab: stage z (flat shift
// 2401) writes 18 statements of (4, w1), stage y (shift 49) 81 of (2, w2),
// stage x (shift 1) 324 of (1, block) into the q rows kind 96 + c 32 + q of
// the (384, block) output; the pad rows q = 27..31 are written as 0 (the JAX
// kernel leaves them unwritten). Each statement is
//   out = C0 a + C1 b + C2 a_shifted
// with C the axis' value (V) or derivative (D) coefficients.
// Bound: operations, 5 flops per written element of the JAX kernel's widths
// (w1 = block + 64, w2 = block + 8).
// Design: a block computes a 64-column tile of the output through all three
// stages in shared memory. Stage x needs stage y over 65 columns, stage y
// needs stage z over 114, stage z the slab over 114 at +0 and at +2401: the
// halo is recomputed in every tile (about 10 % more statements' elements than
// the JAX kernel's at block 2048). Stage z's statements (4 x 114 elements)
// each take the whole block; those of stages y (2 x 65) and x (64) are too
// narrow for it, and each warp runs its share of them, a loop over statement
// indices that it decodes, so that every warp has work (one thread per
// column of a stage-x statement left three of four threads idle) and runs
// only its own statements' code. Statements in a runtime loop cannot be
// merged, so stages y and x need no unrolled copy of each.
template <typename T>
struct SfCoeffs {
  T V[3][3];  // per axis z, y, x: the three terms of the value
  T D[3][3];  // and of the derivative
};

constexpr int kSfThreads = 256;

template <int TILE>
struct SfShape {
  static constexpr int WZ = TILE + kSX + 1;  // stage z columns
  static constexpr int WY = TILE + 1;        // stage y columns
  static constexpr int XR = 36;              // slab rows: 24 at +0, 12 at +2401
  static constexpr int ZR = 72;              // (qz, kind, c, 4 rows)
  static constexpr int YR = 162;             // (plane, kind, c, 2 rows)
  static constexpr int ELEMS = XR * WZ + ZR * WZ + YR * WY;
};

template <typename T, int TILE>
__global__ void __launch_bounds__(kSfThreads)
sf_eval_kernel(const T* __restrict__ x, T* __restrict__ out, int ldx, int block, int tiles,
               SfCoeffs<T> co) {
  using S = SfShape<TILE>;
  constexpr int WZ = S::WZ, WY = S::WY;
  T* sx = shared_base<T>();
  T* sz = sx + S::XR * WZ;
  T* sy = sz + S::ZR * WZ;
  // the statements read through volatile pointers (see the file's head)
  const volatile T* vx = sx;
  const volatile T* vz = sz;
  const volatile T* vy = sy;
  const int j0 = (int)(blockIdx.x % tiles) * TILE;  // blockIdx.x / tiles: the step
  T cf[2][3][3];  // [value, derivative][axis][term], indexed by constants below
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      cf[0][a][i] = co.V[a][i];
      cf[1][a][i] = co.D[a][i];
    }
  for (int i = threadIdx.x; i < S::XR * WZ; i += blockDim.x) {
    const int r = i / WZ, j = i % WZ;
    const int src = r < 24 ? r : ((r - 24) / 4) * 8 + (r - 24) % 4;
    sx[i] = x[(long long)src * ldx + (r < 24 ? 0 : kSY) + j0 + j];
  }
  __syncthreads();
  // stage z: rows c 8 + r (pz = 0), c 8 + 4 + r (pz = 1), c 8 + r at +2401
#pragma unroll
  for (int qz = 0; qz < 3; ++qz)
#pragma unroll
    for (int kind = 0; kind < 2; ++kind)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T c0 = cf[kind][0][0], c1 = cf[kind][0][1], c2 = cf[kind][0][2];
        T* dst = sz + ((qz * 2 + kind) * 3 + c) * 4 * WZ;
        for (int i = threadIdx.x; i < 4 * WZ; i += blockDim.x) {
          const int r = i / WZ, j = i % WZ;
          dst[i] = c0 * vx[(c * 8 + r) * WZ + j] + c1 * vx[(c * 8 + 4 + r) * WZ + j] +
                   c2 * vx[(24 + c * 4 + r) * WZ + j];
        }
      }
  __syncthreads();
  // stages y and x: warp w runs statements w, w + warps, ... (decoded from
  // their index), its lanes striding over the statement's elements
  const int lanes = blockDim.x < 32 ? blockDim.x : 32;
  const int warps = blockDim.x / lanes, warp = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  // stage y, statement s = ((plane qz 3 + qy) 3 + ko) 3 + c: value -> value
  // (V) and d/dy (D), d/dz -> d/dz (V)
  for (int s = warp; s < 81; s += warps) {
    const int c = s % 3, ko = (s / 3) % 3, qz = s / 27;
    const int kind_in = ko == 2 ? 1 : 0;
    const bool d = ko == 1;
    const T c0 = d ? cf[1][1][0] : cf[0][1][0], c1 = d ? cf[1][1][1] : cf[0][1][1],
            c2 = d ? cf[1][1][2] : cf[0][1][2];
    const volatile T* src = vz + ((qz * 2 + kind_in) * 3 + c) * 4 * WZ;
    T* dst = sy + s * 2 * WY;
    for (int i = lane; i < 2 * WY; i += lanes) {
      const int r = i / WY, j = i % WY;
      dst[i] = c0 * src[r * WZ + j] + c1 * src[(2 + r) * WZ + j] + c2 * src[r * WZ + kSX + j];
    }
  }
  __syncthreads();
  // stage x, statement s = (q 4 + ko) 3 + c, q = qz 9 + qy 3 + qx: value ->
  // value and d/dx, d/dy -> d/dy, d/dz -> d/dz
  for (int s = warp; s < 324; s += warps) {
    const int c = s % 3, ko = (s / 3) % 4, q = s / 12;
    const int kind_in = ko == 0 ? 0 : ko - 1;
    const bool d = ko == 1;
    const T c0 = d ? cf[1][2][0] : cf[0][2][0], c1 = d ? cf[1][2][1] : cf[0][2][1],
            c2 = d ? cf[1][2][2] : cf[0][2][2];
    const volatile T* src = vy + (((q / 3) * 3 + kind_in) * 3 + c) * 2 * WY;
    T* dst = out + (long long)(ko * 96 + c * 32 + q) * block + j0;
    for (int j = lane; j < TILE; j += lanes)
      dst[j] = c0 * src[j] + c1 * src[WY + j] + c2 * src[1 + j];
  }
  for (int i = threadIdx.x; i < 12 * 5 * TILE; i += blockDim.x) {
    const int row = i / TILE, j = i % TILE;  // (kind, c) 12 groups x q 27..31
    out[(long long)((row / 5) * 32 + 27 + row % 5) * block + j0 + j] = T(0);
  }
}

// ---------------------------------------------------------------------------
// launches

template <typename T>
int launch_row_fma(int n_ops, int shifted, const void* x, void* out, int block, int nblk,
                   cudaStream_t st) {
  const int tiles = block / kTile;
  const size_t smem = (size_t)kFmaIn * (kTile + kFmaHalo) * sizeof(T);
  auto go = [&](auto kern) {
    int rc = allow_shared(kern, smem);
    if (rc != 0) return rc;
    kern<<<(unsigned)(tiles * nblk), kFmaThreads, smem, st>>>((const T*)x, (T*)out, block + 128, block, tiles);
    return (int)cudaGetLastError();
  };
#define ADAFLO_FMA(n)                                                   \
  if (n_ops == n)                                                       \
    return shifted ? go(row_fma_kernel<T, n, true>) : go(row_fma_kernel<T, n, false>);
  ADAFLO_FMA(24)
  ADAFLO_FMA(72)
  ADAFLO_FMA(96)
#undef ADAFLO_FMA
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_row_copies(int n_rows, const void* x, void* out, int block, int nblk,
                      cudaStream_t st) {
  const int tiles = block / kTile;
  auto go = [&](auto kern) {
    kern<<<(unsigned)(tiles * nblk), kTile, 0, st>>>((const T*)x, (T*)out, block + 2560, block, tiles);
    return (int)cudaGetLastError();
  };
  if (n_rows == 29) return go(row_copies_kernel<T, 29>);
  if (n_rows == 89) return go(row_copies_kernel<T, 89>);
  return (int)cudaErrorInvalidValue;
}

template <int PREC, int M, int K, typename TI, typename TO>
int launch_dot_mk(const void* A, const void* X, void* O, long long ncols, long long blocks,
                  cudaStream_t st) {
  auto kern = dense_dot_kernel<PREC, M, K, TI, TO>;
  const size_t smem = dot_shared_bytes<PREC, M, K>();
  int rc = allow_shared(kern, smem);
  if (rc != 0) return rc;
  kern<<<(unsigned)blocks, kDotThreads, smem, st>>>((const TI*)A, (const TI*)X, (TO*)O, ncols, (int)(ncols / kTile));
  return (int)cudaGetLastError();
}

template <int PREC, typename TI, typename TO>
int launch_dot(int m, int k, const void* A, const void* X, void* O, long long ncols,
               long long blocks, cudaStream_t st) {
  if (m == 96 && k == 96) return launch_dot_mk<PREC, 96, 96, TI, TO>(A, X, O, ncols, blocks, st);
  if (m == 384 && k == 96) return launch_dot_mk<PREC, 384, 96, TI, TO>(A, X, O, ncols, blocks, st);
  if (m == 96 && k == 32) return launch_dot_mk<PREC, 96, 32, TI, TO>(A, X, O, ncols, blocks, st);
  if (m == 384 && k == 32) return launch_dot_mk<PREC, 384, 32, TI, TO>(A, X, O, ncols, blocks, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_sf_eval(const void* x, void* out, int block, int nblk, const double* coeffs,
                   cudaStream_t st) {
  constexpr int TILE = kTile;
  SfCoeffs<T> co;
  for (int a = 0; a < 3; ++a)
    for (int i = 0; i < 3; ++i) {
      co.V[a][i] = (T)coeffs[a * 3 + i];
      co.D[a][i] = (T)coeffs[9 + a * 3 + i];
    }
  const int tiles = block / TILE;
  const size_t smem = (size_t)SfShape<TILE>::ELEMS * sizeof(T);
  auto kern = sf_eval_kernel<T, TILE>;
  int rc = allow_shared(kern, smem);
  if (rc != 0) return rc;
  kern<<<(unsigned)(tiles * nblk), kSfThreads, smem, st>>>((const T*)x, (T*)out, block + 2560, block, tiles, co);
  return (int)cudaGetLastError();
}

bool bad_block(int block, int nblk) { return block <= 0 || block % kTile != 0 || nblk <= 0; }

}  // namespace

extern "C" {

// K7. dtype 0 float32, 1 float64. x (96, block + 128), out (24, block);
// n_ops 24, 72 or 96; shifted 0/1; nblk grid steps.
int adaflo_row_fma(int dtype, int n_ops, int shifted, const void* x, void* out, int block,
                   int nblk, void* stream) {
  if (bad_block(block, nblk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_row_fma<float>(n_ops, shifted, x, out, block, nblk, st);
  if (dtype == 1) return launch_row_fma<double>(n_ops, shifted, x, out, block, nblk, st);
  return (int)cudaErrorInvalidValue;
}

// K8. x (32, block + 2560), out (n_rows, block); n_rows 29 or 89.
int adaflo_row_copies(int dtype, int n_rows, const void* x, void* out, int block, int nblk,
                      void* stream) {
  if (bad_block(block, nblk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_row_copies<float>(n_rows, x, out, block, nblk, st);
  if (dtype == 1) return launch_row_copies<double>(n_rows, x, out, block, nblk, st);
  return (int)cudaErrorInvalidValue;
}

// K9 (streamed 0) and K5 (streamed 1): O (m, ncols) = A (m, k) X (k, ncols).
// prec 0 f32, 1 tf32, 2 bf16, 3 f64. Resident: A, X float32 (float64 for
// f64), O float32 (float64), nblk grid steps over the same X. Streamed: A, X
// and O of one type, float32 (f32, tf32), bf16 or float64; m 384, k 96.
// (m, k) in {96, 384} x {96, 32}; ncols a multiple of 64.
int adaflo_dense_dot(int prec, int m, int k, int streamed, const void* A, const void* X,
                     void* O, long long ncols, int nblk, void* stream) {
  if (ncols <= 0 || ncols % kTile != 0 || nblk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (ncols / kTile) * (streamed ? 1 : nblk);
  if (prec == kPrecF32) return launch_dot<kPrecF32, float, float>(m, k, A, X, O, ncols, blocks, st);
#ifndef ADAFLO_EMULATED
  if (prec == kPrecTF32) return launch_dot<kPrecTF32, float, float>(m, k, A, X, O, ncols, blocks, st);
  if (prec == kPrecF64) return launch_dot<kPrecF64, double, double>(m, k, A, X, O, ncols, blocks, st);
  if (prec == kPrecBF16 && !streamed)
    return launch_dot<kPrecBF16, float, float>(m, k, A, X, O, ncols, blocks, st);
  if (prec == kPrecBF16 && m == 384 && k == 96)
    return launch_dot_mk<kPrecBF16, 384, 96, __nv_bfloat16, __nv_bfloat16>(A, X, O, ncols, blocks, st);
#endif
  return (int)cudaErrorInvalidValue;
}

// K10. x (32, block + 2560), out (384, block); coeffs: host doubles
// [V (3 axes z, y, x x 3 terms), D (3 x 3)].
int adaflo_sf_eval(int dtype, const void* x, void* out, int block, int nblk,
                   const double* coeffs, void* stream) {
  if (bad_block(block, nblk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_sf_eval<float>(x, out, block, nblk, coeffs, st);
  if (dtype == 1) return launch_sf_eval<double>(x, out, block, nblk, coeffs, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
