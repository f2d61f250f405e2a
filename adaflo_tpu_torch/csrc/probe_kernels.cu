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
// (identical work inside one thread would be hoisted): K7 is launched over
// steps x column tiles thread blocks, each of which loads its columns (with
// the halo of its shifts) from L2 into registers and does one step's work on
// them; the dot's persistent blocks loop over steps x tiles work items, each
// tile brought anew by the TMA (see dense_dot_kernel); K8 and K10 keep a
// column tile's slab and output in shared memory for a group of steps, as
// the TPU keeps them in VMEM, each step starting at a barrier and reloading
// its operands from the resident slab (see "resident tiles" below). Every
// step writes the same output with the same values, as the TPU kernels do.
// Timing two work levels (the probe drivers' slopes) cancels the loads, as
// it cancelled the TPU's refetch.
//
// The work must survive the compiler. The JAX statements repeat themselves
// (K7's statement k and k + 8 read the same rows, and k + 24 also at the
// same shift; K10's qz, qy and qx planes compute the same values), and
// Mosaic runs every one. K7 and K10 hold their operands in registers and
// take each repeated statement's first coefficient in a form of its own
// (hopper.cuh salted), so nvcc computes every statement from registers: the
// rate they measure is that of FMA statements fed from registers. (An empty
// asm with a memory clobber between the statements did not do it: nvcc
// still merged K7's, 24 LDS for 96 statements.) K10 stores every q row it
// computes, so no stage is dead. The instruction counts per instance are in
// PERF.md (scripts/sass_counts.py).
//
// Bounds on an H100 SXM at its 700 W limit (NVIDIA data sheet): 3.35 TB/s
// HBM3; 67 TFLOP/s float32 and 34 TFLOP/s float64 on the CUDA cores; 495
// TFLOP/s TF32, 989 bf16 and 67 float64 (DMMA) on the tensor cores. The
// probe drivers (adaflo_tpu_torch/scripts/probe_sf.py, probe_mxu.py) compute
// each configuration's bound from its shapes (scripts/probe_bounds.py).
//
// All kernels are strided loops over their work items, so that the g++
// emulation of the CPU tests (one thread per block) runs them; the tensor-core
// paths of the dot (wgmma, mma.sync) are inline PTX, which that emulation
// cannot run, and are left out under ADAFLO_EMULATED, where their C entries
// return an error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
//   v_k = 0.31 x[r0 + r, c + sh] + 0.47 x[r0 + 8 + r, c] + 0.22 x[r0 + 16 + r, c]
// summed over k in order (acc + v_k) into the (24, block) output, r0 =
// (24 k) mod 64, sh = 1 + k mod 3 when SHIFTED, from a (96, block + 128)
// input.
// Bound: operations, (6 N_OPS - 1) flops per output element and step. A
// statement is four instructions, a multiply, two FMAs and an add (FMUL,
// FFMA, FFMA, FADD, or DMUL, DFMA, DFMA, DADD), so the issue rate caps it at
// 6 flops per 4 FMA slots, three quarters of the peak.
// Design: every row that a statement reads lies r0 / 8 + {0, 1, 2} rows of
// 8 below its output row, so a work item, one column c and one residue r
// mod 8 (output rows r, r + 8, r + 16: three sums), reads only rows r + 8 j
// (j < 12) of column c and, shifted, rows r + 8 j (j < 10) of columns c + 1
// .. c + 3: 42 values (12 unshifted), loaded once into registers straight
// from global memory (a warp's threads on 32 consecutive columns, so each
// load is coalesced), so that no statement reads shared memory: at 3 LDS
// per statement, shared memory would feed the FMA units at a quarter of
// their peak. Statements k and k + 24 (k + 8 unshifted) are the same
// expression, which ptxas merges (the terms on the same rows computed once:
// FFMA 20 at every N_OPS), so statement k takes its 0.31 through salted
// (hopper.cuh), in a form that the compiler cannot know is 0.31, and no two
// terms on the same data share a form. Row i of statement k reads rows
// j0 + i .. j0 + i + 2 (j0 = r0 / 8) at its shift, so statements share data
// only at the same shift and |j0 - j0'| <= 2, and with the same j0 only a
// period apart (8 statements aligned, 24 shifted); the salt 3 (k / period)
// + j0 mod 3 + 1 tells them all apart with 36 (aligned) or 12 (shifted)
// forms at 96 statements, one LOP3 each per work item. The salt derives
// from the item's column, so that ptxas cannot hoist the salted
// coefficients out of the item loop into registers held across it. The
// grid is steps x column tiles of 64, each block's 128 threads looping over
// the tile's 512 work items; the last tile's columns past the block are
// skipped.
constexpr int kFmaRows = 24, kFmaIn = 96, kFmaThreads = 128;
constexpr int kFmaRes = 8;  // residues r mod 8: work items of a column
constexpr int kFmaCol = kFmaIn / kFmaRes, kFmaShifted = 10;  // rows of c, of c + 1 .. c + 3

// The work items of K7's column tile `tile` that thread t of nth takes, in
// turn: f(col, r), the item's column and residue (its outputs are rows r,
// r + 8, r + 16 of column col); columns past the block are skipped.
template <typename F>
__device__ __forceinline__ void fma_items(int tile, int block, int t, int nth, F f) {
  for (int w = t; w < kTile * kFmaRes; w += nth) {
    const int col = tile * kTile + w % kTile;
    if (col < block) f(col, w / kTile);
  }
}

template <typename T, int N_OPS, bool SHIFTED>
__global__ void __launch_bounds__(kFmaThreads)
row_fma_kernel(const T* __restrict__ x, T* __restrict__ out, int ldx, int block,
               int tiles, unsigned zero) {
  // blockIdx.x / tiles: the step; zero: 0
  fma_items(blockIdx.x % tiles, block, threadIdx.x, blockDim.x, [&](int col, int r) {
    const unsigned zi = zero & (unsigned)col;  // 0, of this item
    const T* xr = x + (long long)r * ldx + col;
    T xc[kFmaCol], xs[3][SHIFTED ? kFmaShifted : 1];
#pragma unroll
    for (int j = 0; j < kFmaCol; ++j) xc[j] = xr[(long long)8 * j * ldx];
    if constexpr (SHIFTED) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int j = 0; j < kFmaShifted; ++j) xs[d][j] = xr[(long long)8 * j * ldx + 1 + d];
    }
    T acc[3];
#pragma unroll
    for (int k = 0; k < N_OPS; ++k) {
      const int j0 = (k * kFmaRows) % 64 / 8;
      const T w = salted(T(0.31), zi, 3 * (k / (SHIFTED ? 24 : 8)) + j0 % 3 + 1);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        T a;
        if constexpr (SHIFTED)
          a = xs[k % 3][j0 + i];
        else
          a = xc[j0 + i];
        // left to right, the products after the first fused into its sums;
        // the first product alone, so that every term depends on w
        const T v =
            fma_rn(T(0.22), xc[j0 + 2 + i], fma_rn(T(0.47), xc[j0 + 1 + i], mul_rn(w, a)));
        acc[i] = k == 0 ? v : acc[i] + v;
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) out[(long long)(r + 8 * i) * block + col] = acc[i];
  });
}

// ---------------------------------------------------------------------------
// K9 and K5: O = A X, A (M, K), X (K, ncols), accumulated in float32 (float64
// for kPrecF64). One kernel, two entries: resident (K9: nblk grid steps, each
// writing the same output from the same X) and streamed (K5: every column of
// X once).
// Precisions: kPrecF32 IEEE float32 FMAs on the CUDA cores (the "highest"
// product); kPrecTF32 wgmma on TF32 inputs rounded to nearest (cvt.rna, the
// counterpart of the TPU's float32 "default"); kPrecBF16 wgmma on bf16
// inputs (K9 rounds its float32 inputs to nearest; K5 reads bf16 and writes
// bf16); kPrecF64 mma.sync m16n8k8 DMMA, float64.
// Bound: bytes for K5 (the output is 80 % of them; f32 by operations on the
// CUDA cores), operations for K9 (2 M K per column and step).
//
// Design. A persistent grid: as many blocks as are resident on the card
// (occupancy query x SMs), each looping over work items of W columns (64; 32
// for float64): K5's items are its column tiles, K9's are steps x tiles.
// Every block has 8 consumer warps (2 per SM sub-partition) and 1 producer
// warp.
//  - A is loaded once per block, converted and laid out for its consumer, and
//    stays on the SM for every item of the block: in shared memory, or for
//    float64 as the warps' mma.sync fragments in registers.
//  - X tiles arrive by TMA (cp.async.bulk.tensor.2d, one box of 128 bytes x K
//    rows per 128-byte column chunk, 128-byte swizzled) into a ring of S
//    stages completing on mbarriers ("full"); one producer thread (lane 0 of
//    the last warp) keeps the ring filled while the consumer warps compute,
//    and a consumer warp releases a stage by an arrival on its "empty"
//    mbarrier once it has read it.
//  - bf16 and TF32 compute O^T = X^T A^T with wgmma (m64n48, 2 consumer
//    warpgroups, each 64 tile columns x half of A's rows as 1 or 4 n48
//    chunks): A^T is the B operand, K-major in shared memory (A row-major,
//    the only operand order TF32 allows, 128-byte swizzled, written once by
//    the block with fence.proxy.async); X^T is the A operand: for K5 bf16 the
//    TMA stage itself through a descriptor with the transpose bit (MN-major;
//    16-bit types allow it), for TF32 and K9 bf16 registers loaded from the
//    float32 stage and rounded by cvt.rna.tf32 or cvt.rn.bf16x2 (wgmma reads
//    TF32 only K-major, and the hardware would truncate). Two accumulators
//    of one n48 chunk each take turns: chunk q + 1's wgmma group runs while
//    chunk q is staged in shared memory (the swizzled layout of a TMA box)
//    and written by TMA stores (cp.async.bulk.tensor, whole 128-byte rows,
//    asynchronous, L2 evict-first: the output is not read again), from one
//    or two staging buffers per warpgroup.
//  - float64 has no wgmma: mma.sync m16n8k8 (the sm_90 shape, four times the
//    work of m8n8k4 per instruction). A (384, 96) is 288 KB and fits in no
//    block's shared memory (232,448 B), so A stays in registers instead: a
//    warp holds the fragments of 16 rows for all of K (96 registers at k 96),
//    the blocks split A's rows in P parts of 8 x 16 rows (M 384: P = 3; M 96:
//    P = 1, 6 warps busy), block b holding part b % P for all its items, and
//    each X tile is read by P blocks, after the first mostly from L2. Per k8
//    step a warp reads its 4 n8 subtiles' B fragments from the swizzled stage
//    with 2 LDS.128 per k row and issues 4 DMMA; the fragments' k slots and
//    the subtiles' columns are permuted (f64_kslot, f64_col) so that these
//    loads are conflict-free. Each warp stages its 16 x 32 output tile as two
//    TMA boxes and stores them as the wgmma paths do (direct 16-byte stores
//    from the fragments would write half sectors per instruction).
//  - float32 on the CUDA cores: register-blocked outer products, a thread
//    RM = M / 32 rows x 8 columns (256 threads, one pass), A as a k-major copy
//    (RM consecutive values of A a k: RM / 4 LDS.128), X's 8 columns two
//    LDS.128 of the swizzled stage (conflict-free); 16-byte stores, 8 lanes a
//    whole 128-byte row segment.
// Shared memory (bytes; stages S of one K x W tile each, at most 4, as many
// as fit beside A and the staging; staging doubled where 2 stages still fit):
//   type (M, K) = (384, 96)   A                    stage    S   staging  total
//   f32                       147,456 (k-major)    24,576   3   -        222,256
//   tf32                      147,456 (3 chunks)   24,576   2   24,576   222,240
//   bf16 K5 (bf16 X and O)     98,304 (2 chunks)   12,288   4   24,576   173,120
//   bf16 K9 (float32 X, O)     98,304              24,576   3   49,152   222,256
//   f64 (3 parts)             - (registers)        24,576   4   65,536   164,928
// (each total with 1,024 B of alignment slack and the 2 S mbarriers).
// Under ADAFLO_EMULATED (one thread per block) the float32 path runs with its
// ring: the thread produces S items ahead and consumes them in turn.
constexpr int kPrecF32 = 0, kPrecTF32 = 1, kPrecBF16 = 2, kPrecF64 = 3;
constexpr int kSmemMax = 232448;                   // shared memory a block may use
constexpr int kDotThreads = 288;  // 8 consumer warps + 1 producer warp

// F4/D2: 16-byte vectors (float4/double2 without the CUDA headers)
struct alignas(16) F4 {
  float x, y, z, w;
};
struct alignas(16) D2 {
  double x, y;
};
struct alignas(8) F2 {
  float x, y;
};

template <int PREC, int M, int K, int XS, int OS>  // XS, OS: bytes of an X, O element
struct DotPlan {
  static constexpr bool kSimt = PREC == kPrecF32, kF64 = PREC == kPrecF64;
  static constexpr bool kMma = !kSimt && !kF64;
  static constexpr int W = kF64 ? 32 : 64;  // columns of a work item
  // float64: A's fragments live in registers, 16 rows a warp: the blocks split
  // A's rows in P parts of MP rows, 8 warps (M 384: P = 3) or 6 (M 96)
  static constexpr int P = kF64 && M == 384 ? 3 : 1;
  static constexpr int MP = M / P;
  static constexpr int WARPS = kDotThreads / 32 - 1;  // consumer warps
  static constexpr int THREADS = kDotThreads;
  static constexpr int STAGE = K * W * XS;  // W * XS / 128 swizzled chunks of K rows
  static constexpr int CHUNKS = W * XS / 128;
  static constexpr int AS = PREC == kPrecBF16 ? 2 : 4;  // staged A element (wgmma)
  static constexpr int A_BYTES = kSimt ? K * M * 4 : kF64 ? 0 : (K * AS + 127) / 128 * M * 128;
  // the epilogue's staging for its TMA stores, in boxes of 128 bytes x
  // OUT_ROWS rows: a 48 x 64 chunk a warpgroup (wgmma), a 16 x 32 tile a
  // warp (float64); two buffers where they leave room for 2 stages
  static constexpr int OUT_ROWS = kF64 ? 16 : 48;
  static constexpr int STG1 = kMma ? 2 * 48 * 64 * OS : kF64 ? WARPS * 16 * 32 * 8 : 0;
  static constexpr int STG_BUFS = (kSmemMax - 1088 - A_BYTES - 2 * STG1) / STAGE >= 2 ? 2 : 1;
  static constexpr int STAGING = STG_BUFS * STG1;
  static constexpr int FIXED = 1024 + A_BYTES + STAGING + 64;
  static constexpr int S = (kSmemMax - FIXED) / STAGE < 4 ? (kSmemMax - FIXED) / STAGE : 4;
  static constexpr int A_OFF = S * STAGE, STG_OFF = A_OFF + A_BYTES,
                       BAR_OFF = STG_OFF + STAGING;
  static constexpr int SMEM = 1024 + BAR_OFF + 16 * S;
  static_assert(S >= 2 && SMEM <= kSmemMax, "shared memory plan");
  static_assert(M % 96 == 0 && K % 32 == 0 && STAGE % 1024 == 0, "shapes");
};

// A block's work items: the blocks of a part (block b: part b % P) stride
// over the part's items from item b / P; n of them, the it-th is first + it
// stride (K9: tile item % tiles of step item / tiles).
struct DotSched {
  long long first, stride, n;
};
__host__ __device__ constexpr DotSched dot_sched(long long block, long long grid, int parts,
                                                 long long items) {
  const long long first = block / parts, stride = grid / parts;
  return {first, stride, first < items ? (items - first + stride - 1) / stride : 0};
}

// The consumers that share a loop: all of them on the card, one under the
// emulation (whose single thread does every consumer's share).
__device__ __forceinline__ int consumer_stride(int n) {
#ifdef ADAFLO_EMULATED
  (void)n;
  return 1;
#else
  return n;
#endif
}

// a warp's release of a stage it has read
__device__ __forceinline__ void release(uint64_t* empty) {
  warp_sync();
#ifndef ADAFLO_EMULATED
  if (threadIdx.x % 32 == 0) bar_arrive(empty);
#else
  (void)empty;
#endif
}

// ---- float32 on the CUDA cores -----------------------------------------------
// A^T (K, M) in shared memory
template <int M, int K>
__device__ void load_a_simt(const float* __restrict__ A, float* sAt, int ctid, int nthr) {
  for (int i = ctid; i < M * K; i += nthr) sAt[(i % K) * M + i / K] = A[i];
}

// Unit u = (row group rg, column group cg): rows rg RM .. rg RM + RM - 1,
// columns 4 cg .. 4 cg + 3 (chunk 0) and 32 + 4 cg .. (chunk 1); 16-byte
// unit cg of a stage row, which the swizzle keeps distinct across a
// quarter-warp's lanes.
template <int M, int K>
__device__ void simt_tile(const unsigned char* st, const float* sAt, float* o, long long ldo,
                          uint64_t* empty, int ctid, int nthr) {
  constexpr int RM = M / 32;
  for (int u = ctid; u < 256; u += nthr) {
    const int rg = u / 8, cg = u % 8;
    float acc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    const float* a = sAt + rg * RM;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      float av[RM];
      if constexpr (RM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RM / 4; ++i) {
          const F4 v = *reinterpret_cast<const F4*>(a + k * M + 4 * i);
          av[4 * i] = v.x, av[4 * i + 1] = v.y, av[4 * i + 2] = v.z, av[4 * i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = a[k * M + i];
      }
      const int off = swz128(k, 16 * cg);
      const F4 x0 = *reinterpret_cast<const F4*>(st + off);
      const F4 x1 = *reinterpret_cast<const F4*>(st + K * 128 + off);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * xv[j];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float* row = o + (rg * RM + i) * ldo + 4 * cg;
      *reinterpret_cast<F4*>(row) = F4{acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      *reinterpret_cast<F4*>(row + 32) = F4{acc[i][4], acc[i][5], acc[i][6], acc[i][7]};
    }
  }
  release(empty);
}

// ---- float64 -------------------------------------------------------------------
// The tile column of B's subtile j (0..3), column n (0..7) in the float64
// path (W = 32): a permutation of the columns (a dot's output columns are
// independent) such that a lane (g, t) reads the columns of its subtiles
// j, j + 1 (j even) from consecutive addresses (one LDS.128 per k), and its
// accumulators n = 2t, 2t + 1 of those subtiles are 4 consecutive columns of
// a row (two 16-byte units of the staging row).
__host__ __device__ constexpr int f64_col(int n, int j) {
  return 8 * (n / 2) + 4 * (j / 2) + 2 * (n % 2) + j % 2;
}

// The k of fragment slot s (0..7) of the k8 step: slot t is k 2t, slot t + 4
// is k 2t + 1 (a permutation of the k's, the same in A and B), so that a
// lane's A values of a row are consecutive, and a quarter-warp's B rows
// (2t, 2t + 1) XOR the swizzled units with 0, 2, 4, 6 (1, 3, 5, 7): with
// f64_col, the 8 lanes' LDS.128 fall on 8 distinct 16-byte units.
__host__ __device__ constexpr int f64_kslot(int s) { return s < 4 ? 2 * s : 2 * (s - 4) + 1; }

// ---- wgmma (bf16, TF32): A as the K-major B operand --------------------------
// A[m][k] of the staged type (AS bytes) in region k / E (E = 128 / AS values
// of k a 128-byte row), row m, byte (k % E) AS, 128-byte swizzled; regions of
// M rows, 1024-byte aligned.
__host__ __device__ constexpr int mma_a_offset(int m, int k, int M, int AS) {
  return (k * AS / 128) * M * 128 + swz128(m, (k * AS) % 128);
}

// wgmma's shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor
// Format"): start address >> 4 in bits [0, 14), leading dimension byte offset
// >> 4 in [16, 30), stride dimension byte offset >> 4 in [32, 46), base offset
// 0 in [49, 52) (atoms 1024-byte aligned), layout 1 = 128-byte swizzle in
// [62, 64).
__host__ __device__ constexpr uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Byte offsets (from A's base) of the B operand (A^T, K-major) of n48 chunk q
// of the warpgroup's rows n0 at the k-step ks of 32 bytes (k16 bf16, k8
// TF32): LBO unused (swizzled K-major), SBO 1024 (8 rows of 128 bytes).
__host__ __device__ constexpr uint32_t mma_b_start(int n0, int q, int ks, int M) {
  return (uint32_t)((ks / 4) * M * 128 + (n0 + 48 * q) * 128 + (ks % 4) * 32);
}

// Byte offset (from the stage) of K5 bf16's A operand (X^T, MN-major: the
// TMA box's 64 columns x K rows of 128 bytes) at k16 step ks: LBO the next
// 64 columns (none), SBO 1024 (8 k rows).
__host__ __device__ constexpr uint32_t mma_x_start(int ks) { return (uint32_t)(ks * 16 * 128); }

#ifndef ADAFLO_EMULATED
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// bf16 pair (lo, hi) rounded to nearest, lo in the low half
__device__ __forceinline__ uint32_t to_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// one 16-byte unit of A (8 bf16 or 4 TF32 values of one row) per step, into
// the swizzled layout; the async proxy (wgmma) reads it after the fence
template <int PREC, int M, int K, typename TX>
__device__ void load_a_mma(const TX* __restrict__ A, unsigned char* sA, int ctid, int nthr) {
  constexpr int AS = PREC == kPrecBF16 ? 2 : 4, PER = 16 / AS, U = K / PER;
  for (int i = ctid; i < M * U; i += nthr) {
    const int m = i / U, k0 = (i % U) * PER;
    uint32_t v[4];
    if constexpr (sizeof(TX) == 2) {
      const uint4 raw = *reinterpret_cast<const uint4*>(A + m * K + k0);
      v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
    } else if constexpr (PREC == kPrecTF32) {
      const float* a = reinterpret_cast<const float*>(A) + m * K + k0;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = to_tf32(a[j]);
    } else {
      const float* a = reinterpret_cast<const float*>(A) + m * K + k0;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = to_bf16x2(a[2 * j], a[2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(sA + mma_a_offset(m, k0, M, AS)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  fence_proxy_async();
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma's
__device__ __forceinline__ void reg_fence(float (&d)[24]) {
#pragma unroll
  for (int i = 0; i < 24; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ADAFLO_D24                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23}"
#define ADAFLO_D24_REGS(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])

// D (64 x 48, float32) += A (64 x 16 bf16, shared memory, MN-major: the
// transpose bit) B (16 x 48, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[24], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " ADAFLO_D24
      ", %24, %25, p, 1, 1, 1, 0;\n}\n"
      : ADAFLO_D24_REGS(d)
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 48) += A (64 x 16 bf16, registers) B (16 x 48, K-major)
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[24], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " ADAFLO_D24
      ", {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : ADAFLO_D24_REGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 48) += A (64 x 8 TF32, registers) B (8 x 48, K-major)
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[24], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 " ADAFLO_D24
      ", {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : ADAFLO_D24_REGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// shared-memory stores of the staging rows
__device__ __forceinline__ void sts(uint32_t a, float lo, float hi) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(lo), "f"(hi) : "memory");
}
__device__ __forceinline__ void sts_bf16(uint32_t a, float v) {
  const unsigned short h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "h"(h) : "memory");
}

// One n48 chunk of the accumulator (O^T: row 16 w + g / g + 8 of the
// warpgroup's 64 is tile column c_lo / c_hi, n 8 j + 2 t + {0, 1} is O's row)
// into the warpgroup's staging rows as TMA store boxes (128-byte rows of
// E = 128 / sizeof(TO) columns, swizzled: a store's lanes fall on distinct
// banks), then one TMA store per box into O at (col0, row0): whole rows,
// asynchronous, while the warpgroup goes on; BUFS staging buffers take turns.
// PAIRED (float32 output): M'-rows g, g + 8 are columns 16 w + 2 g, + 1 (the
// register A operand's order; float32 pairs in one 8-byte store); else
// (K5's bf16) 16 w + g, + 8 (the stage's).
template <bool PAIRED, typename TO, int BUFS>
__device__ void store_chunk(const float (&d)[24], unsigned char* stg, const TileMap* omap, int col0,
                            int row0, int wt, int bar_id, uint64_t policy) {
  constexpr int S = sizeof(TO), E = 128 / S;
  const int w = wt / 32, g = (wt % 32) / 4, t = wt % 4;
  const int c_lo = PAIRED ? 16 * w + 2 * g : 16 * w + g, c_hi = PAIRED ? c_lo + 1 : c_lo + 8;
  const uint32_t base = smem_u32(stg);
  auto at = [&](int r, int c) { return base + (c / E) * 48 * 128 + swz128(r, (c % E) * S); };
  if (wt == 0) bulk_wait_read<BUFS - 1>();  // the buffer's previous store has read it
  named_sync(bar_id, 128);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int r = 8 * j + 2 * t;
    if constexpr (S == 2) {
      sts_bf16(at(r, c_lo), d[4 * j]), sts_bf16(at(r + 1, c_lo), d[4 * j + 1]);
      sts_bf16(at(r, c_hi), d[4 * j + 2]), sts_bf16(at(r + 1, c_hi), d[4 * j + 3]);
    } else {  // float32 output: the register order (TF32, K9 bf16)
      static_assert(PAIRED, "float32 output comes in the paired column order");
      sts(at(r, c_lo), d[4 * j], d[4 * j + 2]), sts(at(r + 1, c_lo), d[4 * j + 1], d[4 * j + 3]);
    }
  }
  fence_proxy_async();  // the TMA (async proxy) reads what these stores wrote
  named_sync(bar_id, 128);
  if (wt == 0) {
#pragma unroll
    for (int b = 0; b < 64 / E; ++b)
      tma_store_2d(omap, col0 + b * E, row0, stg + b * 48 * 128, policy);
    bulk_commit();
  }
}

// One work item of the wgmma paths: warpgroup wg computes O rows
// [wg M / 2, (wg + 1) M / 2) of the tile's 64 columns as NQ = M / 96 n48
// chunks, two accumulators in turn: chunk q + 1's wgmma group runs while
// chunk q is staged and its TMA store issued.
template <int PREC, int M, int K, typename TX, typename TO, int BUFS>
__device__ void mma_tile(const unsigned char* st, const unsigned char* sA, const TileMap* omap,
                         int col0, unsigned char* stg, int& nchunk, uint64_t* empty, int ctid,
                         uint64_t policy) {
  constexpr int NQ = M / 96;
  constexpr bool SS = sizeof(TX) == 2;  // K5 bf16: X^T straight from the stage
  constexpr bool TF = PREC == kPrecTF32;
  constexpr int KS = TF ? K / 8 : K / 16;
  const int wg = ctid / 128, wt = ctid % 128, w = wt / 32, g = (wt % 32) / 4, t = wt % 4;
  const int n0 = wg * (M / 2);
  const uint32_t a_base = smem_u32(sA), x_base = smem_u32(st);
  float d[2][24];
  uint32_t a[SS ? 1 : KS][4];
  if constexpr (!SS) {
    // X^T's fragments: M'-rows g and g + 8 of warp w are tile columns
    // 16 w + 2 g and + 1, one LDS.64 per k
    const int col = 16 * w + 2 * g;
    const unsigned char* xc = st + (col / 32) * K * 128;
    const int cb = (col % 32) * 4;
    auto ld2 = [&](int k) { return *reinterpret_cast<const F2*>(xc + swz128(k, cb)); };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (TF) {
        const F2 v0 = ld2(8 * ks + t), v1 = ld2(8 * ks + t + 4);
        a[ks][0] = to_tf32(v0.x), a[ks][1] = to_tf32(v0.y);
        a[ks][2] = to_tf32(v1.x), a[ks][3] = to_tf32(v1.y);
      } else {
        const int k = 16 * ks + 2 * t;
        const F2 v00 = ld2(k), v01 = ld2(k + 1), v10 = ld2(k + 8), v11 = ld2(k + 9);
        a[ks][0] = to_bf16x2(v00.x, v01.x), a[ks][1] = to_bf16x2(v00.y, v01.y);
        a[ks][2] = to_bf16x2(v10.x, v11.x), a[ks][3] = to_bf16x2(v10.y, v11.y);
      }
    }
    release(empty);
  }
  auto issue = [&](int q, float (&acc)[24]) {
    wgmma_fence();  // the registers were written (fragments) or read (epilogue)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t db = wgmma_desc(a_base + mma_b_start(n0, q, ks, M), 16, 1024);
      if constexpr (SS)
        wgmma_ss_bf16(acc, wgmma_desc(x_base + mma_x_start(ks), K * 128, 1024), db, ks > 0);
      else if constexpr (TF)
        wgmma_rs_tf32(acc, a[ks], db, ks > 0);
      else
        wgmma_rs_bf16(acc, a[ks], db, ks > 0);
    }
    wgmma_commit();
  };
  unsigned char* my_stg = stg + wg * BUFS * 48 * 64 * sizeof(TO);
  auto store = [&](int q, const float (&acc)[24]) {
    store_chunk<!SS, TO, BUFS>(acc, my_stg + (nchunk++ % BUFS) * 48 * 64 * sizeof(TO), omap, col0,
                               n0 + 48 * q, wt, 2 + wg, policy);
  };
  issue(0, d[0]);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q + 1 < NQ) {
      issue(q + 1, d[(q + 1) % 2]);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
      if constexpr (SS) release(empty);  // every wgmma of the tile has read the stage
    }
    reg_fence(d[q % 2]);
    store(q, d[q % 2]);
  }
}

__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4], double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// The float64 path's A fragments of warp w: rows 16 w .. 16 w + 15 of the
// part (mma.sync m16n8k8 fragments, lane = 4 g + t: A (g, s), (g + 8, s),
// (g, s + 4), (g + 8, s + 4) at slot s = t), loaded once; warps past the
// part's rows (M 96: warps 6, 7) hold none.
template <int K>
__device__ void load_a_f64(const double* __restrict__ A, double (&af)[K / 8][4], int rows,
                           int ctid) {
  const int w = ctid / 32, g = (ctid % 32) / 4, t = ctid % 4;
  if (16 * w >= rows) return;
  const double* a0 = A + (16 * w + g) * K + f64_kslot(t);
  const double* a1 = a0 + 8 * K;
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    af[ks][0] = a0[8 * ks], af[ks][1] = a1[8 * ks];
    af[ks][2] = a0[8 * ks + 1], af[ks][3] = a1[8 * ks + 1];  // slot t + 4: k 2t + 1
    // opaque values: the compiler keeps them in registers instead of
    // reloading A from memory at every work item
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+d"(af[ks][i]));
  }
}

// One work item of the float64 path: warp w computes rows 16 w .. 16 w + 15
// of the part x the tile's 32 columns (4 n8 subtiles) from its A fragments
// in registers and B (C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1);
// B (s, g), (s + 4, g)) from the swizzled stage: 2 conflict-free LDS.128 per
// k row, 4 DMMA per k8 step. The warp stages its 16 x 32 tile (one of BUFS
// buffers) as two TMA boxes and its lane 0 stores them.
template <int K, int BUFS>
__device__ void f64_tile(const unsigned char* st, const double (&af)[K / 8][4],
                         const TileMap* omap, int col0, int row0, int rows, unsigned char* stg,
                         int& nchunk, uint64_t* empty, int ctid, uint64_t policy) {
  const int w = ctid / 32, lane = ctid % 32, g = lane / 4, t = lane % 4;
  if (16 * w >= rows) {  // M 96: warps 6 and 7 hold no rows
    release(empty);
    return;
  }
  double acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;
  auto at = [&](int row, int c) { return st + (c / 16) * K * 128 + swz128(row, (c % 16) * 8); };
#pragma unroll  // af[ks] stays in registers only with constant indices
  for (int ks = 0; ks < K / 8; ++ks) {
    const int k = 8 * ks + 2 * t;  // slots t and t + 4
    const D2 u0 = *reinterpret_cast<const D2*>(at(k, f64_col(g, 0)));
    const D2 u2 = *reinterpret_cast<const D2*>(at(k, f64_col(g, 2)));
    const D2 v0 = *reinterpret_cast<const D2*>(at(k + 1, f64_col(g, 0)));
    const D2 v2 = *reinterpret_cast<const D2*>(at(k + 1, f64_col(g, 2)));
    dmma(acc[0], af[ks], u0.x, v0.x);
    dmma(acc[1], af[ks], u0.y, v0.y);
    dmma(acc[2], af[ks], u2.x, v2.x);
    dmma(acc[3], af[ks], u2.y, v2.y);
  }
  release(empty);
  unsigned char* buf = stg + (w * BUFS + nchunk++ % BUFS) * 16 * 32 * 8;
  if (lane == 0) bulk_wait_read<BUFS - 1>();  // the buffer's previous store has read it
  warp_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h)  // rows g, g + 8: accumulator entries 2h, 2h + 1
#pragma unroll
    for (int e = 0; e < 2; ++e)  // accumulator column n = 2t + e
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int c = f64_col(2 * t + e, j);
        *reinterpret_cast<D2*>(buf + (c / 16) * 2048 + swz128(g + 8 * h, (c % 16) * 8)) =
            D2{acc[j][2 * h + e], acc[j + 1][2 * h + e]};
      }
  fence_proxy_async();
  warp_sync();
  if (lane == 0) {
    tma_store_2d(omap, col0, row0 + 16 * w, buf, policy);
    tma_store_2d(omap, col0 + 16, row0 + 16 * w, buf + 2048, policy);
    bulk_commit();
  }
}
#endif  // ADAFLO_EMULATED

template <int PREC, int M, int K, typename TX, typename TO>
__global__ void __launch_bounds__(kDotThreads)
dense_dot_kernel(const __grid_constant__ TileMap xmap, const __grid_constant__ TileMap omap,
                 const TX* __restrict__ A, TO* __restrict__ O, long long ncols, long long tiles,
                 long long items) {
  using Pl = DotPlan<PREC, M, K, (int)sizeof(TX), (int)sizeof(TO)>;
  unsigned char* raw = shared_base<unsigned char>();
#ifdef ADAFLO_EMULATED
  unsigned char* sm = raw + ((1024 - (uintptr_t)raw % 1024) % 1024);
#else
  unsigned char* sm = raw + ((1024 - smem_u32(raw) % 1024) % 1024);
#endif
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Pl::BAR_OFF);
  uint64_t* empty = full + Pl::S;
  const int part = (int)(blockIdx.x % Pl::P);
  const DotSched sched = dot_sched(blockIdx.x, gridDim.x, Pl::P, items);
  const long long n = sched.n;
  if (threadIdx.x == 0)
    for (int s = 0; s < Pl::S; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, Pl::WARPS);
    }
  __syncthreads();
  auto column = [&](long long it) { return (sched.first + it * sched.stride) % tiles * Pl::W; };
  auto produce = [&](long long it) {
    const int s = (int)(it % Pl::S);
    const long long use = it / Pl::S;
    if (use > 0) bar_wait(empty + s, (unsigned)((use - 1) & 1));
    bar_arrive_expect(full + s, Pl::STAGE);
    const int c0 = (int)column(it);
    for (int ch = 0; ch < Pl::CHUNKS; ++ch)
      tma_load_2d(sm + s * Pl::STAGE + ch * K * 128, &xmap, c0 + ch * (128 / (int)sizeof(TX)), 0,
                  full + s);
  };
#ifndef ADAFLO_EMULATED
  if (threadIdx.x >= 32 * Pl::WARPS) {  // the producer warp
    if (threadIdx.x == 32 * Pl::WARPS)
      for (long long it = 0; it < n; ++it) produce(it);
    return;
  }
#endif
  const int ctid = threadIdx.x, nthr = consumer_stride(32 * Pl::WARPS);
  unsigned char* sA = sm + Pl::A_OFF;
  [[maybe_unused]] double af[Pl::kF64 ? K / 8 : 1][4];  // float64: A's fragments
  if constexpr (Pl::kSimt) load_a_simt<M, K>((const float*)A, (float*)sA, ctid, nthr);
#ifndef ADAFLO_EMULATED
  else if constexpr (Pl::kF64)
    load_a_f64<K>((const double*)A + (long long)part * Pl::MP * K, af, Pl::MP, ctid);
  else
    load_a_mma<PREC, M, K, TX>(A, sA, ctid, nthr);
#endif
  named_sync(1, 32 * Pl::WARPS);
  [[maybe_unused]] int nchunk = 0;  // chunks (tiles) this thread's warpgroup (warp) has stored
  // the output's TMA stores: written once, evicted from L2 first
  [[maybe_unused]] const uint64_t policy = Pl::kSimt ? 0 : l2_evict_first();
  auto consume = [&](long long it) {
    const int s = (int)(it % Pl::S);
    bar_wait(full + s, (unsigned)((it / Pl::S) & 1));
    const unsigned char* st = sm + s * Pl::STAGE;
    const int c0 = (int)column(it);
    if constexpr (Pl::kSimt)
      simt_tile<M, K>(st, (const float*)sA, (float*)O + c0, ncols, empty + s, ctid, nthr);
#ifndef ADAFLO_EMULATED
    else if constexpr (Pl::kF64)
      f64_tile<K, Pl::STG_BUFS>(st, af, &omap, c0, part * Pl::MP, Pl::MP, sm + Pl::STG_OFF, nchunk,
                                empty + s, ctid, policy);
    else
      mma_tile<PREC, M, K, TX, TO, Pl::STG_BUFS>(st, sA, &omap, c0, sm + Pl::STG_OFF, nchunk,
                                                 empty + s, ctid, policy);
#endif
  };
#ifdef ADAFLO_EMULATED
  // one thread: the producer's copies run S items ahead of the consumer
  for (long long it = 0; it < n && it < Pl::S; ++it) produce(it);
  for (long long it = 0; it < n; ++it) {
    consume(it);
    if (it + Pl::S < n) produce(it + Pl::S);
  }
#else
  for (long long it = 0; it < n; ++it) consume(it);
  // the TMA stores (issued by a warpgroup's or a warp's first thread) have
  // read the staging rows before the block ends
  if (ctid % (Pl::kMma ? 128 : 32) == 0) bulk_wait_read<0>();
#endif
}

// ---------------------------------------------------------------------------
// K8 and K10 keep their tiles on the SM for a run of grid steps. The TPU
// kernels hold their slab and output blocks in VMEM for every grid step (the
// index maps are constant) and touch HBM once. Here a thread block owns a
// work item, one column tile and a run of consecutive grid steps (a step
// group): it loads the tile's slab into shared memory once (cp.async), runs
// its steps on chip, each writing its outputs into an output tile in shared
// memory, and writes that tile to global memory once, after the group. The
// grid is persistent, as many blocks as are resident on the card (the
// occupancy query x SMs: the slots), striding over tiles x G step groups, G =
// max(1, min(slots / tiles, nblk / kGroupSteps)): a block of 2048 or 4096
// columns has 32 to 128 tiles, and the groups fill the 132 SMs; the L2
// traffic, a slab tile and an output tile an item, grows with G, not with
// the steps, and a group takes at least kGroupSteps steps where there are
// enough, so that those two transfers are spread over 4 steps' work (K8 at
// block 4096, 29 steps, on the H100: 12 groups of 2-3 steps 0.0105 ms
// float32, 6 of 4-5 steps 0.0082-0.0085; K10 fastest at slots / tiles,
// which its 58 steps allow). Every step does its work: it begins at a barrier,
// after which its operands are loaded anew from the resident tile (loads
// after __syncthreads are not invariant), and no statement is fed from a
// value held in registers from one step to the next. The blocks of a tile's
// groups write the same values to the same output, as every TPU step does.
struct Steps {
  int tiles, groups, nblk;
  __host__ __device__ int first(int g) const { return (int)((long long)g * nblk / groups); }
  __host__ __device__ long long items() const { return (long long)tiles * groups; }
};

constexpr int kGroupSteps = 4;

__host__ __device__ inline Steps step_groups(int tiles, int nblk, long long slots) {
  long long g = slots / tiles;
  if (g > nblk / kGroupSteps) g = nblk / kGroupSteps;
  return {tiles, g < 1 ? 1 : (int)g, nblk};
}

// The work items of block b of `grid`, in turn: f(tile, first step, end step)
template <typename F>
__device__ __forceinline__ void resident_items(const Steps& st, long long b, long long grid, F f) {
  for (long long i = b; i < st.items(); i += grid) {
    const int g = (int)(i / st.tiles);
    f((int)(i % st.tiles), st.first(g), st.first(g + 1));
  }
}

// The (rows, W) tile `so` of shared memory to the rows of `dst` (row stride
// ld elements), 16 bytes a thread (W * sizeof(T) a multiple of 16, both
// 16-byte aligned)
template <typename T, int W>
__device__ __forceinline__ void store_tile(const T* so, int rows, T* dst, int ld) {
  constexpr int E = 16 / (int)sizeof(T), V = W / E;  // elements of a vector, vectors of a row
#pragma unroll 1
  for (int v = threadIdx.x; v < rows * V; v += blockDim.x) {
    const int r = v / V, e = v % V * E;
    *reinterpret_cast<F4*>(dst + (long long)r * ld + e) =
        *reinterpret_cast<const F4*>(so + r * W + e);
  }
}

#ifdef ADAFLO_EMULATED
long long emu_slots = 0;  // the CPU tests' slots in place of the query's (0: the query's)
#endif

// Resident blocks per SM (the occupancy calculator, after allowing the
// shared memory) and SMs of a resident kernel instance (N, the type of
// kern), queried once.
struct Residency {
  int per_sm, sms;
};

template <int N, typename K>
int residency(K kern, int threads, int smem, Residency* r) {
  static Residency cached = {0, 0};
  if (cached.per_sm == 0) {
    int dev = 0, rc = allow_shared(kern, smem);
    if (rc == 0) rc = (int)cudaGetDevice(&dev);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&cached.sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached.per_sm, kern, threads, smem);
    if (rc != 0) return rc;
    if (cached.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  *r = cached;
  return 0;
}

constexpr int kPlanKeys = 8;

// One launch of a resident kernel on its persistent grid, go(grid, steps);
// or, with `plan`, the launch's plan in its place: [tile columns, threads,
// shared memory, resident blocks per SM, slots, step groups, work items,
// grid].
template <int N, typename K, typename L>
int launch_resident(K kern, int tile, int threads, int smem, int block, int nblk, int* plan,
                    L go) {
  Residency res;
  const int rc = residency<N>(kern, threads, smem, &res);
  if (rc != 0) return rc;
  long long slots = (long long)res.per_sm * res.sms;
#ifdef ADAFLO_EMULATED
  if (emu_slots > 0) slots = emu_slots;
#endif
  const Steps st = step_groups(block / tile, nblk, slots);
  const long long grid = st.items() < slots ? st.items() : slots;
  if (plan != nullptr) {
    const long long p[kPlanKeys] = {tile, threads, smem, res.per_sm, slots, st.groups, st.items(),
                                    grid};
    for (int i = 0; i < kPlanKeys; ++i) plan[i] = (int)p[i];
    return 0;
  }
  go((unsigned)grid, st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8: out[k, c] = x[row_k, off_k + c] for the first N_ROWS entries of the
// 89-entry parity rows table of scripts/probe_sf.py:128-140: 3 components x
// 27 Q2 nodes (parity row c 8 + 4 (z%2) + 2 (y%2) + x%2, offset
// (z/2) 2401 + (y/2) 49 + x/2), then 8 Q1 nodes of row 24.
// Bound: bytes (a copy: the slab elements the copies read, and the output,
// once). Every step still moves its rows through shared memory, one LDS and
// one STS per element: the on-chip floor (scripts/probe_bounds.py).
// Design: resident (above), a work item a tile of kCopyTile columns and a
// step group. The slab tile holds what the copies read: for each source row
// and z half (offset 0 or 2401) that they use, the columns from it to its
// largest y/x offset + kCopyTile (copy_spans: at 64 columns a tile, the
// union that probe_bounds.k8_read_elements counts), 3,432 values at 89
// rows. A step copies the N_ROWS rows from the slab tile into the output
// tile (N_ROWS, kCopyTile), one LDS and one STS per element at offsets fixed
// at compile time (copy_src): a thread takes one column and a quarter of
// the rows, consecutive threads on consecutive columns.
__host__ __device__ constexpr int copy_row(int k) {
  return k < 81 ? (k / 27) * 8 + 4 * ((k % 27 / 9) % 2) + 2 * ((k % 9 / 3) % 2) + (k % 3) % 2
                : 24;
}
__host__ __device__ constexpr int copy_off(int k) {
  return k < 81 ? (k % 27 / 9 / 2) * kSY + (k % 9 / 3 / 2) * kSX + (k % 3) / 2
                : ((k - 81) / 4) * kSY + ((k - 81) % 4 / 2) * kSX + (k - 81) % 2;
}

constexpr int kCopyTile = 64, kCopyParts = 4, kCopyThreads = kCopyTile * kCopyParts;
constexpr int kCopySpans = 2 * 25;  // (source row 0..24, z half)

// The slab tile: span i holds width[i] columns (0: none) of source row i / 2
// from column 2401 (i % 2), at at[i]; at[kCopySpans] values in all
struct CopySpans {
  int width[kCopySpans];
  int at[kCopySpans + 1];
};

__host__ __device__ constexpr CopySpans copy_spans(int n_rows) {
  CopySpans s{};
  for (int k = 0; k < n_rows; ++k) {
    const int i = 2 * copy_row(k) + copy_off(k) / kSY, w = copy_off(k) % kSY + kCopyTile;
    if (w > s.width[i]) s.width[i] = w;
  }
  for (int i = 0; i < kCopySpans; ++i) s.at[i + 1] = s.at[i] + s.width[i];
  return s;
}

// where copy k reads its first column in the slab tile
__host__ __device__ constexpr int copy_src(int n_rows, int k) {
  return copy_spans(n_rows).at[2 * copy_row(k) + copy_off(k) / kSY] + copy_off(k) % kSY;
}

// the first row of part p of the N rows
__host__ __device__ constexpr int copy_part_first(int n_rows, int p) {
  return p * n_rows / kCopyParts;
}

template <typename T, int N_ROWS, int K, int END>
__device__ __forceinline__ void copy_rows(const T* slab, T* so, int j) {
  if constexpr (K < END) {
    constexpr int src = copy_src(N_ROWS, K);
    so[K * kCopyTile + j] = slab[src + j];
    copy_rows<T, N_ROWS, K + 1, END>(slab, so, j);
  }
}

template <typename T, int N_ROWS, int P = 0>
__device__ __forceinline__ void copy_part(int p, const T* slab, T* so, int j) {
  if constexpr (P < kCopyParts) {
    if (p == P)
      copy_rows<T, N_ROWS, copy_part_first(N_ROWS, P), copy_part_first(N_ROWS, P + 1)>(slab, so, j);
    else
      copy_part<T, N_ROWS, P + 1>(p, slab, so, j);
  }
}

// The (column, part) items of a step of K8's tile that thread t of nth takes
template <typename F>
__device__ __forceinline__ void copy_items(int t, int nth, F f) {
#pragma unroll 1
  for (int w = t; w < kCopyThreads; w += nth) f(w % kCopyTile, w / kCopyTile);
}

template <typename T>
constexpr int copy_smem(int n_rows) {
  return (n_rows * kCopyTile + copy_spans(n_rows).at[kCopySpans]) * (int)sizeof(T);
}

template <typename T, int N_ROWS>
__global__ void __launch_bounds__(kCopyThreads)
row_copies_kernel(const T* __restrict__ x, T* __restrict__ out, int ldx, int block, Steps st) {
  constexpr CopySpans sp = copy_spans(N_ROWS);
  T* so = shared_base<T>();  // the output tile (N_ROWS, kCopyTile)
  T* slab = so + N_ROWS * kCopyTile;
  resident_items(st, blockIdx.x, gridDim.x, [&](int tile, int s0, int s1) {
    const int c0 = tile * kCopyTile;
#pragma unroll
    for (int i = 0; i < kCopySpans; ++i) {
      const T* src = x + (long long)(i / 2) * ldx + i % 2 * kSY + c0;
      for (int e = threadIdx.x; e < sp.width[i]; e += blockDim.x)
        async_copy(slab + sp.at[i] + e, src + e, false);
    }
    async_commit();
    async_wait<0>();
#pragma unroll 1
    for (int s = s0; s < s1; ++s) {
      __syncthreads();  // the step's loads follow the barrier (and the slab's copies)
      copy_items(threadIdx.x, blockDim.x,
                 [&](int j, int p) { copy_part<T, N_ROWS>(p, slab, so, j); });
    }
    __syncthreads();
    store_tile<T, kCopyTile>(so, N_ROWS, out + c0, block);
  });
}

// ---------------------------------------------------------------------------
// K10: the three-stage sum-factorized evaluation of scripts/probe_sf.py:204
// (_sf_eval_body) from the (32, block + 2560) parity slab: stage z (flat shift
// 2401) writes 18 statements of (4, w1), stage y (shift 49) 81 of (2, w2),
// stage x (shift 1) 324 of (1, block) into the q rows kind 96 + c 32 + q of
// the (384, block) output; the pad rows q = 27..31 are 0 (the JAX kernel
// leaves them unwritten). Each statement is
//   out = C0 a + C1 b + C2 a_shifted
// with C the axis' value (V) or derivative (D) coefficients.
// Bound: operations, 5 flops per written element of the JAX kernel's widths
// (w1 = block + 64, w2 = block + 8).
// Design: resident (above). The stages mix neither the components c nor
// the stage-z planes qz (stage y's plane (qz, qy) reads stage z's plane qz,
// stage x's q row (qz, qy, qx) stage y's plane (qz, qy)), so a work item of
// a step is one column j, one c and one qz: 9 a column, kSfTile columns a
// tile (32 float32, 16 float64: 128 bytes of an output row), one thread
// each. An item loads the 27 slab values its outputs depend on into
// registers, once, and computes every statement from registers: stage z's
// two kinds at the 9 places that stage y reads (rows 0-3 at j, 0 and 2 at
// j + 1, 0 and 1 at j + 49, 0 at j + 50: sf_zcol, sf_zrow), stage y's 3
// planes qy x 3 kinds at the 3 places that stage x reads (rows 0 and 1 at
// j, 0 at j + 1), stage x's 3 qx x 4 kinds. The halo of the two shifts is
// recomputed in registers, not exchanged through shared memory: 81
// statements' elements an item, 729 a column, against the JAX kernel's 558
// and its halo (probe_bounds.k10_elements_per_step). The item's 36 q rows
// go into the output tile (384, kSfTile) in shared memory; its pad rows are
// zeroed once a block. Stage y's planes qy and stage x's qx repeat one
// expression on one datum, which ptxas merges once it is fed from registers
// (K7's statements did): each statement's first coefficient is salted by its
// qy or qx (hopper.cuh salted), its zero derived from the column and the
// step, so that no two statements on the same data share a form and no
// salted coefficient is held across steps. A statement is a multiply and two
// FMAs: 243 FP instructions and 27 LDS an item and step
// (scripts/sass_counts.check_sfeval).
// Shared memory: the output tile and the slab tile, 36 rows (24 at +0, the
// 12 pz = 0 rows at +2401) x (kSfTile + 50) columns: 60,960 B float32 and
// 68,160 B float64, 3 blocks per SM (9 warps each float32, 4.5 float64).
template <typename T>
struct SfCoeffs {
  T V[3][3];  // per axis z, y, x: the three terms of the value
  T D[3][3];  // and of the derivative
};

constexpr int kSfRows = 384, kSfSlabRows = 36;
template <typename T>
constexpr int kSfTile = 128 / (int)sizeof(T);
template <typename T>
constexpr int kSfThreads = 9 * kSfTile<T>;
template <typename T>
constexpr int kSfSmem = (kSfRows * kSfTile<T> + kSfSlabRows * (kSfTile<T> + kSX + 1)) * (int)sizeof(T);

// stage z's place i (0..8) that stage y reads: column offset and row 2 py + px
__host__ __device__ constexpr int sf_zcol(int i) {
  return i < 4 ? 0 : i < 6 ? 1 : i < 8 ? kSX : kSX + 1;
}
__host__ __device__ constexpr int sf_zrow(int i) { return i < 4 ? i : i == 5 ? 2 : i == 7 ? 1 : 0; }

// the q row of output kind ko (value, d/dx, d/dy, d/dz), component c, q point q
__host__ __device__ constexpr int sf_row(int ko, int c, int q) { return ko * 96 + c * 32 + q; }

// the pad row of the i-th of the 60 (kind, c) x q = 27..31
__host__ __device__ constexpr int sf_pad_row(int i) { return i / 5 * 32 + 27 + i % 5; }

template <typename T>
__device__ __forceinline__ T sf_coef(const SfCoeffs<T>& co, bool deriv, int axis, int term) {
  return deriv ? co.D[axis][term] : co.V[axis][term];
}

// a statement, left to right: the first product alone (it carries the
// salt), the others fused into the sums
template <typename T>
__device__ __forceinline__ T sf_stmt(T w, T c1, T c2, T a, T b, T a2) {
  return fma_rn(c2, a2, fma_rn(c1, b, mul_rn(w, a)));
}

// The (column, c, qz) items of a step of K10's tile that thread t of nth takes
template <int W, typename F>
__device__ __forceinline__ void sf_items(int t, int nth, F f) {
#pragma unroll 1
  for (int w = t; w < 9 * W; w += nth) f(w % W, w / W / 3, w / W % 3);
}

template <typename T, int W>
__device__ __forceinline__ void sf_item(const T* slab, T* so, const SfCoeffs<T>& co, int j, int c,
                                        int qz, unsigned zi) {
  constexpr int WZ = W + kSX + 1;
  const T* p = slab + c * 8 * WZ + j;          // slab rows c 8 + 4 pz + 2 py + px
  const T* p2 = slab + (24 + c * 4) * WZ + j;  // rows c 8 + 2 py + px at +2401
  T a[9], b[9], a2[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    a[i] = p[sf_zrow(i) * WZ + sf_zcol(i)];
    b[i] = p[(4 + sf_zrow(i)) * WZ + sf_zcol(i)];
    a2[i] = p2[sf_zrow(i) * WZ + sf_zcol(i)];
  }
  T z[2][9];  // stage z: value and d/dz at the 9 places
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < 9; ++i)
      z[k][i] = sf_stmt(sf_coef(co, k, 0, 0), sf_coef(co, k, 0, 1), sf_coef(co, k, 0, 2), a[i],
                        b[i], a2[i]);
#pragma unroll
  for (int qy = 0; qy < 3; ++qy) {
    // stage y: value and d/dy of stage z's value, d/dz of its d/dz, at (j,
    // row 0), (j, row 1), (j + 1, row 0)
    T y[3][3];
#pragma unroll
    for (int ko = 0; ko < 3; ++ko) {
      const bool d = ko == 1;
      const T w = salted(sf_coef(co, d, 1, 0), zi, qy + 1), c1 = sf_coef(co, d, 1, 1),
              c2 = sf_coef(co, d, 1, 2);
      const T* zk = z[ko == 2];
      y[ko][0] = sf_stmt(w, c1, c2, zk[0], zk[2], zk[6]);
      y[ko][1] = sf_stmt(w, c1, c2, zk[1], zk[3], zk[7]);
      y[ko][2] = sf_stmt(w, c1, c2, zk[4], zk[5], zk[8]);
    }
    // stage x: value and d/dx of stage y's value, d/dy, d/dz
#pragma unroll
    for (int qx = 0; qx < 3; ++qx)
#pragma unroll
      for (int ko = 0; ko < 4; ++ko) {
        const bool d = ko == 1;
        const T* yk = y[ko < 2 ? 0 : ko - 1];
        so[sf_row(ko, c, qz * 9 + qy * 3 + qx) * W + j] =
            sf_stmt(salted(sf_coef(co, d, 2, 0), zi, qx + 1), sf_coef(co, d, 2, 1),
                    sf_coef(co, d, 2, 2), yk[0], yk[1], yk[2]);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSfThreads<T>, 3)
sf_eval_kernel(const T* __restrict__ x, T* __restrict__ out, int ldx, int block, Steps st,
               SfCoeffs<T> co, unsigned zero) {
  // zero: 0
  constexpr int W = kSfTile<T>, WZ = W + kSX + 1;
  T* so = shared_base<T>();      // the output tile (384, W)
  T* slab = so + kSfRows * W;    // the slab tile (36, WZ)
  for (int i = threadIdx.x; i < 60 * W; i += blockDim.x) so[sf_pad_row(i / W) * W + i % W] = T(0);
  resident_items(st, blockIdx.x, gridDim.x, [&](int tile, int s0, int s1) {
    const int c0 = tile * W;
    for (int i = threadIdx.x; i < kSfSlabRows * WZ; i += blockDim.x) {
      const int r = i / WZ, e = i % WZ;  // slab row r (r < 24), or row c 8 + r' at +2401
      const long long src = r < 24 ? (long long)r * ldx
                                   : (long long)((r - 24) / 4 * 8 + (r - 24) % 4) * ldx + kSY;
      async_copy(slab + i, x + src + c0 + e, false);
    }
    async_commit();
    async_wait<0>();
#pragma unroll 1
    for (int s = s0; s < s1; ++s) {
      __syncthreads();  // the step's loads follow the barrier (and the slab's copies)
      sf_items<W>(threadIdx.x, blockDim.x, [&](int j, int c, int qz) {
        sf_item<T, W>(slab, so, co, j, c, qz, zero & (unsigned)(c0 + j + s));
      });
    }
    __syncthreads();
    store_tile<T, W>(so, kSfRows, out + c0, block);
  });
}

// ---------------------------------------------------------------------------
// launches

template <typename T>
int launch_row_fma(int n_ops, int shifted, const void* x, void* out, int block, int nblk,
                   cudaStream_t st) {
  const int tiles = (block + kTile - 1) / kTile;
  auto go = [&](auto kern) {
    kern<<<(unsigned)(tiles * nblk), kFmaThreads, 0, st>>>((const T*)x, (T*)out, block + 128, block,
                                                           tiles, 0u);
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

// The dot's instances: f(types, shape) for an entry's precision, streaming
// and (m, k); float32, TF32 and float64 read and write their own type (TF32
// float32), bf16 reads float32 (K9) or bf16 (K5, (384, 96) only).
template <int PREC_, typename TX, typename TO>
struct DotTypes {
  static constexpr int PREC = PREC_;
  using X = TX;
  using O = TO;
};
template <int M_, int K_>
struct DotShape {
  static constexpr int M = M_, K = K_;
};

template <typename F>
int with_shape(int m, int k, F f) {
  if (m == 96 && k == 96) return f(DotShape<96, 96>{});
  if (m == 384 && k == 96) return f(DotShape<384, 96>{});
  if (m == 96 && k == 32) return f(DotShape<96, 32>{});
  if (m == 384 && k == 32) return f(DotShape<384, 32>{});
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int with_dot(int prec, int m, int k, int streamed, F f) {
  auto shapes = [&](auto types) { return with_shape(m, k, [&](auto mk) { return f(types, mk); }); };
  if (prec == kPrecF32) return shapes(DotTypes<kPrecF32, float, float>{});
#ifndef ADAFLO_EMULATED
  if (prec == kPrecTF32) return shapes(DotTypes<kPrecTF32, float, float>{});
  if (prec == kPrecF64) return shapes(DotTypes<kPrecF64, double, double>{});
  if (prec == kPrecBF16 && !streamed) return shapes(DotTypes<kPrecBF16, float, float>{});
  if (prec == kPrecBF16 && m == 384 && k == 96)
    return f(DotTypes<kPrecBF16, __nv_bfloat16, __nv_bfloat16>{}, DotShape<384, 96>{});
#endif
  return (int)cudaErrorInvalidValue;
}

// Shared memory, resident blocks per SM (the occupancy calculator, after
// allowing the shared memory) and SMs of an instance, queried once.
struct DotResidency {
  int smem, per_sm, sms;
};

template <typename Ty, typename Sh>
int dot_residency(DotResidency* r) {
  using Pl = DotPlan<Ty::PREC, Sh::M, Sh::K, (int)sizeof(typename Ty::X), (int)sizeof(typename Ty::O)>;
  static DotResidency cached = {0, 0, 0};
  if (cached.per_sm == 0) {
    auto kern = dense_dot_kernel<Ty::PREC, Sh::M, Sh::K, typename Ty::X, typename Ty::O>;
    int dev = 0, rc = allow_shared(kern, Pl::SMEM);
    if (rc == 0) rc = (int)cudaGetDevice(&dev);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&cached.sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached.per_sm, kern, Pl::THREADS,
                                                              Pl::SMEM);
    if (rc != 0) return rc;
    if (cached.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached.smem = Pl::SMEM;
  }
  *r = cached;
  return 0;
}

// One launch over `steps` grid steps (K5: 1) of the ncols columns of X.
template <typename Ty, typename Sh>
int launch_dot(const void* A, const void* X, void* O, long long ncols, long long steps,
               cudaStream_t st) {
  using TX = typename Ty::X;
  using TO = typename Ty::O;
  using Pl = DotPlan<Ty::PREC, Sh::M, Sh::K, (int)sizeof(TX), (int)sizeof(TO)>;
  DotResidency res;
  int rc = dot_residency<Ty, Sh>(&res);
  if (rc != 0) return rc;
  // the tile maps of the last X and O (rebuilt when an array changes): X in
  // K-row boxes, O in the epilogue's boxes (OUT_ROWS rows)
  static TileMap xmap, omap;
  static const void *map_x = nullptr, *map_o = nullptr;
  static long long map_cols = 0;
  if (map_x != X || map_o != O || map_cols != ncols) {
    rc = make_tile_map<TX>(&xmap, X, ncols, Sh::K, Sh::K);
    if (rc == 0) rc = make_tile_map<TO>(&omap, O, ncols, Sh::M, Pl::OUT_ROWS);
    if (rc != 0) return rc;
    map_x = X, map_o = O, map_cols = ncols;
  }
  const long long tiles = ncols / Pl::W, items = tiles * steps;
  const long long slots = (long long)res.per_sm * res.sms / Pl::P;
  const long long grid = Pl::P * (items < slots ? items : slots);
  auto kern = dense_dot_kernel<Ty::PREC, Sh::M, Sh::K, TX, TO>;
  kern<<<(unsigned)grid, Pl::THREADS, Pl::SMEM, st>>>(xmap, omap, (const TX*)A, (TO*)O, ncols, tiles,
                                                      items);
  return (int)cudaGetLastError();
}

template <typename T, int N_ROWS>
int launch_row_copies(const void* x, void* out, int block, int nblk, cudaStream_t st, int* plan) {
  auto kern = row_copies_kernel<T, N_ROWS>;
  constexpr int smem = copy_smem<T>(N_ROWS);
  return launch_resident<N_ROWS>(kern, kCopyTile, kCopyThreads, smem, block, nblk, plan,
                                 [&](unsigned grid, Steps s) {
    kern<<<grid, kCopyThreads, smem, st>>>((const T*)x, (T*)out, block + 2560, block, s);
  });
}

// coeffs: host doubles [V (3 axes z, y, x x 3 terms), D (3 x 3)]; none for a plan
template <typename T>
int launch_sf_eval(const void* x, void* out, int block, int nblk, const double* coeffs,
                   cudaStream_t st, int* plan) {
  SfCoeffs<T> co = {};
  for (int a = 0; a < 3 && coeffs != nullptr; ++a)
    for (int i = 0; i < 3; ++i) {
      co.V[a][i] = (T)coeffs[a * 3 + i];
      co.D[a][i] = (T)coeffs[9 + a * 3 + i];
    }
  auto kern = sf_eval_kernel<T>;
  return launch_resident<0>(kern, kSfTile<T>, kSfThreads<T>, kSfSmem<T>, block, nblk, plan,
                            [&](unsigned grid, Steps s) {
    kern<<<grid, kSfThreads<T>, kSfSmem<T>, st>>>((const T*)x, (T*)out, block + 2560, block, s, co, 0u);
  });
}

bool bad_block(int block, int nblk) { return block <= 0 || block % kTile != 0 || nblk <= 0; }

// K8's and K10's launches, or with `plan` their plans (launch_resident)
int row_copies_entry(int dtype, int n_rows, const void* x, void* out, int block, int nblk,
                     cudaStream_t st, int* plan) {
  if (bad_block(block, nblk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && n_rows == 29) return launch_row_copies<float, 29>(x, out, block, nblk, st, plan);
  if (dtype == 0 && n_rows == 89) return launch_row_copies<float, 89>(x, out, block, nblk, st, plan);
  if (dtype == 1 && n_rows == 29) return launch_row_copies<double, 29>(x, out, block, nblk, st, plan);
  if (dtype == 1 && n_rows == 89) return launch_row_copies<double, 89>(x, out, block, nblk, st, plan);
  return (int)cudaErrorInvalidValue;
}

int sf_eval_entry(int dtype, const void* x, void* out, int block, int nblk, const double* coeffs,
                  cudaStream_t st, int* plan) {
  if (bad_block(block, nblk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_sf_eval<float>(x, out, block, nblk, coeffs, st, plan);
  if (dtype == 1) return launch_sf_eval<double>(x, out, block, nblk, coeffs, st, plan);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K7. dtype 0 float32, 1 float64. x (96, block + 128), out (24, block), block
// any positive width; n_ops 24, 72 or 96; shifted 0/1; nblk grid steps.
int adaflo_row_fma(int dtype, int n_ops, int shifted, const void* x, void* out, int block,
                   int nblk, void* stream) {
  if (block <= 0 || nblk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_row_fma<float>(n_ops, shifted, x, out, block, nblk, st);
  if (dtype == 1) return launch_row_fma<double>(n_ops, shifted, x, out, block, nblk, st);
  return (int)cudaErrorInvalidValue;
}

// K8. x (32, block + 2560), out (n_rows, block); n_rows 29 or 89.
int adaflo_row_copies(int dtype, int n_rows, const void* x, void* out, int block, int nblk,
                      void* stream) {
  return row_copies_entry(dtype, n_rows, x, out, block, nblk, (cudaStream_t)stream, nullptr);
}

// The plan of K8's (kernel 0, n_rows 29 or 89) or K10's (kernel 1) launch at
// (dtype, block, nblk): out = [tile columns, threads, shared memory bytes,
// resident blocks per SM, slots, step groups, work items, grid].
int adaflo_resident_plan(int kernel, int dtype, int n_rows, int block, int nblk, int* out) {
  if (kernel == 0) return row_copies_entry(dtype, n_rows, nullptr, nullptr, block, nblk, 0, out);
  if (kernel == 1) return sf_eval_entry(dtype, nullptr, nullptr, block, nblk, nullptr, 0, out);
  return (int)cudaErrorInvalidValue;
}

// K9 (streamed 0) and K5 (streamed 1): O (m, ncols) = A (m, k) X (k, ncols).
// prec 0 f32, 1 tf32, 2 bf16, 3 f64. Resident: A, X float32 (float64 for
// f64), O float32 (float64), nblk grid steps over the same X. Streamed: A, X
// and O of one type, float32 (f32, tf32), bf16 or float64; m 384, k 96.
// (m, k) in {96, 384} x {96, 32}; ncols a multiple of 64; A, X, O 16-byte
// aligned.
int adaflo_dense_dot(int prec, int m, int k, int streamed, const void* A, const void* X,
                     void* O, long long ncols, int nblk, void* stream) {
  if (ncols <= 0 || ncols % kTile != 0 || nblk <= 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)A | (uintptr_t)X | (uintptr_t)O) % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long steps = streamed ? 1 : nblk;
  return with_dot(prec, m, k, streamed, [&](auto ty, auto sh) {
    return launch_dot<decltype(ty), decltype(sh)>(A, X, O, ncols, steps, (cudaStream_t)stream);
  });
}

// The plan of a dot instance: out = [shared memory bytes, resident blocks per
// SM, threads per block, columns of a work item, parts of A's rows, stages].
int adaflo_dense_dot_plan(int prec, int m, int k, int streamed, int* out) {
  return with_dot(prec, m, k, streamed, [&](auto ty, auto sh) {
    using Ty = decltype(ty);
    using Sh = decltype(sh);
    using Pl = DotPlan<Ty::PREC, Sh::M, Sh::K, (int)sizeof(typename Ty::X),
                       (int)sizeof(typename Ty::O)>;
    DotResidency res;
    const int rc = dot_residency<Ty, Sh>(&res);
    if (rc != 0) return rc;
    const int plan[6] = {Pl::SMEM, res.per_sm, Pl::THREADS, Pl::W, Pl::P, Pl::S};
    for (int i = 0; i < 6; ++i) out[i] = plan[i];
    return 0;
  });
}

#ifdef ADAFLO_EMULATED
// The dot's layout arithmetic, for the CPU tests to hold against the PTX
// ISA's formulas.
int adaflo_emu_swz128(int row, int byte) { return swz128(row, byte); }
unsigned long long adaflo_emu_wgmma_desc(unsigned saddr, unsigned lbo, unsigned sbo) {
  return wgmma_desc(saddr, lbo, sbo);
}
int adaflo_emu_mma_a_offset(int m, int k, int M, int AS) { return mma_a_offset(m, k, M, AS); }
unsigned adaflo_emu_mma_b_start(int n0, int q, int ks, int M) { return mma_b_start(n0, q, ks, M); }
unsigned adaflo_emu_mma_x_start(int ks) { return mma_x_start(ks); }
int adaflo_emu_f64_kslot(int s) { return f64_kslot(s); }
int adaflo_emu_f64_col(int n, int j) { return f64_col(n, j); }
// K7's writes at a block width `block`: counts[row * block + col] += 1 for
// each output element that the work items of every column tile and thread
// of kFmaThreads write
void adaflo_emu_fma_writes(int block, int* counts) {
  const int tiles = (block + kTile - 1) / kTile;
  for (int tile = 0; tile < tiles; ++tile)
    for (int t = 0; t < kFmaThreads; ++t)
      fma_items(tile, block, t, kFmaThreads, [&](int col, int r) {
        for (int i = 0; i < 3; ++i) ++counts[(r + 8 * i) * block + col];
      });
}
// the items of block `block` of `grid` (out[0..n)), returns n
long long adaflo_emu_dot_items(long long block, long long grid, int parts, long long items,
                               long long* out) {
  const DotSched d = dot_sched(block, grid, parts, items);
  for (long long it = 0; it < d.n; ++it) out[it] = d.first + it * d.stride;
  return d.n;
}
// K8's and K10's launches on `slots` slots in place of the occupancy query's
// (0: the query's)
void adaflo_emu_set_slots(long long slots) { emu_slots = slots; }
// K8's (kernel 0) or K10's (1) work at (dtype, n_rows, block, nblk) on its
// persistent grid: runs[tile * nblk + step] += 1 for each step that a
// block's work items run; writes[row * tile columns + col] += 1 for each
// element of the output tile that the block's threads write in one step,
// K10's pad rows (zeroed once) included
int adaflo_emu_resident_work(int kernel, int dtype, int n_rows, int block, int nblk, int* runs,
                             int* writes) {
  int plan[kPlanKeys];
  const int rc = adaflo_resident_plan(kernel, dtype, n_rows, block, nblk, plan);
  if (rc != 0) return rc;
  const int tile = plan[0], threads = plan[1];
  const Steps st = step_groups(block / tile, nblk, plan[4]);
  for (long long b = 0; b < plan[7]; ++b)
    resident_items(st, b, plan[7], [&](int t, int s0, int s1) {
      for (int s = s0; s < s1; ++s) ++runs[t * nblk + s];
    });
  for (int t = 0; t < threads; ++t) {
    if (kernel == 0) {
      copy_items(t, threads, [&](int j, int p) {
        for (int k = copy_part_first(n_rows, p); k < copy_part_first(n_rows, p + 1); ++k)
          ++writes[k * tile + j];
      });
      continue;
    }
    for (int i = t; i < 60 * tile; i += threads) ++writes[sf_pad_row(i / tile) * tile + i % tile];
    auto item = [&](int j, int c, int qz) {
      for (int q = 9 * qz; q < 9 * qz + 9; ++q)
        for (int ko = 0; ko < 4; ++ko) ++writes[sf_row(ko, c, q) * tile + j];
    };
    if (tile == kSfTile<float>)
      sf_items<kSfTile<float>>(t, threads, item);
    else
      sf_items<kSfTile<double>>(t, threads, item);
  }
  return 0;
}
#endif

// K10. x (32, block + 2560), out (384, block); coeffs: host doubles
// [V (3 axes z, y, x x 3 terms), D (3 x 3)].
int adaflo_sf_eval(int dtype, const void* x, void* out, int block, int nblk,
                   const double* coeffs, void* stream) {
  return sf_eval_entry(dtype, x, out, block, nblk, coeffs, (cudaStream_t)stream, nullptr);
}

}  // extern "C"
