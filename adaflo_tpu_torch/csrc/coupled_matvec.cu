// Coupled Navier-Stokes cell apply for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of adaflo_tpu/ops/pallas_matvec.py:
//   K1 coupled_vmult_pr2    the resident apply inside the Krylov solve,
//   K2 coupled_vmult_pr     the plain apply of vmult / velocity_vmult,
//   K3 coupled_vmult_cells  the same cell math on pre-gathered cell blocks
//                           (_kernel_su: u* dof stream; _kernel: u* q-field
//                           stream), unscattered output,
//   K4 coupled_vmult_parity K1's gather inside the kernel, K3's unscattered
//                           output (_kernel_pi);
// and the measurement probes of scripts/ that ablate the resident apply:
//   K12 probe_pr_phases.py  apply_fn (_kernel_ablate): minus one phase,
//   K13 probe_pr_parts.py   run_variant (make_kernel): whole-apply ablations,
//                           and the full apply under its three TPU
//                           schedules (make_kernel_rowdma, make_kernel_pipe,
//                           make_kernel_unroll2),
//   K11 probe_pr_grouped.py build_call (make_kernel_grouped): the apply with
//                           a gather that reads no per-dof table,
//   K6  probe_pr.py         ring_scatter (scatter_ring_kernel): the
//                           cell-block scatter alone.
// K1-K4, K11, K12 and K13 are template instances of one cell kernel (K12 and
// K13 through its phase mask, K13's TPU schedules through its schedule, K11
// through the lattice source); K6 is scatter_tiles_kernel. The cell kernel
// computes, for every cell of a uniform Cartesian lattice, the
// Newton-linearized Navier-Stokes operator
//
//   value_c  = (rho w - d) u_c + tau1 rho conv_c          (constant mode)
//            = rho(q) (w u_c + tau1 conv_c) - d(q) u_c    (variable mode)
//   conv_c   = beta (div u  u*_c + div u*  u_c) + sum_e (u*_e d_e u_c + u_e d_e u*_c)
//   stress_cd = tau1 mu (d_d u_c + d_c u_d) + (tau_gd div u - p) delta_cd
//   prow     = -div u
//
// integrated against the test functions. Two compile-time switches select
// where a cell's inputs come from and where its results go:
//   gather source  kSrcTable: nodal u, p, u* through the int32 cell tables,
//                  constrained entries of u and p read as zero (K1, K2, K4);
//                  kSrcBlock: a cell-major (E, n_cols) block x that the caller
//                  gathered, and a cell-major u* stream (K3);
//   output         kOutScatter: atomicAdd into the nodal output (K1, K2);
//                  kOutBlock: a plain store of the (E, n_cols) cell block,
//                  for the caller's scatter (K3, K4).
// kSrcLattice (K11) reads like kSrcTable with the addresses computed from
// the cell's lattice coordinates. A third switch selects K3's u* stream: the
// u* cell dofs (E, dim n_u),
// evaluated in the kernel like u, or the u* values and physical gradients at
// the q points (E, dim (dim+1), n_q), read as they are. n_cols is
// dim n_u + n_p, or dim n_u for the velocity-only instances (PRES = false).
// For K1 and K2 a second small kernel (the epilogue) sets the constrained
// rows (+x for velocity, -x for pressure, or 0), applies the output scale and
// accumulates sum(out^2); K3 and K4 leave the constrained rows to the caller.
//
// Design. The TPU kernel's parity packing, 128-lane blocks, 27->32 q-row
// padding and ring DMA answer the TPU's vector memory and are not copied.
// Here one thread block of 128 threads takes CPB cells, CPB a compile-time
// constant of the instance (cells_per_block: 10 in float64 and 20 in float32
// at 3D Q2/Q1). The cell's dofs (u, the frozen linearization point u*, p)
// are gathered through an int32 cell->dof table into shared memory, with
// constrained entries read as zero; consecutive threads take one local dof
// of consecutive cells, so that a warp reads neighbouring lattice entries.
// Values and gradients at the Gauss points come from sum factorization, one
// 1D contraction per axis with the (Q1 x N1) basis values V and derivatives
// D; the q-point terms follow NavierStokesOperator._q_point_terms for
// "vmult"; the transposed sum factorization integrates them.
//
// The one-shot body (every production instance, K11, K12 and K13's phase
// masks; K13's three schedules run its stages too). Every extent is a
// template constant, so no stage indexes with a runtime division. The work
// items of the sum factorization are whole 1D lines of a cell: a thread
// loads a line's N1 (or Q1) inputs of every field it needs into registers
// once and writes the V and D contractions of that line (the transposed
// stages pair V^T and D^T the same way). The 1D matrices are a by-value
// kernel argument, read with compile-time indices, so that each FMA takes
// its matrix operand from the constant bank. Each line is read and written
// in place at the same positions of a cell's slots, so one cell needs only
// its slots: 6 items x 4 fields + the pressure, 25 tensors of 27 values at
// 3D Q2/Q1, 5,592 bytes in float64 with the bank padding. The stages:
// gather (lines_gather); evaluation along x, y, z; the q-point terms
// (lines_compute from here on), one thread per (cell, q point), over the
// point's own positions; integration along x, y, z, whose last lines add
// their outputs into the nodal vectors (atomicAdd) or store the cell block.
// Seven barriers per group of cells (3D), five in 2D. Shared memory sets the
// blocks per SM: four, so 40 float64 and 80 float32 cells per SM at 3D
// Q2/Q1 (__launch_bounds__ keeps the registers to 128). The order of every
// sum is that of the body it replaced (one thread per output element of a
// 1D contraction from shared memory), integration x first, and the stress
// diagonal's roundings are spelled out (fma_rn, mul_rn: left to the
// compiler, they follow the code around them), so K3's and K4's blocks kept
// their bits: fusing the z evaluation, the q-point terms and the z
// integration in registers ran 10 % faster but reordered the integration's
// sums, and the periodic channel's BiCGStab inner solves (deterministic,
// through K3) then took other iteration counts.
//
// Schedules (the SCHED template parameter; K13's TPU schedules, probe
// instances only). The production schedule kSchedOnce gives each thread
// block one group of CPB cells: gather, compute, scatter, so the gather
// overlaps the compute only across the SM's other resident blocks. The TPU
// probe's three schedules overlap them inside the kernel with DMAs into VMEM;
// here they are asynchronous copies into shared memory, on a persistent grid
// (as many blocks as fit resident, each looping over the cell groups
// blockIdx.x, blockIdx.x + gridDim.x, ...), each running the one-shot body's
// gather and compute, split (lines_gather, lines_compute):
//   kSchedPipe (pipe)  one work area of CPB cells: the next group's x-runs
//     of the lattice (per row segment of the group 9 runs of each of the 6
//     velocity vectors and 4 of the pressure) as 1D bulk copies (TMA,
//     cp.async.bulk) of their 16-byte aligned supersets into a slab,
//     completing on an mbarrier while this group computes; after the
//     barrier that ends this group's integration, the slab is assembled,
//     masks applied, straight into the work area's gather slots;
//   kSchedPair (unroll2)  two work areas: two groups per iteration pair, the
//     gather of one (one 4- or 8-byte cp.async per value at the cell table's
//     address, a constrained entry zero-filled by a source size of 0) in
//     flight into the other work area's gather slots while the other
//     computes;
//   kSchedRowAsync (rowdma)  one work area and a double-buffered staging
//     area of the gathered dofs alone (per cell the 6 items' 27 and the
//     pressure's 8, Lines::SG values): the next group's gather, unroll2's
//     cp.async per value, in flight into the other staging slot while this
//     group computes; stage x reads its input lines from this group's
//     staging slot in place of the work area's gather slots, so no copy
//     passes through shared memory twice (the pipe's assembly does).
// Each takes CPB at compile time as the most cells per group at which four
// blocks fit on an SM, as the one-shot body's do (sched_cpb: rowdma 6,
// pipe 7 and unroll2 5 float64 cells, 13, 14 and 10 float32 at the probe
// box's 48 cells along x), and the one-shot body's register cap.
// Unlike the TPU kernels, every schedule covers every cell (an odd group
// count leaves the last pair without its second group) and pads nothing
// that it does not write. Their bound is the full apply's.
//
// Scatter. atomicAdd into the zeroed output (native for float64 on sm_60 and
// later). A dof on a vertex takes up to 8 cell contributions, so the sum order
// changes from run to run by roundoff: results agree with the plain PyTorch
// version to about 1e-15 relative, not bit for bit. K3 and K4 write each
// output element once with a plain store, so they are deterministic.
//
// Bound on an H100 SXM at its 700 W limit (NVIDIA data sheet: 3.35 TB/s
// HBM3, 34 TFLOP/s float64 outside the tensor cores). Per apply the kernel
// must read u, u* and p once, read the int32 cell tables and masks once, and
// write the output once: at the 48^3-cell Q2/Q1 lattice (2,855,668 dofs)
// that is 85.9 MB in float64, 25.6 us at 3.35 TB/s. The sum factorization
// needs 14,482 flops per cell (3D Q2/Q1; 14,067 without the pressure stages
// of the velocity-only entry), 1.60 GFLOP at 48^3, 47 us at 34 TFLOP/s: the
// kernel is bound by operations, about 1.8 times over (chip_smoke.py counts
// both bounds from each run's shapes). The contractions stay on the CUDA
// cores: a 3-long contraction fills a DMMA m8n8k4 tile to 3/8 x 3/4, and the
// dense cell matrix costs 19 times the operations. What keeps the body from
// the bound: the gather is uncoalesced (one cell's dofs are strided across
// the lattice), the atomics serialize on shared vertices, and every stage's
// fields pass through shared memory, whose 25 slots per cell hold 40 float64
// cells per SM (a stage's lines of a block wait at its barrier for the
// slowest). K3 moves more bytes per cell than
// K1 and does the same operations (the q-field stream: fewer, without the
// u* evaluation): it reads the (E, n_cols) block and the stream and writes
// the (E, n_cols) block, about (89 + 81 + 89) values per 3D Q2/Q1 cell with
// the dof stream and (89 + 324 + 89) with the q-field stream, so it is bound
// by bytes. K4 reads K1's nodal inputs and writes K3's block; it is bound by
// operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__host__ __device__ constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

constexpr int kThreads = 128;
constexpr int kMaxTab = 16;

// gather source, u* stream and output of a cell-kernel instance
constexpr int kSrcTable = 0, kSrcBlock = 1, kSrcLattice = 2;
constexpr int kStreamDofs = 0, kStreamQFields = 1;
constexpr int kOutScatter = 0, kOutBlock = 1;

// Phases of the cell kernel (the PH template parameter, a bit mask). The
// production instances run all six; the probe instances (K12, K13) drop some.
// A dropped phase writes, in place of its results, plain copies of its
// inputs where the next phase reads (the rule of each is at its place
// below). Every phase leaves its results in shared memory, which the
// compiler does not delete, so the phases before a dropped one still run.
//   kPhContig  gather at contiguous addresses: cell e, local l reads entry
//              (e n_loc + l) mod n of each vector, no table (K13 "noshift");
//   kPhMDot    the dense per-cell product out = M89 x in place of the
//              evaluation, q-point and integration phases (K13 "mdot").
// Without kPhScatter the output is a plain store of the dofs that a cell
// owns (local coordinates below the degree on every axis, one cell per
// node): the output store without the accumulation.
constexpr int kPhGather = 1, kPhEvalU = 2, kPhEvalUs = 4, kPhQPoint = 8,
              kPhIntegrate = 16, kPhScatter = 32, kPhAll = 63, kPhContig = 64,
              kPhMDot = 128;

// Schedules of the cell kernel (the SCHED template parameter, see the top).
constexpr int kSchedOnce = 0, kSchedRowAsync = 1, kSchedPipe = 2, kSchedPair = 3;

template <typename T>
struct Tables {
  T V[kMaxTab];   // (Q1, N1) velocity basis values at the Gauss points
  T D[kMaxTab];   // (Q1, N1) reference derivatives on [0, 1]
  T Vp[kMaxTab];  // (Q1, P1) pressure basis values
  T w[4];         // Gauss weights on [0, 1]
  T inv_h[3];     // 1 / cell extent per axis (x, y, z)
  T vol;          // cell volume
};

template <typename T>
struct Scalars {
  T beta, weight, tau1, rho0, mu0, damp0, tgd;
};

// Arguments that only the probe instances read: the (n_cols, n_cols) matrix
// M89 of kPhMDot, the pressure length of kPhContig, and the cells per axis
// of the lattice source (x, y).
template <typename T>
struct ProbeArgs {
  const T* M;
  long long n_p;
  int ncx, ncy;
};

// Node index of local dof l (x fastest, n1 per axis) of cell e on the
// uniform non-periodic 3D lattice of ncx x ncy x * cells (x fastest), whose
// dofs are numbered lexicographically, x fastest: ScalarSpace's numbering,
// so this equals LatticeOps.cell_dof_table()[e, l].
template <int N1>
__device__ __forceinline__ long long lattice_dof(long long e, int l, int ncx, int ncy) {
  constexpr int deg = N1 - 1;
  const long long cx = e % ncx, cy = (e / ncx) % ncy, cz = e / ((long long)ncx * ncy);
  const long long nx = (long long)deg * ncx + 1, ny = (long long)deg * ncy + 1;
  const int lx = l % N1, ly = (l / N1) % N1, lz = l / (N1 * N1);
  return ((deg * cz + lz) * ny + deg * cy + ly) * nx + deg * cx + lx;
}

// The cell owns local dof l (n1 per axis, x fastest) when no local
// coordinate is the cell's high face: each lattice node below the high
// boundary has one owner.
template <int DIM, int N1>
__device__ __forceinline__ bool owned(int l) {
  for (int a = 0; a < DIM; ++a, l /= N1)
    if (l % N1 == N1 - 1) return false;
  return true;
}

// The cell group of a schedule's block at its it-th iteration: strided by
// the persistent grid, or for kSchedPair pairs of consecutive groups.
template <int SCHED>
__device__ __forceinline__ long long sched_group(long long it) {
  if constexpr (SCHED == kSchedPair)
    return 2 * (blockIdx.x + (it >> 1) * gridDim.x) + (it & 1);
  else
    return blockIdx.x + it * gridDim.x;
}

// ---- the one-shot body: every production instance, K11, K12, K13's phase
//      masks, and K13's schedules through its split gather and compute -------

// Shared memory of a cell in the one-shot body: NS slots of NB values, each a
// tensor of extents <= M1 per axis at the positions (z M1 + y) M1 + x, every
// stage writing its lines over the lines it read. Item i (u_0 .., then u*_0
// .. unless the u* stream is q-fields, which is read at the q points) holds
// FI = DIM + 1 slots i FI + f: its dofs, then the fields of the evaluation
// stages (f = 0 no derivative, f = 1 + a the derivative along axis a); the
// pressure the slot PSLOT. The q-point stage writes component c's value and
// stress row over u item c's slots, the pressure row into QP. rowdma's
// staging slot of a cell holds the gathered dofs alone, SG values: the
// items' (u_0 .., u*_0 ..) at item stride NB, each at its lpos, then the
// pressure's NP, x fastest (lines_gather with STG).
template <int DIM, int N1, int Q1, int P1, bool PRES, bool QF>
struct Lines {
  static constexpr int kDim = DIM, kN1 = N1, kQ1 = Q1, kP1 = P1;
  static constexpr int M1 = imax(N1, Q1);
  static constexpr int NB = ipow(M1, DIM);
  static constexpr int NL = ipow(N1, DIM), NQ = ipow(Q1, DIM), NP = ipow(P1, DIM);
  static constexpr int FI = DIM + 1;              // slots per item
  static constexpr int NEV = QF ? DIM : 2 * DIM;  // items in shared memory
  static constexpr int PSLOT = NEV * FI;
  static constexpr int NS = PSLOT + (PRES ? 1 : 0);
  static constexpr int QP = QF ? PSLOT : DIM * FI;  // the pressure row
  // the cell stride: NS NB rounded up to NQ modulo 32, so that the q-point
  // threads of consecutive cells read consecutive banks
  static constexpr int CS = NS * NB + ((NQ - NS * NB) % 32 + 32) % 32;
  static constexpr int LDX = DIM * NL + (PRES ? NP : 0);
  static constexpr int SG = 2 * DIM * NB + NP;
};

// Cells per block of the one-shot body: as many as kCellBytes holds, at
// least one; kBlocksPerSM blocks of 128 threads fit on an SM (the H100's
// 228 KB of shared memory per SM, of which it reserves 1 KB per block).
constexpr int kCellBytes = 56 * 1024;
constexpr int kBlocksPerSM = 4;
constexpr int kSmemPerSM = 228 * 1024, kSmemReservedPerBlock = 1024;
template <typename L, typename T>
__host__ __device__ constexpr int cells_per_block() {
  const int c = kCellBytes / (L::CS * (int)sizeof(T));
  return c > 1 ? c : 1;
}

// The slot position of local index l of a tensor with extent N per axis.
template <int DIM, int N, int M1>
__device__ __forceinline__ int lpos(int l) {
  int at = 0, s = 1;
#pragma unroll
  for (int a = 0; a < DIM; ++a, s *= M1, l /= N) at += (l % N) * s;
  return at;
}

// The slot position of the first element of line L along axis A: the other
// axes' coordinates, the lowest fastest, axes below A of extent LO and above
// A of extent HI.
template <int DIM, int A, int LO, int HI, int M1>
__device__ __forceinline__ int line_at(int L) {
  int at = 0, s = 1;
#pragma unroll
  for (int b = 0; b < DIM; ++b, s *= M1) {
    if (b == A) continue;
    const int ext = b < A ? LO : HI;
    at += (L % ext) * s;
    L /= ext;
  }
  return at;
}

// a[i] for a small runtime i < N, read with compile-time indices
template <int N, typename T, int K>
__device__ __forceinline__ T pick(const T (&a)[K], int i) {
  T r = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (i == k) r = a[k];
  return r;
}

// Evaluation along axis A of the items [I0, I1) (and the pressure, PE): a
// thread takes one line of one item of a cell, loads its A + 1 fields (no
// derivative, the derivatives along the axes below A) at the N1 points of
// the line and writes back at the Q1 points V of each and D of the first.
// After the last axis an item's slots hold its value and reference
// gradients at the q points. STG (rowdma, stage x alone): the lines' inputs
// come from the cells' staging slots at stg (Lines::SG) in place of their
// gather slots; the outputs go to the work area all the same.
template <typename L, int A, int I0, int I1, bool PE, bool STG, typename T>
__device__ __forceinline__ void eval_stage(T* cells, int nc, const Tables<T>& tab,
                                           const T* stg) {
  constexpr int DIM = L::kDim, N1 = L::kN1, Q1 = L::kQ1, P1 = L::kP1;
  constexpr int M1 = L::M1, NB = L::NB, FI = L::FI;
  constexpr int ST = ipow(M1, A);
  constexpr int LN = ipow(Q1, A) * ipow(N1, DIM - 1 - A);
  constexpr int LP = PE ? ipow(Q1, A) * ipow(P1, DIM - 1 - A) : 0;
  constexpr int per = (I1 - I0) * LN + LP;
  static_assert(!STG || A == 0, "only stage x reads the staging slots");
  if constexpr (per > 0)
    for (int t = threadIdx.x; t < nc * per; t += blockDim.x) {
      T* cb = cells + (t / per) * L::CS;
      const int k = t % per;
      if (k < (I1 - I0) * LN) {
        T* f = cb + (I0 + k / LN) * FI * NB + line_at<DIM, A, Q1, N1, M1>(k % LN);
        T x[A + 1][N1];
        if constexpr (STG) {
          const T* in = stg + (t / per) * L::SG + (I0 + k / LN) * NB +
                        line_at<DIM, A, Q1, N1, M1>(k % LN);
#pragma unroll
          for (int s = 0; s < N1; ++s) x[0][s] = in[s];
        } else {
#pragma unroll
          for (int g = 0; g <= A; ++g)
#pragma unroll
            for (int s = 0; s < N1; ++s) x[g][s] = f[g * NB + s * ST];
        }
#pragma unroll
        for (int q = 0; q < Q1; ++q) {
          T d = T(0);
#pragma unroll
          for (int s = 0; s < N1; ++s) d += tab.D[q * N1 + s] * x[0][s];
#pragma unroll
          for (int g = 0; g <= A; ++g) {
            T v = T(0);
#pragma unroll
            for (int s = 0; s < N1; ++s) v += tab.V[q * N1 + s] * x[g][s];
            f[g * NB + q * ST] = v;
          }
          f[(A + 1) * NB + q * ST] = d;
        }
      } else {
        T* f = cb + L::PSLOT * NB + line_at<DIM, A, Q1, P1, M1>(k - (I1 - I0) * LN);
        T x[P1];
        if constexpr (STG) {
          // line L = y + P1 z of the compact pressure dofs
          const T* in = stg + (t / per) * L::SG + 2 * DIM * NB + (k - (I1 - I0) * LN) * P1;
#pragma unroll
          for (int s = 0; s < P1; ++s) x[s] = in[s];
        } else {
#pragma unroll
          for (int s = 0; s < P1; ++s) x[s] = f[s * ST];
        }
#pragma unroll
        for (int q = 0; q < Q1; ++q) {
          T v = T(0);
#pragma unroll
          for (int s = 0; s < P1; ++s) v += tab.Vp[q * P1 + s] * x[s];
          f[q * ST] = v;
        }
      }
    }
}

// Integration along axis A, transposed, the axes in the order x, y, z: a
// thread takes one line of one component of a cell, loads its DIM - A + 1
// fields (the integrand so far, then the stress entries along A, A + 1, ..)
// at the Q1 points of the line and writes back at the N1 points V^T f_0 +
// D^T f_1 and V^T of the others (each sum a V and a D term per point, in
// turn); the pressure row V^T. After the last axis the lines emit the
// outputs (emit_u, emit_p) in place of writing them back.
template <typename L, int A, bool PRES, typename T, typename EU, typename EP>
__device__ __forceinline__ void integ_stage(T* cells, int nc, long long c0,
                                            const Tables<T>& tab, EU emit_u, EP emit_p) {
  constexpr int DIM = L::kDim, N1 = L::kN1, Q1 = L::kQ1, P1 = L::kP1;
  constexpr int M1 = L::M1, NB = L::NB, FI = L::FI;
  constexpr bool LAST = A == DIM - 1;
  constexpr int NF = DIM - A + 1;
  constexpr int ST = ipow(M1, A);
  constexpr int LN = ipow(N1, A) * ipow(Q1, DIM - 1 - A);
  constexpr int LP = PRES ? ipow(P1, A) * ipow(Q1, DIM - 1 - A) : 0;
  constexpr int per = DIM * LN + LP;
  for (int t = threadIdx.x; t < nc * per; t += blockDim.x) {
    const int cell = t / per, k = t % per;
    T* cb = cells + cell * L::CS;
    if (k < DIM * LN) {
      const int c = k / LN, ln = k % LN;
      T* f = cb + c * FI * NB + line_at<DIM, A, N1, Q1, M1>(ln);
      T x[NF][Q1];
#pragma unroll
      for (int g = 0; g < NF; ++g)
#pragma unroll
        for (int q = 0; q < Q1; ++q) x[g][q] = f[g * NB + q * ST];
#pragma unroll
      for (int i = 0; i < N1; ++i) {
        T v = T(0);
#pragma unroll
        for (int q = 0; q < Q1; ++q) {
          v += tab.V[q * N1 + i] * x[0][q];
          v += tab.D[q * N1 + i] * x[1][q];
        }
        if constexpr (LAST) {
          emit_u(c0 + cell, c, ln + ipow(N1, DIM - 1) * i, v);
        } else {
          f[i * ST] = v;
#pragma unroll
          for (int g = 2; g < NF; ++g) {
            T w = T(0);
#pragma unroll
            for (int q = 0; q < Q1; ++q) w += tab.V[q * N1 + i] * x[g][q];
            f[(g - 1) * NB + i * ST] = w;
          }
        }
      }
    } else {
      const int ln = k - DIM * LN;
      T* f = cb + L::QP * NB + line_at<DIM, A, P1, Q1, M1>(ln);
      T x[Q1];
#pragma unroll
      for (int q = 0; q < Q1; ++q) x[q] = f[q * ST];
#pragma unroll
      for (int i = 0; i < P1; ++i) {
        T v = T(0);
#pragma unroll
        for (int q = 0; q < Q1; ++q) v += tab.Vp[q * P1 + i] * x[q];
        if constexpr (LAST) {
          emit_p(c0 + cell, ln + ipow(P1, DIM - 1) * i, v);
        } else {
          f[i * ST] = v;
        }
      }
    }
  }
}

// The one-shot body's gather of the cells [c0, c0 + nc) into the work area
// `cells` (cell stride CS, room for CPB cells), at the positions its compute
// reads (lines_compute): item i's dofs in its first slot (lpos), the
// pressure's in PSLOT, or a block row; the phase mask PH drops the gather as
// kPh* says. ASYNC (K13's unroll2 and rowdma; the table source): each value
// is one cp.async that the caller commits and waits for, a constrained entry
// zero-filled by a source size of 0. STG (rowdma, with ASYNC): `cells` is a
// staging slot of CPB cells in L's staging layout (Lines::SG) in place of a
// work area.
template <int DIM, int N1, int Q1, int P1, bool PRES, int SRC, int STREAM, typename T, int PH,
          int CPB, bool ASYNC = false, bool STG = false>
__device__ __forceinline__ void lines_gather(
    T* const cells, const long long c0, const int nc, const T* __restrict__ u,
    const T* __restrict__ p, const T* __restrict__ us, const int32_t* __restrict__ cell_u,
    const int32_t* __restrict__ cell_p, const uint8_t* __restrict__ mask_u,
    const uint8_t* __restrict__ mask_p, long long n_u, const ProbeArgs<T>& pa) {
  constexpr bool QF = STREAM == kStreamQFields;
  using L = Lines<DIM, N1, Q1, P1, PRES, QF>;
  constexpr int M1 = L::M1, NB = L::NB, NL = L::NL, NQ = L::NQ, NP = L::NP, FI = L::FI;
  constexpr int PSLOT = L::PSLOT, CS = L::CS, LDX = L::LDX;
  constexpr int NI = 2 * DIM;
  constexpr int SLD = QF ? DIM * FI * NQ : DIM * NL;  // stream row length
  constexpr bool LAT = SRC == kSrcLattice;
  constexpr bool GATHER = (PH & (kPhGather | kPhContig)) != 0;
  static_assert(!ASYNC || (SRC == kSrcTable && PH == kPhAll),
                "the asynchronous gather reads the cell tables");
  static_assert(!STG || ASYNC, "the staging slots are filled by cp.async");
  // a cell's stride and an item's in the destination, and where local
  // pressure dof l goes in a cell's
  constexpr int GS = STG ? L::SG : CS, IS = STG ? NB : FI * NB;
  auto ppos = [](int l) { return STG ? 2 * DIM * NB + l : PSLOT * NB + lpos<DIM, P1, M1>(l); };
  const int tid = threadIdx.x, nth = blockDim.x;

  // ---- gather into the items' first slots and the pressure slot ----------
  if constexpr (SRC == kSrcBlock) {
    // x row = [u_0 .. u_(DIM-1) | p], the u* dof stream [u*_0 ..] (a q-field
    // stream is read by the q-point stage)
    constexpr int per = LDX + (QF ? 0 : SLD);
    for (int t = tid; t < nc * per; t += nth) {
      const int cell = t / per, k = t % per;
      const long long e = c0 + cell;
      T* cb = cells + cell * CS;
      if (k < DIM * NL) {
        cb[(k / NL) * FI * NB + lpos<DIM, N1, M1>(k % NL)] = u[e * LDX + k];
      } else if (k < LDX) {
        cb[PSLOT * NB + lpos<DIM, P1, M1>(k - DIM * NL)] = u[e * LDX + k];
      } else {
        const int j = k - LDX;
        cb[(DIM + j / NL) * FI * NB + lpos<DIM, N1, M1>(j % NL)] = us[e * SLD + j];
      }
    }
  } else if constexpr (!GATHER) {
    // dropped gather: each item of a cell reads one value v, at the cell's
    // first dof, and spreads it as v (l + 1) over its local dofs l (a field
    // constant on each cell would leave the output at roundoff)
    for (int t = tid; t < nc * (NI + 1); t += nth) {
      const int cell = t / (NI + 1), item = t % (NI + 1);
      const long long e = c0 + cell;
      T* cb = cells + cell * CS;
      if (item < NI) {
        const long long dof = cell_u[e * NL];
        T v;
        if (item < DIM) {
          const long long g = item * n_u + dof;
          v = (mask_u != nullptr && mask_u[g]) ? T(0) : u[g];
        } else {
          v = us[(item - DIM) * n_u + dof];
        }
        for (int l = 0; l < NL; ++l) cb[item * FI * NB + lpos<DIM, N1, M1>(l)] = v * T(l + 1);
      } else {
        const long long dof = cell_p[e * NP];
        const T v = (mask_p != nullptr && mask_p[dof]) ? T(0) : p[dof];
        for (int l = 0; l < NP; ++l) cb[PSLOT * NB + lpos<DIM, P1, M1>(l)] = v * T(l + 1);
      }
    }
  } else {
    // nodal u (constrained entries read 0), u* (plain), p (masked) at the
    // cell tables' addresses, the lattice's (LAT) or contiguous ones
    // (kPhContig: cell e, local l reads entry (e n_loc + l) mod n);
    // consecutive threads take one local dof of consecutive cells of the
    // CPB, each thread every item of it
    constexpr bool CONTIG = (PH & kPhContig) != 0;
    constexpr int NW = NL + (PRES ? NP : 0);
    for (int t = tid; t < CPB * NW; t += nth) {
      const int cell = t % CPB, k = t / CPB;
      if (cell >= nc) continue;
      const long long e = c0 + cell;
      T* cb = cells + cell * GS;
      if (k < NL) {
        long long dof;
        if constexpr (LAT) {
          dof = lattice_dof<N1>(e, k, pa.ncx, pa.ncy);
        } else if constexpr (CONTIG) {
          dof = (e * NL + k) % n_u;
        } else {
          dof = cell_u[e * NL + k];
        }
        const int at = lpos<DIM, N1, M1>(k);
#pragma unroll
        for (int c = 0; c < DIM; ++c) {
          const long long g = c * n_u + dof;
          if constexpr (ASYNC) {
            async_copy(cb + c * IS + at, u + g, mask_u != nullptr && mask_u[g]);
            async_copy(cb + (DIM + c) * IS + at, us + g, false);
          } else {
            cb[c * FI * NB + at] = (mask_u != nullptr && mask_u[g]) ? T(0) : u[g];
            cb[(DIM + c) * FI * NB + at] = us[g];
          }
        }
      } else {
        const int l = k - NL;
        long long dof;
        if constexpr (LAT) {
          dof = lattice_dof<P1>(e, l, pa.ncx, pa.ncy);
        } else if constexpr (CONTIG) {
          dof = (e * NP + l) % pa.n_p;
        } else {
          dof = cell_p[e * NP + l];
        }
        if constexpr (ASYNC) {
          async_copy(cb + ppos(l), p + dof, mask_p != nullptr && mask_p[dof]);
        } else {
          cb[PSLOT * NB + lpos<DIM, P1, M1>(l)] =
              (mask_p != nullptr && mask_p[dof]) ? T(0) : p[dof];
        }
      }
    }
  }
}

// The one-shot body's compute of the cells [c0, c0 + nc), whose inputs
// lines_gather put into the work area `cells` (behind a barrier of the
// caller), with the matrix M89 of kPhMDot in sM: see the top for the stages;
// the phase mask PH drops phases as kPh* says. The last stage's lines emit
// the outputs and write nothing back, so the caller's barrier after it ends
// every read of the work area. The arithmetic of every output, the order of
// its sums included, is that of the staged body that the one-shot body
// replaced (each thread one output element of a 1D contraction, both operands
// from shared memory). STG (rowdma): stage x reads the gathered inputs from
// the staging slot `stg` (lines_gather with STG) in place of the work area's
// gather slots, which nothing then reads.
template <int DIM, int N1, int Q1, int P1, bool PRES, int SRC, int STREAM, int DST,
          typename T, int PH, bool STG = false>
__device__ __forceinline__ void lines_compute(
    T* const cells, const T* const sM, const long long c0, const int nc,
    const T* __restrict__ us, const int32_t* __restrict__ cell_u,
    const int32_t* __restrict__ cell_p, const T* __restrict__ rho, const T* __restrict__ mu,
    const T* __restrict__ damp, T* __restrict__ out_u, T* __restrict__ out_p, long long n_u,
    const Tables<T>& tab, const Scalars<T>& sc, const ProbeArgs<T>& pa,
    const T* const stg = nullptr) {
  constexpr bool QF = STREAM == kStreamQFields;
  using L = Lines<DIM, N1, Q1, P1, PRES, QF>;
  constexpr int M1 = L::M1, NB = L::NB, NL = L::NL, NQ = L::NQ, NP = L::NP, FI = L::FI;
  constexpr int PSLOT = L::PSLOT, QP = L::QP, CS = L::CS, LDX = L::LDX;
  constexpr int SLD = QF ? DIM * FI * NQ : DIM * NL;  // stream row length
  constexpr bool LAT = SRC == kSrcLattice;
  constexpr bool MDOT = (PH & kPhMDot) != 0;
  constexpr bool QPOINT = (PH & kPhQPoint) != 0;
  constexpr bool INTEG = (PH & kPhIntegrate) != 0;
  constexpr bool SCATTER = (PH & kPhScatter) != 0;
  // the evaluated items [I0, I1) and whether the pressure is evaluated
  constexpr int I0 = (PH & kPhEvalU) ? 0 : DIM;
  constexpr int I1 = (PH & kPhEvalUs) ? L::NEV : DIM;
  constexpr bool PE = PRES && (PH & kPhEvalU);
  static_assert(PH == kPhAll || (DIM == 3 && N1 == 3 && Q1 == 3 && P1 == 2 && PRES &&
                                 SRC == kSrcTable && !QF && DST == kOutScatter),
                "probe phases: 3D Q2/Q1 with pressure, nodal in and out only");
  static_assert(SRC == kSrcBlock || !QF, "the q-field stream is a block");
  static_assert(!LAT || (DIM == 3 && PRES), "the lattice source is 3D with pressure");
  static_assert(!STG || PH == kPhAll, "stage x evaluates every item");

  const int tid = threadIdx.x, nth = blockDim.x;

  // an output of cell e: velocity component c, local dof l; or pressure l
  auto emit_u = [&](long long e, int c, int l, T v) {
    if constexpr (DST == kOutBlock) {
      out_u[e * LDX + c * NL + l] = v;
    } else if constexpr (LAT) {
      atomicAdd(out_u + c * n_u + lattice_dof<N1>(e, l, pa.ncx, pa.ncy), v);
    } else if constexpr (SCATTER) {
      atomicAdd(out_u + c * n_u + cell_u[e * NL + l], v);
    } else {
      if (owned<DIM, N1>(l)) out_u[c * n_u + cell_u[e * NL + l]] = v;
    }
  };
  auto emit_p = [&](long long e, int l, T v) {
    if constexpr (DST == kOutBlock) {
      out_u[e * LDX + DIM * NL + l] = v;
    } else if constexpr (LAT) {
      atomicAdd(out_p + lattice_dof<P1>(e, l, pa.ncx, pa.ncy), v);
    } else if constexpr (SCATTER) {
      atomicAdd(out_p + cell_p[e * NP + l], v);
    } else {
      if (owned<DIM, P1>(l)) out_p[cell_p[e * NP + l]] = v;
    }
  };

  if constexpr (MDOT) {
    // ---- dense cell matrix: out = M89 x, x = [u_0 .. u_(DIM-1) | p] -------
    for (int t = tid; t < nc * LDX; t += nth) {
      const int cell = t / LDX, k = t % LDX;
      const T* cb = cells + cell * CS;
      T acc = T(0);
      for (int j = 0; j < DIM * NL; ++j)
        acc += sM[k * LDX + j] * cb[(j / NL) * FI * NB + lpos<DIM, N1, M1>(j % NL)];
      for (int j = 0; j < NP; ++j)
        acc += sM[k * LDX + DIM * NL + j] * cb[PSLOT * NB + lpos<DIM, P1, M1>(j)];
      if (k < DIM * NL) {
        emit_u(c0 + cell, k / NL, k % NL, acc);
      } else {
        emit_p(c0 + cell, k - DIM * NL, acc);
      }
    }
    return;
  }

  // ---- evaluation along x, y (, z); items not evaluated keep their dofs ----
  eval_stage<L, 0, I0, I1, PE, STG>(cells, nc, tab, stg);
  __syncthreads();
  eval_stage<L, 1, I0, I1, PE, false>(cells, nc, tab, stg);
  __syncthreads();
  if constexpr (DIM == 3) {
    eval_stage<L, 2, I0, I1, PE, false>(cells, nc, tab, stg);
    __syncthreads();
  }

  // ---- q-point terms (NavierStokesOperator._q_point_terms, "vmult"), one
  //      thread per (cell, q): component c's value_c and stress row st_cd
  //      (JxW and 1/h_d folded in) over u item c's slots, prow into QP (the
  //      q-field stream's u* gradients are physical already) ----------------
  for (int t = tid; t < nc * NQ; t += nth) {
    const int cell = t / NQ, q = t % NQ;
    const long long e = c0 + cell;
    T* const cb = cells + cell * CS;
    const int at = lpos<DIM, Q1, M1>(q);
    const int qx = q % Q1, qy = (q / Q1) % Q1, qz = q / (Q1 * Q1);
    // field f of item i at q: evaluated, its dof q (not evaluated; N1 ==
    // Q1), or the q-field stream's
    auto field = [&](int i, int f) -> T {
      if (QF && i >= DIM) return us[e * SLD + ((i - DIM) * FI + f) * NQ + q];
      return cb[(i * FI + (i >= I0 && i < I1 ? f : 0)) * NB + at];
    };
    T pq = T(0);
    if constexpr (PE) {
      pq = cb[PSLOT * NB + at];
    } else if constexpr (PRES) {
      // dropped evaluation: the pressure field holds its dofs (q mod NP)
      pq = cb[PSLOT * NB + lpos<DIM, P1, M1>(q % NP)];
    }
    T val[DIM], st[DIM][DIM], prow;
    if constexpr (QPOINT) {
      T jxw = pick<Q1>(tab.w, qx) * pick<Q1>(tab.w, qy) * tab.vol;
      if (DIM == 3) jxw *= pick<Q1>(tab.w, qz);
      T uv[DIM], sv[DIM], ug[DIM][DIM], sg[DIM][DIM];
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        uv[c] = field(c, 0);
        sv[c] = field(DIM + c, 0);
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          ug[c][d] = field(c, 1 + d) * tab.inv_h[d];
          sg[c][d] = field(DIM + c, 1 + d) * (QF ? T(1) : tab.inv_h[d]);
        }
      }
      T div = T(0), div_s = T(0);
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        div += ug[a][a];
        div_s += sg[a][a];
      }
      const bool variable = rho != nullptr || mu != nullptr || damp != nullptr;
      const long long qi = e * NQ + q;
      const T r_q = rho != nullptr ? rho[qi] : sc.rho0;
      const T m_q = mu != nullptr ? mu[qi] : sc.mu0;
      const T d_q = damp != nullptr ? damp[qi] : sc.damp0;
      const T tmu = sc.tau1 * m_q;
      // the diagonal's grad-div and pressure term, in one rounding (tgd div
      // alone without a pressure), fused into the viscous term: the
      // roundings of the body it replaced, as compiled
      const T diag = PRES ? fma_rn(sc.tgd, div, -pq) : mul_rn(sc.tgd, div);
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        T conv = sc.beta * (div * sv[c] + div_s * uv[c]);
#pragma unroll
        for (int d = 0; d < DIM; ++d) conv += sv[d] * ug[c][d] + uv[d] * sg[c][d];
        const T value = variable
            ? r_q * (sc.weight * uv[c] + sc.tau1 * conv) - d_q * uv[c]
            : (sc.rho0 * sc.weight - sc.damp0) * uv[c] + sc.tau1 * sc.rho0 * conv;
        val[c] = value * jxw;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const T sum = ug[c][d] + ug[d][c];
          const T s = c == d ? fma_rn(tmu, sum, diag) : tmu * sum;
          st[c][d] = s * jxw * tab.inv_h[d];
        }
      }
      prow = -div * jxw;
    } else {
      // dropped q-point terms: value_c = u_c, stress_cd = d_d u*_c (the
      // fields as they are), prow = p
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        val[c] = field(c, 0);
#pragma unroll
        for (int d = 0; d < DIM; ++d) st[c][d] = field(DIM + c, 1 + d);
      }
      prow = pq;
    }
    // over this point's own positions, read above by this thread alone
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      cb[c * FI * NB + at] = val[c];
#pragma unroll
      for (int d = 0; d < DIM; ++d) cb[(c * FI + 1 + d) * NB + at] = st[c][d];
    }
    if constexpr (PRES) cb[QP * NB + at] = prow;
  }
  __syncthreads();

  if constexpr (!INTEG) {
    // ---- dropped integration: out_c = value_c at q = l (NL = NQ), out_p =
    //      prow at q = l ----------------------------------------------------
    for (int t = tid; t < nc * LDX; t += nth) {
      const int cell = t / LDX, k = t % LDX;
      const T* cb = cells + cell * CS;
      if (k < DIM * NL) {
        emit_u(c0 + cell, k / NL, k % NL, cb[(k / NL) * FI * NB + lpos<DIM, Q1, M1>(k % NL)]);
      } else {
        emit_p(c0 + cell, k - DIM * NL, cb[QP * NB + lpos<DIM, Q1, M1>(k - DIM * NL)]);
      }
    }
    return;
  }

  // ---- integration along x, y (, z), the last axis' lines emitting the
  //      outputs ---------------------------------------------------------------
  integ_stage<L, 0, PRES>(cells, nc, c0, tab, emit_u, emit_p);
  __syncthreads();
  integ_stage<L, 1, PRES>(cells, nc, c0, tab, emit_u, emit_p);
  if constexpr (DIM == 3) {
    __syncthreads();
    integ_stage<L, 2, PRES>(cells, nc, c0, tab, emit_u, emit_p);
  }
}

// The one-shot body (kSchedOnce): the group of cells blockIdx.x of CPB cells
// (the last one may be shorter) in `cells`, gathered, then computed.
template <int DIM, int N1, int Q1, int P1, bool PRES, int SRC, int STREAM, int DST,
          typename T, int PH>
__device__ __forceinline__ void cell_lines(
    T* const cells, const T* const sM, const T* __restrict__ u, const T* __restrict__ p,
    const T* __restrict__ us, const int32_t* __restrict__ cell_u,
    const int32_t* __restrict__ cell_p, const uint8_t* __restrict__ mask_u,
    const uint8_t* __restrict__ mask_p, const T* __restrict__ rho, const T* __restrict__ mu,
    const T* __restrict__ damp, T* __restrict__ out_u, T* __restrict__ out_p, long long n_u,
    long long n_cells, const Tables<T>& tab, const Scalars<T>& sc, const ProbeArgs<T>& pa) {
  constexpr int CPB = cells_per_block<Lines<DIM, N1, Q1, P1, PRES, STREAM == kStreamQFields>, T>();
  const long long c0 = (long long)blockIdx.x * CPB;
  const int nc = (int)min((long long)CPB, n_cells - c0);
  lines_gather<DIM, N1, Q1, P1, PRES, SRC, STREAM, T, PH, CPB>(cells, c0, nc, u, p, us, cell_u,
                                                                cell_p, mask_u, mask_p, n_u, pa);
  __syncthreads();
  lines_compute<DIM, N1, Q1, P1, PRES, SRC, STREAM, DST, T, PH>(
      cells, sM, c0, nc, us, cell_u, cell_p, rho, mu, damp, out_u, out_p, n_u, tab, sc, pa);
}

// ---- K13's pipe and unroll2 on the one-shot body (3D Q2/Q1 with pressure,
//      table source, u* dofs, constant coefficients, atomic scatter) -------

using ProbeLines = Lines<3, 3, 3, 2, true, false>;

// ---- kSchedPipe's slab. A group's cells (consecutive, x fastest) fall into
//      segments, one per x-row of the lattice that the group touches (a group
//      straddles a row end when ncx is not a multiple of CPB). A segment of n
//      cells reads kPipeRuns x-runs of the lattice: for each of the 6 vectors
//      u_0 .. u*_2 and each (ly, lz) in 3 x 3 the 2 n + 1 velocity dofs, then
//      for each (ly, lz) in 2 x 2 the n + 1 pressure dofs. Each run lands in a
//      slot of the 16-byte aligned size of the longest run, as the 16-byte
//      aligned superset of its bytes (the bulk copy's rule; the superset stays
//      in the 16-byte lines of the vector, so inside its allocation). The
//      threads that start the copies note each run's place and first dof,
//      and each cell's segment, in small tables beside the slab, so that the
//      assembly does no lattice arithmetic. Cell and dof indices fit in 32
//      bits, as the int32 cell tables require. ---------------------------------
constexpr int kPipeVecRuns = 6 * 9, kPipeRuns = kPipeVecRuns + 4;

struct PipeGeom {
  int cap_u, cap_p, seg_bytes;  // slot bytes of a velocity / pressure run; per segment
};

struct PipeRun {
  int lead, dof0;  // its first element's place in its slot; its first dof
};

struct PipeCell {
  int seg, xi;  // a cell's segment, and its place in the segment
};

__host__ __device__ constexpr PipeGeom pipe_geom(int cpb, int sz) {
  const int cap_u = (15 + (2 * cpb + 1) * sz + 15) / 16 * 16;
  const int cap_p = (15 + (cpb + 1) * sz + 15) / 16 * 16;
  return PipeGeom{cap_u, cap_p, kPipeVecRuns * cap_u + (kPipeRuns - kPipeVecRuns) * cap_p};
}

// the most segments a group of cpb consecutive cells can have
__host__ __device__ constexpr int pipe_max_segments(int cpb, int ncx) {
  return (cpb + ncx - 2) / ncx + 1 < cpb ? (cpb + ncx - 2) / ncx + 1 : cpb;
}

// bytes of the slab of nseg segments, then of its mbarrier and its tables
// (16-byte multiples)
__host__ __device__ constexpr int pipe_slab_bytes(int cpb, int nseg, int sz) {
  return nseg * pipe_geom(cpb, sz).seg_bytes;
}
__host__ __device__ constexpr int pipe_table_bytes(int cpb, int nseg) {
  return (8 + nseg * kPipeRuns * (int)sizeof(PipeRun) + cpb * (int)sizeof(PipeCell) + 15) /
         16 * 16;
}

__device__ __forceinline__ int pipe_slot(const PipeGeom& g, int s, int j) {
  return s * g.seg_bytes +
         (j < kPipeVecRuns ? j * g.cap_u : kPipeVecRuns * g.cap_u + (j - kPipeVecRuns) * g.cap_p);
}

// Start the bulk copies of the group [c0, c0 + nc) into the slab and fill
// the tables; every thread arrives on `bar` (whose count is the block's
// threads) with the bytes of its copies.
template <typename T>
__device__ __forceinline__ void pipe_start(unsigned char* slab, uint64_t* bar, PipeRun* runs,
                                           PipeCell* cells, long long c0l, int nc, int cpb,
                                           const T* u, const T* p, const T* us, long long n_u,
                                           int ncx, int ncy) {
  const PipeGeom pg = pipe_geom(cpb, sizeof(T));
  const int c0 = (int)c0l, row_end = (c0 / ncx + 1) * ncx;  // first cell of the next x-row
  const int rest = c0 + nc - row_end;                         // cells past it
  const int nr = (rest <= 0 ? 1 : 1 + (rest + ncx - 1) / ncx) * kPipeRuns;
  const int nx = 2 * ncx + 1, ny = 2 * ncy + 1;
  unsigned bytes = 0;
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const int s = r / kPipeRuns, j = r % kPipeRuns;
    const int first = s == 0 ? c0 : row_end + (s - 1) * ncx;
    const int last = min(s == 0 ? row_end : first + ncx, c0 + nc);
    const int cx = first % ncx, cy = (first / ncx) % ncy, cz = first / (ncx * ncy);
    int dof0, len;
    const T* v;
    if (j < kPipeVecRuns) {
      const int f = j / 9, ly = j % 3, lz = (j / 3) % 3;
      dof0 = ((2 * cz + lz) * ny + 2 * cy + ly) * nx + 2 * cx;
      len = 2 * (last - first) + 1;
      v = f < 3 ? u + f * n_u : us + (f - 3) * n_u;
    } else {
      const int q = j - kPipeVecRuns, ly = q % 2, lz = q / 2;
      dof0 = ((cz + lz) * (ncy + 1) + cy + ly) * (ncx + 1) + cx;
      len = last - first + 1;
      v = p;
    }
    const uintptr_t a = (uintptr_t)(v + dof0);
    const uintptr_t a0 = a & ~(uintptr_t)15, a1 = (a + len * sizeof(T) + 15) & ~(uintptr_t)15;
    runs[r] = PipeRun{(int)((a - a0) / sizeof(T)), dof0};
    bulk_copy(slab + pipe_slot(pg, s, j), (const void*)a0, (unsigned)(a1 - a0), bar);
    bytes += (unsigned)(a1 - a0);
  }
  for (int cell = threadIdx.x; cell < nc; cell += blockDim.x) {
    const int e = c0 + cell, s = e < row_end ? 0 : 1 + (e - row_end) / ncx;
    cells[cell] = PipeCell{s, e - (s == 0 ? c0 : row_end + (s - 1) * ncx)};
  }
  bar_arrive_expect(bar, bytes);
}

// Assemble the group's nc cells from the slab (the tables filled by its
// pipe_start) straight into the gather slots of the one-shot body's work
// area `cells` (L's layout, as lines_gather writes them: item i's dofs in
// its first slot at lpos, the pressure's in PSLOT): constrained entries of u
// and p read as zero.
template <typename L, typename T>
__device__ __forceinline__ void pipe_assemble(T* cells, const unsigned char* slab,
                                              const PipeRun* runs, const PipeCell* pcells,
                                              int nc, int cpb, const uint8_t* mask_u,
                                              const uint8_t* mask_p, long long n_u) {
  constexpr int NL = 27, NP = 8, NI = 6, per = NI * NL + NP;
  constexpr int M1 = L::M1, NB = L::NB, FI = L::FI;
  static_assert(L::kDim == 3 && L::kN1 == 3 && L::kP1 == 2 && L::NL == NL && L::NP == NP,
                "the pipe's runs are 3D Q2/Q1's");
  const PipeGeom pg = pipe_geom(cpb, sizeof(T));
  for (int t = threadIdx.x; t < nc * per; t += blockDim.x) {
    const int cell = t / per, k = t % per;
    const PipeCell pc = pcells[cell];
    int j, x, at;
    const uint8_t* m;
    long long mi;
    if (k < NI * NL) {
      const int item = k / NL, l = k % NL;
      j = item * 9 + (l / 9) * 3 + (l / 3) % 3;
      x = 2 * pc.xi + l % 3;
      at = item * FI * NB + lpos<3, 3, M1>(l);
      m = item < 3 ? mask_u : nullptr;
      mi = item * n_u;
    } else {
      const int l = k - NI * NL;
      j = kPipeVecRuns + (l / 4) * 2 + (l / 2) % 2;
      x = pc.xi + l % 2;
      at = L::PSLOT * NB + lpos<3, 2, M1>(l);
      m = mask_p;
      mi = 0;
    }
    const PipeRun rr = runs[pc.seg * kPipeRuns + j];
    const T* run = reinterpret_cast<const T*>(slab + pipe_slot(pg, pc.seg, j));
    cells[cell * L::CS + at] = (m != nullptr && m[mi + rr.dof0 + x]) ? T(0) : run[rr.lead + x];
  }
}

// The shared memory of a schedule's block at cpb cells per group: one work
// area of cpb cells (16-byte aligned at its end), then the pipe's slab of
// nseg segments with its mbarrier and tables, or rowdma's two staging slots
// of cpb cells (Lines::SG values each); or unroll2's two work areas.
template <typename T>
__host__ __device__ constexpr int sched_lines_bytes(int sched, int cpb, int nseg) {
  const int area = (cpb * ProbeLines::CS * (int)sizeof(T) + 15) / 16 * 16;
  if (sched == kSchedPair) return 2 * area;
  if (sched == kSchedRowAsync) return area + 2 * cpb * ProbeLines::SG * (int)sizeof(T);
  return area + pipe_slab_bytes(cpb, nseg, sizeof(T)) + pipe_table_bytes(cpb, nseg);
}

// The cells per group of a schedule: the most (up to the one-shot body's
// CPB) at which kBlocksPerSM blocks fit the SM's shared memory, the 1 KB
// that the card reserves per block included, as the one-shot body's blocks
// do; the pipe's slab at two segments (a lattice of at least CPB - 1 cells
// along x).
template <int SCHED, typename T>
__host__ __device__ constexpr int sched_cpb() {
  int best = 1;
  for (int c = 1; c <= cells_per_block<ProbeLines, T>(); ++c)
    if (kBlocksPerSM * (sched_lines_bytes<T>(SCHED, c, 2) + kSmemReservedPerBlock) <=
        kSmemPerSM)
      best = c;
  return best;
}

// K13's schedules: the cell groups of this block (sched_group), each
// gathered into shared memory (unroll2 and rowdma: lines_gather's cp.async;
// pipe: bulk copies assembled by pipe_assemble) and computed by
// lines_compute in a work area of the one-shot body, the next group's copies
// in flight meanwhile (see the top). The compute works in place over the
// work area's gather slots, so a copy into the work area that computes, or
// the pipe's assembly before the barrier that ends the integration, would
// race with it.
template <typename T, int SCHED>
__device__ __forceinline__ void cell_sched(
    unsigned char* smem_raw, const T* __restrict__ u, const T* __restrict__ p,
    const T* __restrict__ us, const int32_t* __restrict__ cell_u,
    const int32_t* __restrict__ cell_p, const uint8_t* __restrict__ mask_u,
    const uint8_t* __restrict__ mask_p, T* __restrict__ out_u, T* __restrict__ out_p,
    long long n_u, long long n_cells, const Tables<T>& tab, const Scalars<T>& sc,
    const ProbeArgs<T>& pa) {
  constexpr int CPB = sched_cpb<SCHED, T>();
  constexpr int AREA = sched_lines_bytes<T>(kSchedPair, CPB, 0) / 2;  // bytes of a work area
  T* const work0 = reinterpret_cast<T*>(smem_raw);
  const long long n_groups = (n_cells + CPB - 1) / CPB;
  auto group_cells = [&](long long gi) { return (int)min((long long)CPB, n_cells - gi * CPB); };
  auto compute = [&](T* area, long long gi) {
    lines_compute<3, 3, 3, 2, true, kSrcTable, kStreamDofs, kOutScatter, T, kPhAll>(
        area, nullptr, gi * CPB, group_cells(gi), us, cell_u, cell_p, nullptr, nullptr, nullptr,
        out_u, out_p, n_u, tab, sc, pa);
  };
  long long g = sched_group<SCHED>(0);

  if constexpr (SCHED == kSchedPair) {
    // iteration it computes in work area it & 1 and gathers the block's next
    // group into the other, which the last iteration computed in
    T* const work1 = reinterpret_cast<T*>(smem_raw + AREA);
    auto gather = [&](T* area, long long gi) {
      lines_gather<3, 3, 3, 2, true, kSrcTable, kStreamDofs, T, kPhAll, CPB, true>(
          area, gi * CPB, group_cells(gi), u, p, us, cell_u, cell_p, mask_u, mask_p, n_u, pa);
    };
    if (g < n_groups) gather(work0, g);
    async_commit();
    for (long long it = 0; g < n_groups; ++it) {
      const long long gn = sched_group<SCHED>(it + 1);  // the block's next group
      if (gn < n_groups) {
        gather((it & 1) ? work0 : work1, gn);
        async_commit();
        async_wait<1>();
      } else {
        async_wait<0>();
      }
      __syncthreads();  // this group's copies landed, every thread's
      compute((it & 1) ? work1 : work0, g);
      __syncthreads();  // its last reads, before the next gather into its area
      g = gn;
    }
  } else if constexpr (SCHED == kSchedRowAsync) {
    // iteration it computes in the one work area from staging slot it & 1
    // and gathers the block's next group into the other slot. Only stage x
    // reads a staging slot, and lines_compute ends stage x with a barrier,
    // so every thread that issues iteration it's copies into slot
    // (it + 1) & 1 has passed the barrier after iteration it - 1's stage x,
    // the slot's last reads; the barrier after this iteration's wait ends
    // the last iteration's reads of the work area (its integration) before
    // this one's stage x writes it.
    constexpr int SLOT = CPB * ProbeLines::SG;  // values of a staging slot
    T* const stg = reinterpret_cast<T*>(smem_raw + AREA);
    auto gather = [&](int slot, long long gi) {
      lines_gather<3, 3, 3, 2, true, kSrcTable, kStreamDofs, T, kPhAll, CPB, true, true>(
          stg + slot * SLOT, gi * CPB, group_cells(gi), u, p, us, cell_u, cell_p, mask_u, mask_p,
          n_u, pa);
    };
    if (g < n_groups) gather(0, g);
    async_commit();
    for (long long it = 0; g < n_groups; ++it) {
      const long long gn = sched_group<SCHED>(it + 1);  // the block's next group
      if (gn < n_groups) {
        gather((int)((it + 1) & 1), gn);
        async_commit();
        async_wait<1>();
      } else {
        async_wait<0>();
      }
      __syncthreads();  // this group's copies landed, every thread's
      lines_compute<3, 3, 3, 2, true, kSrcTable, kStreamDofs, kOutScatter, T, kPhAll, true>(
          work0, nullptr, g * CPB, group_cells(g), us, cell_u, cell_p, nullptr, nullptr, nullptr,
          out_u, out_p, n_u, tab, sc, pa, stg + (it & 1) * SLOT);
      g = gn;
    }
  } else {
    // the slab after the work area, then its mbarrier and tables
    const int nseg = pipe_max_segments(CPB, pa.ncx);
    unsigned char* const slab = smem_raw + AREA;
    unsigned char* const ptab = slab + pipe_slab_bytes(CPB, nseg, sizeof(T));
    uint64_t* const bar = reinterpret_cast<uint64_t*>(ptab);
    PipeRun* const pruns = reinterpret_cast<PipeRun*>(ptab + 8);
    PipeCell* const pcells = reinterpret_cast<PipeCell*>(pruns + nseg * kPipeRuns);
    auto start = [&](long long gi) {
      pipe_start(slab, bar, pruns, pcells, gi * CPB, group_cells(gi), CPB, u, p, us, n_u, pa.ncx,
                 pa.ncy);
    };
    auto assemble = [&](long long gi) {
      pipe_assemble<ProbeLines>(work0, slab, pruns, pcells, group_cells(gi), CPB, mask_u, mask_p,
                                n_u);
    };
    if (threadIdx.x == 0) bar_init(bar, blockDim.x);
    __syncthreads();
    if (g < n_groups) {
      start(g);
      __syncthreads();  // the tables
      bar_wait(bar, 0);
      assemble(g);
    }
    __syncthreads();
    for (long long it = 0; g < n_groups; ++it) {
      const long long gn = sched_group<SCHED>(it + 1);  // the block's next group
      const bool more = gn < n_groups;
      if (more) start(gn);  // the slab and tables: the last assembly is behind a barrier
      compute(work0, g);
      __syncthreads();  // the integration's last reads of the work area
      if (more) {
        bar_wait(bar, (unsigned)((it + 1) & 1));
        assemble(gn);
      }
      __syncthreads();
      g = gn;
    }
  }
}

// PRES: the pressure input and the pressure rows; the velocity-only entry
// (no pressure) skips the pressure evaluation and integration stages.
// SRC, STREAM, DST: gather source, u* stream and output (see the top). With
// SRC == kSrcBlock, u is the (E, LDX) cell block x and us the cell-major
// stream (E, SLD); p, the cell tables and the masks are not read. With
// DST == kOutBlock, out_u is the (E, LDX) output block and out_p is not used.
// SRC == kSrcLattice (K11) reads like kSrcTable, with each dof's address
// computed from the cell's lattice coordinates (lattice_dof) in place of the
// tables. PH: the phases run (kPhAll for every production entry). SCHED: the
// schedule of the gather against the compute: kSchedOnce (every production
// entry, K11, K12, K13's phase masks) runs the one-shot body cell_lines with
// its compile-time CPB cells per block, K13's rowdma, pipe and unroll2 its
// stages on a persistent grid (cell_sched, CPB sched_cpb). The shared memory
// of every instance holds kBlocksPerSM blocks per SM, so ptxas keeps the
// registers to the 128 per thread at which they fit.
template <int DIM, int N1, int Q1, int P1, bool PRES, int SRC, int STREAM,
          int DST, typename T, int PH = kPhAll, int SCHED = kSchedOnce>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
coupled_cell_kernel(const T* __restrict__ u, const T* __restrict__ p,
                    const T* __restrict__ us, const int32_t* __restrict__ cell_u,
                    const int32_t* __restrict__ cell_p,
                    const uint8_t* __restrict__ mask_u,
                    const uint8_t* __restrict__ mask_p,
                    const T* __restrict__ rho, const T* __restrict__ mu,
                    const T* __restrict__ damp, T* __restrict__ out_u,
                    T* __restrict__ out_p, long long n_u, long long n_cells,
                    Tables<T> tab, Scalars<T> sc, ProbeArgs<T> pa) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (SCHED == kSchedOnce) {
    // shared memory: M89 (kPhMDot, (LDX, LDX) row-major), then the cells
    constexpr int LDX = Lines<DIM, N1, Q1, P1, PRES, STREAM == kStreamQFields>::LDX;
    constexpr bool MDOT = (PH & kPhMDot) != 0;
    T* const sM = reinterpret_cast<T*>(smem_raw);
    if constexpr (MDOT) {
      for (int i = threadIdx.x; i < LDX * LDX; i += blockDim.x) sM[i] = pa.M[i];
    }
    cell_lines<DIM, N1, Q1, P1, PRES, SRC, STREAM, DST, T, PH>(
        sM + (MDOT ? LDX * LDX : 0), sM, u, p, us, cell_u, cell_p, mask_u, mask_p, rho, mu,
        damp, out_u, out_p, n_u, n_cells, tab, sc, pa);
  } else {
    static_assert(PH == kPhAll && DIM == 3 && N1 == 3 && Q1 == 3 && P1 == 2 && PRES &&
                      SRC == kSrcTable && STREAM == kStreamDofs && DST == kOutScatter,
                  "schedules: 3D Q2/Q1 with pressure, nodal in and out only");
    cell_sched<T, SCHED>(smem_raw, u, p, us, cell_u, cell_p, mask_u, mask_p, out_u, out_p, n_u,
                         n_cells, tab, sc, pa);
  }
}

// K6: the cell-block scatter as the TPU's resident accumulator. It replaces
// scripts/probe_pr.py scatter_ring_kernel, whose grid steps add (89, B)
// blocks by static shifted row slices into one (32, win) parity accumulator
// that stays in VMEM across the grid: no cell table, no atomics. Here the
// accumulator is a tile of the lattice in shared memory: a thread block owns
// a brick of kScatterTX x kScatterTY x kScatterTZ cells (8 x 4 x 4, x
// fastest; partial at the high end of an axis that the tile does not
// divide), sums its cells' 89 entries into shared copies of the brick's Q2
// nodes (3 components) and Q1 nodes, and then adds each node into the
// nodal output once. The addresses come from the cell's lattice coordinates
// (node deg c + l of cell c on axis a, node deg nc of a periodic axis
// wrapping to 0, ops/lattice.py), so no cell table is read.
//
// Adds inside the tile: eight parity passes with a barrier between them.
// Cells whose coordinates agree mod 2 share no node, so the 16 cells of a
// pass write 16 x 89 distinct slots with plain adds, in a fixed order (the
// in-tile sums do not change from run to run), and nothing waits on a
// shared-memory atomic (a float add there is a compare-and-swap loop; with
// them and no barriers the kernel ran slower, PERF.md). A pass has
// 384 threads, one per entry (89, padded to 96) of its 4 cells along x,
// consecutive threads on consecutive entries of a cell's contiguous row;
// each thread adds its entry of the pass's 2 x 2 cells along y and z, so
// its entry's slot (a table of 96 ints in shared memory, built per block)
// and x offsets are worked out once a pass. The next pass's values are
// loaded into registers before this pass's are added, so the loads run
// across the barrier.
//
// Writing out: a node that only this tile's cells touch gets one plain
// read-add-write of out, read at the start (cp.async straight into its
// accumulator slot, in flight with the first pass's loads) and written at
// the end; a node on a face that another tile shares, or that a periodic
// axis wraps (onto another tile or this one), starts at zero and is added
// with one global atomicAdd. So the end of a tile waits on no load. At a
// full 8 x 4 x 4 tile with neighbours on every side that is 1,926 velocity
// and 162 pressure atomics per 128 cells (16 a cell, against 89 for an
// atomic per block entry). The node's address and kind, found at the start,
// wait in shared memory (one int32 a node) for the end. One block per
// tile: at the probes' 48^3 box the 864 tiles take the card's resident
// blocks (4 of 384 threads an SM, 40 registers) less than twice, and a
// persistent pencil walk that carried the shared face plane from tile to
// tile (the TPU's win overlap) would leave SMs idle there.
//
// Bound: bytes. The block is read once, the nodal output read and written
// once: at 48^3 in float64 124.4 MB, 0.0371 ms at 3.35 TB/s
// (scripts.scatter_bound); one add per block entry is far below any peak.
// What holds the kernel above it is each tile's fixed work, not its bytes:
// float32 takes nearly as long as float64, and the ablations of
// scripts/scatter_variants.py time the start and the write-out alone, and
// the passes without their loads, at most of the kernel (PERF.md).
constexpr int kScatterTX = 8, kScatterTY = 4, kScatterTZ = 4;
constexpr int kScatterPad = 96;  // a cell's 89 entries padded to 3 x 32
// A parity pass: one thread per entry (padded) of the pass's kScatterTX / 2
// cells along x, each thread taking its entry of the pass's cells along y
// and z in turn (kScatterPer of them), so its entry, its slot table entry
// and its x are the same for every cell it takes.
constexpr int kScatterThreads = kScatterTX / 2 * kScatterPad;
constexpr int kScatterPer = (kScatterTY / 2) * (kScatterTZ / 2);

// The node box of a tile of degree DEG (x fastest).
template <int DEG>
struct TileNodes {
  static constexpr int X = DEG * kScatterTX + 1, Y = DEG * kScatterTY + 1,
                       Z = DEG * kScatterTZ + 1, N = X * Y * Z;
};

// The tile's shared memory: the accumulator [u_0 | u_1 | u_2] on the Q2
// node box and p on the Q1 node box, each node's destination (int32: node
// + 1 for a plain write, -(node + 1) for an atomic, 0 outside the tile),
// then the slot table of a cell's entries.
template <typename T>
struct ScatterTile {
  using U = TileNodes<2>;
  using P = TileNodes<1>;
  static constexpr int VALUES = 3 * U::N + P::N;
  static constexpr int SMEM = VALUES * ((int)sizeof(T) + (int)sizeof(int)) +
                              kScatterPad * (int)sizeof(int);
};

// The lattice of a K6 launch: cells, Q2 and Q1 nodes and tiles per axis,
// and the periodic axes (bit a: axis a wraps).
struct ScatterLattice {
  int nc[3], nu[3], np[3], tiles[3];
  int periodic;
};

// The tile slot of entry k (0..88: [u_0 .. u_2 | p], local dofs x fastest)
// of the tile's cell (0, 0, 0); -1 for the padding.
__device__ __forceinline__ int scatter_slot(int k) {
  using U = TileNodes<2>;
  using P = TileNodes<1>;
  if (k < 81) {
    const int c = k / 27, l = k - 27 * c;
    const int lz = l / 9, ly = (l - 9 * lz) / 3, lx = l - 9 * lz - 3 * ly;
    return c * U::N + (lz * U::Y + ly) * U::X + lx;
  }
  if (k < 89) {
    const int l = k - 81;
    return 3 * U::N + ((l >> 2) * P::Y + ((l >> 1) & 1)) * P::X + (l & 1);
  }
  return -1;
}

// Node m of the tile's degree-DEG box (x fastest): its index in its nodal
// vector (dof numbering x fastest, node DEG nc of a periodic axis wrapped to
// 0), whether the tile's cells reach it, and whether another tile's box, or
// a wrap of this one, holds it too.
template <int DEG>
__device__ __forceinline__ int scatter_node(int m, const ScatterLattice& lat, const int* c0,
                                            const int* n, bool* inside, bool* shared) {
  using B = TileNodes<DEG>;
  const int g[3] = {m % B::X, (m / B::X) % B::Y, m / (B::X * B::Y)};
  int addr = 0;
  *inside = true;
  *shared = false;
#pragma unroll
  for (int a = 2; a >= 0; --a) {
    const bool wraps = (lat.periodic >> a) & 1;
    const int nodes = DEG == 2 ? lat.nu[a] : lat.np[a];
    *inside = *inside && g[a] <= DEG * n[a];
    *shared = *shared || (g[a] == 0 && (c0[a] > 0 || wraps)) ||
              (g[a] == DEG * n[a] && (c0[a] + n[a] < lat.nc[a] || wraps));
    int ga = DEG * c0[a] + g[a];
    if (ga >= nodes) ga -= nodes;
    addr = addr * nodes + ga;
  }
  return addr;
}

// The work of thread unit u (entry k of the pass's u / kScatterPad-th cell
// along x; none for u >= kScatterThreads) in parity pass par: the values of
// its kScatterPer cells along y and z, loaded into v, and their slots in the
// tile into sl (-1: padding, or a cell outside the tile). e0: the tile's
// first cell.
template <typename T>
__device__ __forceinline__ void scatter_load(const T* __restrict__ block, const int* rel,
                                             const ScatterLattice& lat, long long e0,
                                             const int* n, int par, int u, T* v, int* sl) {
  using U = TileNodes<2>;
  using P = TileNodes<1>;
  const int a = u / kScatterPad, k = u - a * kScatterPad;
  const int r = u < kScatterThreads ? rel[k] : -1;
  const bool vel = k < 81;
  const int cx = (par & 1) + 2 * a, py = (par >> 1) & 1, pz = par >> 2;
  const int sx = r + (vel ? 2 * cx : cx);
#pragma unroll
  for (int q = 0; q < kScatterPer; ++q) {
    const int cy = py + 2 * (q % (kScatterTY / 2)), cz = pz + 2 * (q / (kScatterTY / 2));
    v[q] = T(0);
    sl[q] = -1;
    if (r >= 0 && cx < n[0] && cy < n[1] && cz < n[2]) {
      const long long e = e0 + (cz * lat.nc[1] + cy) * lat.nc[0] + cx;
      v[q] = block[e * 89 + k];
      sl[q] = sx + (vel ? (2 * cz * U::Y + 2 * cy) * U::X : (cz * P::Y + cy) * P::X);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kScatterThreads, 4)
scatter_tiles_kernel(const T* __restrict__ block, T* __restrict__ out_u, T* __restrict__ out_p,
                     long long n_u, ScatterLattice lat) {
  using S = ScatterTile<T>;
  using U = TileNodes<2>;
  using P = TileNodes<1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const acc = reinterpret_cast<T*>(smem_raw);
  int* const dst = reinterpret_cast<int*>(acc + S::VALUES);
  int* const rel = dst + S::VALUES;
  const int b = blockIdx.x;
  const int t0[3] = {b % lat.tiles[0], (b / lat.tiles[0]) % lat.tiles[1],
                     b / (lat.tiles[0] * lat.tiles[1])};
  const int c0[3] = {t0[0] * kScatterTX, t0[1] * kScatterTY, t0[2] * kScatterTZ};
  const int n[3] = {min(kScatterTX, lat.nc[0] - c0[0]), min(kScatterTY, lat.nc[1] - c0[1]),
                    min(kScatterTZ, lat.nc[2] - c0[2])};
  for (int k = threadIdx.x; k < kScatterPad; k += blockDim.x) rel[k] = scatter_slot(k);
  __syncthreads();

  // the passes as a sequence of batches of thread units (one batch a pass on
  // the card), the next batch loaded before this one is added; a barrier
  // after a pass's last batch. The first batch's loads go out before the
  // accumulator's.
  const long long e0 = ((long long)c0[2] * lat.nc[1] + c0[1]) * lat.nc[0] + c0[0];
  const int per_pass = (kScatterThreads + blockDim.x - 1) / blockDim.x;
  T v[kScatterPer], w[kScatterPer];
  int sv[kScatterPer], sw[kScatterPer];
  scatter_load(block, rel, lat, e0, n, 0, threadIdx.x, v, sv);

  // each node's destination, and its accumulator's start: the old value of
  // a node of this tile alone, zero for one that tiles share
  for (int i = threadIdx.x; i < S::VALUES; i += blockDim.x) {
    bool inside, shared;
    const int c = i / U::N;
    const int node = i < 3 * U::N ? scatter_node<2>(i - c * U::N, lat, c0, n, &inside, &shared)
                                  : scatter_node<1>(i - 3 * U::N, lat, c0, n, &inside, &shared);
    const bool plain = inside && !shared;
    dst[i] = inside ? (shared ? -(node + 1) : node + 1) : 0;
    const T* src = (i < 3 * U::N ? out_u + c * n_u : out_p) + (plain ? node : 0);
    async_copy(acc + i, src, !plain);
  }
  async_commit();
  async_wait<0>();
  __syncthreads();

  for (int s = 0; s < 8 * per_pass; ++s) {
    if (s + 1 < 8 * per_pass)
      scatter_load(block, rel, lat, e0, n, (s + 1) / per_pass,
                   (s + 1) % per_pass * blockDim.x + threadIdx.x, w, sw);
#pragma unroll
    for (int q = 0; q < kScatterPer; ++q)
      if (sv[q] >= 0) acc[sv[q]] += v[q];
    if ((s + 1) % per_pass == 0) __syncthreads();
#pragma unroll
    for (int q = 0; q < kScatterPer; ++q) {
      v[q] = w[q];
      sv[q] = sw[q];
    }
  }

  // each node of the tile into the nodal output once
  for (int i = threadIdx.x; i < S::VALUES; i += blockDim.x) {
    const int d = dst[i];
    if (d == 0) continue;
    T* const out = i < 3 * U::N ? out_u + (i / U::N) * n_u : out_p;
    if (d < 0)
      atomicAdd(out + (-d - 1), acc[i]);
    else
      out[d - 1] = acc[i];
  }
}

// Constrained rows, output scale and sum(out^2) over [out_u | out_p].
template <typename T>
__global__ void __launch_bounds__(256)
coupled_epilogue_kernel(T* __restrict__ out_u, T* __restrict__ out_p,
                        const T* __restrict__ x_u, const T* __restrict__ x_p,
                        const uint8_t* __restrict__ mask_u,
                        const uint8_t* __restrict__ mask_p, long long n_rows_u,
                        long long n_p, int identity, T scale, T* __restrict__ norm) {
  __shared__ T part[256];
  T local = T(0);
  const long long n = n_rows_u + n_p;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const bool is_u = r < n_rows_u;
    const long long i = is_u ? r : r - n_rows_u;
    T* o = is_u ? out_u + i : out_p + i;
    const uint8_t* m = is_u ? mask_u : mask_p;
    T v = *o;
    if (m != nullptr && m[i]) v = identity ? (is_u ? x_u[i] : -x_p[i]) : T(0);
    v *= scale;
    *o = v;
    local += v * v;
  }
  if (norm == nullptr) return;
  part[threadIdx.x] = local;
  __syncthreads();
  for (unsigned s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicAdd(norm, part[0]);
}

// The kernel's 1D tables and per-step scalars from the host doubles.
template <int DIM, int N1, int Q1, int P1, typename T>
Tables<T> make_tables(const double* tab) {
  Tables<T> t{};
  for (int q = 0; q < Q1; ++q) {
    for (int i = 0; i < N1; ++i) {
      t.V[q * N1 + i] = (T)tab[q * N1 + i];
      t.D[q * N1 + i] = (T)tab[Q1 * N1 + q * N1 + i];
    }
    for (int i = 0; i < P1; ++i) t.Vp[q * P1 + i] = (T)tab[2 * Q1 * N1 + q * P1 + i];
    t.w[q] = (T)tab[2 * Q1 * N1 + Q1 * P1 + q];
  }
  const int off = 2 * Q1 * N1 + Q1 * P1 + Q1;
  for (int a = 0; a < DIM; ++a) t.inv_h[a] = (T)tab[off + a];
  t.vol = (T)tab[off + DIM];
  return t;
}

template <typename T>
Scalars<T> make_scalars(const double* scal) {
  return Scalars<T>{(T)scal[0], (T)scal[1], (T)scal[2], (T)scal[3],
                    (T)scal[4], (T)scal[5], (T)scal[6]};
}

// The blocks of `kern` with `smem` bytes of shared memory that one SM holds
// (the occupancy calculator), after allowing that shared memory.
template <typename K>
cudaError_t resident_blocks(K kern, size_t smem, int* per_sm, int threads = kThreads) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads, smem);
}

// An instance of the cell kernel with the one-shot body and its launch
// geometry: CPB cells per block; SMEM bytes of shared memory per block (M89
// for kPhMDot, then the cells).
template <int DIM, int N1, int Q1, int P1, bool PRES, int SRC, int STREAM, int DST,
          typename T, int PH = kPhAll>
struct Once {
  using L = Lines<DIM, N1, Q1, P1, PRES, STREAM == kStreamQFields>;
  static constexpr int CPB = cells_per_block<L, T>();
  static constexpr int SMEM =
      (((PH & kPhMDot) ? L::LDX * L::LDX : 0) + CPB * L::CS) * (int)sizeof(T);
  static auto kernel() {
    return coupled_cell_kernel<DIM, N1, Q1, P1, PRES, SRC, STREAM, DST, T, PH>;
  }
  static Tables<T> tables(const double* tab) { return make_tables<DIM, N1, Q1, P1, T>(tab); }
};

// Launch a one-shot instance I: one block per group of I::CPB cells.
template <typename I, typename T>
int launch_once(const void* u, const void* p, const void* us, const int32_t* cell_u,
                const int32_t* cell_p, const uint8_t* mask_u, const uint8_t* mask_p,
                const void* rho, const void* mu, const void* damp, void* out_u, void* out_p,
                long long n_u, long long n_cells, const double* tab, const double* scal,
                ProbeArgs<T> pa, cudaStream_t stream) {
  auto kern = I::kernel();
  if (I::SMEM > 48 * 1024) {
    // once per instance (a CUDA graph may capture the launches)
    static const cudaError_t allowed = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, I::SMEM);
    if (allowed != cudaSuccess) return (int)allowed;
  }
  if (n_cells > 0) {
    const long long grid = (n_cells + I::CPB - 1) / I::CPB;
    kern<<<(unsigned)grid, kThreads, I::SMEM, stream>>>(
        (const T*)u, (const T*)p, (const T*)us, cell_u, cell_p, mask_u, mask_p,
        (const T*)rho, (const T*)mu, (const T*)damp, (T*)out_u, (T*)out_p, n_u, n_cells,
        I::tables(tab), make_scalars<T>(scal), pa);
  }
  return (int)cudaGetLastError();
}

// The production instance of an entry (mode, pres; see adaflo_coupled_cells),
// passed to f as a value of its Once type.
template <typename T, int DIM, int N1, int Q1, int P1, bool PRES, typename F>
int with_mode(int mode, F f) {
  switch (mode) {
    case 0: return f(Once<DIM, N1, Q1, P1, PRES, kSrcTable, kStreamDofs, kOutScatter, T>{});
    case 1: return f(Once<DIM, N1, Q1, P1, PRES, kSrcBlock, kStreamDofs, kOutBlock, T>{});
    case 2: return f(Once<DIM, N1, Q1, P1, PRES, kSrcBlock, kStreamQFields, kOutBlock, T>{});
    case 3: return f(Once<DIM, N1, Q1, P1, PRES, kSrcTable, kStreamDofs, kOutBlock, T>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename F>
int with_cells(int mode, int pres, int dim, int degree, F f) {
#define ADAFLO_SET(D, N, Q, P) \
  (pres ? with_mode<T, D, N, Q, P, true>(mode, f) : with_mode<T, D, N, Q, P, false>(mode, f))
  if (dim == 3 && degree == 2) return ADAFLO_SET(3, 3, 3, 2);
  if (dim == 2 && degree == 2) return ADAFLO_SET(2, 3, 3, 2);
  if (dim == 3 && degree == 3) return ADAFLO_SET(3, 4, 4, 3);
#undef ADAFLO_SET
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_cells(int mode, int pres, int dim, int degree, const void* u, const void* p,
                 const void* us, const int32_t* cell_u, const int32_t* cell_p,
                 const uint8_t* mask_u, const uint8_t* mask_p, const void* rho,
                 const void* mu, const void* damp, void* out_u, void* out_p,
                 long long n_u, long long n_cells, const double* tab,
                 const double* scal, cudaStream_t stream) {
  // nodal pressure in and out exactly when the entry has pressure rows
  const bool p_in = mode == 0 || mode == 3 ? (bool)pres : false;
  const bool p_out = mode == 0 ? (bool)pres : false;
  if ((p != nullptr) != p_in || (out_p != nullptr) != p_out || us == nullptr)
    return (int)cudaErrorInvalidValue;
  return with_cells<T>(mode, pres, dim, degree, [&](auto inst) {
    return launch_once<decltype(inst), T>(u, p, us, cell_u, cell_p, mask_u, mask_p, rho, mu,
                                          damp, out_u, out_p, n_u, n_cells, tab, scal,
                                          ProbeArgs<T>{nullptr, 0, 0, 0}, stream);
  });
}

// Launch a K13 schedule of the cell kernel (3D Q2/Q1, table source, atomic
// scatter, constant coefficients) on a persistent grid: as many blocks as
// fit resident on the card, at most one per cell group (kSchedPair: per pair
// of groups). Shared memory and cells per group: sched_lines_bytes at
// sched_cpb, the pipe's slab with the segments of a lattice of ncx cells
// along x.
template <typename T>
size_t schedule_smem(int sched, int ncx, int* cpb_out) {
  const int cpb = sched == kSchedPipe     ? sched_cpb<kSchedPipe, T>()
                  : sched == kSchedPair   ? sched_cpb<kSchedPair, T>()
                                          : sched_cpb<kSchedRowAsync, T>();
  if (cpb_out != nullptr) *cpb_out = cpb;
  return sched_lines_bytes<T>(sched, cpb, sched == kSchedPipe ? pipe_max_segments(cpb, ncx) : 0);
}

// K13's schedule `sched` of the probe configuration's cell kernel, passed to f.
template <typename T, typename F>
int with_schedule(int sched, F f) {
#define ADAFLO_SCHED(s) \
  coupled_cell_kernel<3, 3, 3, 2, true, kSrcTable, kStreamDofs, kOutScatter, T, kPhAll, s>
  switch (sched) {
    case kSchedRowAsync: return f(ADAFLO_SCHED(kSchedRowAsync));
    case kSchedPipe: return f(ADAFLO_SCHED(kSchedPipe));
    case kSchedPair: return f(ADAFLO_SCHED(kSchedPair));
    default: return (int)cudaErrorInvalidValue;
  }
#undef ADAFLO_SCHED
}

template <typename T, typename K>
int launch_schedule(K kern, int sched, const void* u, const void* p, const void* us,
                    const int32_t* cell_u, const int32_t* cell_p, const uint8_t* mask_u,
                    const uint8_t* mask_p, void* out_u, void* out_p, long long n_u,
                    long long n_cells, const double* tab, const double* scal,
                    ProbeArgs<T> pa, cudaStream_t stream) {
  int cpb = 0, dev = 0, sms = 0, per_sm = 0;
  const size_t smem = schedule_smem<T>(sched, pa.ncx, &cpb);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = resident_blocks(kern, smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (n_cells + cpb - 1) / cpb;
  const long long units = sched == kSchedPair ? (groups + 1) / 2 : groups;
  const long long resident = (long long)per_sm * sms;
  const long long grid = resident < units ? resident : units;
  if (grid > 0) {
    kern<<<(unsigned)grid, kThreads, smem, stream>>>(
        (const T*)u, (const T*)p, (const T*)us, cell_u, cell_p, mask_u, mask_p, nullptr,
        nullptr, nullptr, (T*)out_u, (T*)out_p, n_u, n_cells,
        make_tables<3, 3, 3, 2, T>(tab), make_scalars<T>(scal), pa);
  }
  return (int)cudaGetLastError();
}

// The probe configuration (3D Q2/Q1 with pressure, table source, atomic
// scatter) with the phases PH, one-shot
template <typename T, int PH>
using ProbeOnce = Once<3, 3, 3, 2, true, kSrcTable, kStreamDofs, kOutScatter, T, PH>;

// K12/K13 and K11: 3D Q2/Q1 with pressure, nodal in and out, constant
// coefficients; a phase mask PH (table source), the lattice source, or one
// of K13's schedules (every phase, table source).
template <typename T>
int launch_variant(int phases, int lattice, int sched, const void* u, const void* p,
                   const void* us, const int32_t* cell_u, const int32_t* cell_p,
                   const uint8_t* mask_u, const uint8_t* mask_p, void* out_u,
                   void* out_p, long long n_u, long long n_cells, const double* tab,
                   const double* scal, ProbeArgs<T> pa, cudaStream_t stream) {
  auto go = [&](auto inst) {
    return launch_once<decltype(inst), T>(u, p, us, cell_u, cell_p, mask_u, mask_p, nullptr,
                                          nullptr, nullptr, out_u, out_p, n_u, n_cells, tab,
                                          scal, pa, stream);
  };
  if (p == nullptr || out_p == nullptr || us == nullptr) return (int)cudaErrorInvalidValue;
  if (sched != kSchedOnce) {
    if (lattice || phases != kPhAll || cell_u == nullptr || cell_p == nullptr)
      return (int)cudaErrorInvalidValue;
    // the pipe's copies address the lattice: its cells per axis
    if (sched == kSchedPipe && (pa.ncx < 1 || pa.ncy < 1)) return (int)cudaErrorInvalidValue;
    return with_schedule<T>(sched, [&](auto kern) {
      return launch_schedule<T>(kern, sched, u, p, us, cell_u, cell_p, mask_u, mask_p, out_u,
                                out_p, n_u, n_cells, tab, scal, pa, stream);
    });
  }
  if (lattice) {
    if (phases != kPhAll) return (int)cudaErrorInvalidValue;
    return go(Once<3, 3, 3, 2, true, kSrcLattice, kStreamDofs, kOutScatter, T>{});
  }
  if (phases != kPhAll && (cell_u == nullptr || cell_p == nullptr)) return (int)cudaErrorInvalidValue;
  switch (phases) {
    case kPhAll: return go(ProbeOnce<T, kPhAll>{});
    case kPhAll & ~kPhGather: return go(ProbeOnce<T, kPhAll & ~kPhGather>{});
    case kPhAll & ~kPhEvalU: return go(ProbeOnce<T, kPhAll & ~kPhEvalU>{});
    case kPhAll & ~kPhEvalUs: return go(ProbeOnce<T, kPhAll & ~kPhEvalUs>{});
    case kPhAll & ~kPhQPoint: return go(ProbeOnce<T, kPhAll & ~kPhQPoint>{});
    case kPhAll & ~kPhIntegrate: return go(ProbeOnce<T, kPhAll & ~kPhIntegrate>{});
    case kPhAll & ~kPhScatter: return go(ProbeOnce<T, kPhAll & ~kPhScatter>{});
    case kPhGather: return go(ProbeOnce<T, kPhGather>{});
    case kPhGather | kPhScatter: return go(ProbeOnce<T, kPhGather | kPhScatter>{});
    case kPhContig | kPhScatter: return go(ProbeOnce<T, kPhContig | kPhScatter>{});
    case kPhGather | kPhMDot | kPhScatter:
      if (pa.M == nullptr) return (int)cudaErrorInvalidValue;
      return go(ProbeOnce<T, kPhGather | kPhMDot | kPhScatter>{});
    case kPhGather | kPhEvalU | kPhEvalUs | kPhScatter:
      return go(ProbeOnce<T, kPhGather | kPhEvalU | kPhEvalUs | kPhScatter>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Cells per group, shared memory of one block and resident blocks per SM of
// a schedule.
template <typename T>
int residency(int sched, int ncx, int* cpb, int* smem, int* blocks_per_sm) {
  if (sched == kSchedPipe && ncx < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = schedule_smem<T>(sched, ncx, cpb);
  *smem = (int)bytes;
  return with_schedule<T>(sched, [&](auto kern) {
    return (int)resident_blocks(kern, bytes, blocks_per_sm);
  });
}

// Cells per block, shared memory per block and resident blocks per SM of a
// production instance.
template <typename T>
int geometry(int mode, int pres, int dim, int degree, int* cpb, int* smem, int* blocks_per_sm) {
  return with_cells<T>(mode, pres, dim, degree, [&](auto inst) {
    using I = decltype(inst);
    *cpb = I::CPB;
    *smem = I::SMEM;
    return (int)resident_blocks(I::kernel(), I::SMEM, blocks_per_sm);
  });
}

// K6's launch on the ncx x ncy x ncz lattice: one block of kScatterThreads
// per tile, ScatterTile<T>::SMEM bytes of shared memory each.
ScatterLattice scatter_lattice(int ncx, int ncy, int ncz, int periodic, long long* grid) {
  ScatterLattice lat;
  const int nc[3] = {ncx, ncy, ncz}, tile[3] = {kScatterTX, kScatterTY, kScatterTZ};
  *grid = 1;
  for (int a = 0; a < 3; ++a) {
    const int wraps = (periodic >> a) & 1;
    lat.nc[a] = nc[a];
    lat.nu[a] = 2 * nc[a] + 1 - wraps;
    lat.np[a] = nc[a] + 1 - wraps;
    lat.tiles[a] = (nc[a] + tile[a] - 1) / tile[a];
    *grid *= lat.tiles[a];
  }
  lat.periodic = periodic;
  return lat;
}

template <typename T>
int launch_scatter(const void* block, void* out_u, void* out_p, long long n_u, int ncx,
                   int ncy, int ncz, int periodic, cudaStream_t stream) {
  if (ncx < 1 || ncy < 1 || ncz < 1) return (int)cudaErrorInvalidValue;
  long long grid;
  const ScatterLattice lat = scatter_lattice(ncx, ncy, ncz, periodic, &grid);
  if (grid > 0x7fffffffLL || n_u > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      scatter_tiles_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, ScatterTile<T>::SMEM);
  if (allowed != cudaSuccess) return (int)allowed;
  scatter_tiles_kernel<T><<<(unsigned)grid, kScatterThreads, ScatterTile<T>::SMEM, stream>>>(
      (const T*)block, (T*)out_u, (T*)out_p, n_u, lat);
  return (int)cudaGetLastError();
}

template <typename T>
int scatter_plan(int ncx, int ncy, int ncz, int* tile, int* threads, int* smem,
                 int* blocks_per_sm, long long* grid) {
  scatter_lattice(ncx, ncy, ncz, 0, grid);
  tile[0] = kScatterTX;
  tile[1] = kScatterTY;
  tile[2] = kScatterTZ;
  *threads = kScatterThreads;
  *smem = ScatterTile<T>::SMEM;
  return (int)resident_blocks(scatter_tiles_kernel<T>, ScatterTile<T>::SMEM, blocks_per_sm,
                              kScatterThreads);
}

}  // namespace

extern "C" {

// Cell kernel. dtype: 0 float32, 1 float64. mode:
//   0 K1/K2: out_u/out_p (nodal, zeroed by the caller) += the coupled apply of
//     nodal u, p, u* (us) read through cell_u/cell_p, masked by mask_u/mask_p;
//   1 K3, dof stream: out_u = the (E, n_cols) block of the apply of the cell
//     block u (E, n_cols) with the u* cell dofs us (E, dim n_u);
//   2 K3, q-field stream: as 1 with us the u* q-fields (E, dim (dim+1), n_q);
//   3 K4: out_u = the (E, n_cols) block of the apply of nodal u, p, u* read
//     as in mode 0.
// pres 0: velocity rows only, without a pressure input (p, out_p null); the
// blocks are then (E, dim n_u). rho/mu/damp null each: that coefficient is
// the constant scal value. tab: host doubles [V (Q1 x N1), D (Q1 x N1),
// Vp (Q1 x P1), w (Q1), inv_h (dim), vol]. scal: host doubles
// [beta, weight, tau1, rho0, mu0, damp0, tau_grad_div].
int adaflo_coupled_cells(int dtype, int mode, int pres, int dim, int degree, const void* u,
                         const void* p, const void* us, const int32_t* cell_u,
                         const int32_t* cell_p, const uint8_t* mask_u,
                         const uint8_t* mask_p, const void* rho, const void* mu,
                         const void* damp, void* out_u, void* out_p,
                         long long n_u, long long n_cells, const double* tab,
                         const double* scal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_cells<double>(mode, pres, dim, degree, u, p, us, cell_u, cell_p, mask_u,
                                mask_p, rho, mu, damp, out_u, out_p, n_u, n_cells,
                                tab, scal, st);
  if (dtype == 0)
    return launch_cells<float>(mode, pres, dim, degree, u, p, us, cell_u, cell_p, mask_u,
                               mask_p, rho, mu, damp, out_u, out_p, n_u, n_cells,
                               tab, scal, st);
  return (int)cudaErrorInvalidValue;
}

// Epilogue over [out_u (n_rows_u) | out_p (n_p)]: constrained rows become
// +x_u / -x_p (identity != 0) or 0, then out *= scale, and norm (zeroed by
// the caller, may be null) += sum(out^2).
int adaflo_coupled_epilogue(int dtype, void* out_u, void* out_p,
                            const void* x_u, const void* x_p,
                            const uint8_t* mask_u, const uint8_t* mask_p,
                            long long n_rows_u, long long n_p, int identity,
                            double scale, void* norm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = n_rows_u + n_p;
  long long blocks = (n + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  if (dtype == 1)
    coupled_epilogue_kernel<double><<<(unsigned)blocks, 256, 0, st>>>(
        (double*)out_u, (double*)out_p, (const double*)x_u, (const double*)x_p,
        mask_u, mask_p, n_rows_u, n_p, identity, scale, (double*)norm);
  else if (dtype == 0)
    coupled_epilogue_kernel<float><<<(unsigned)blocks, 256, 0, st>>>(
        (float*)out_u, (float*)out_p, (const float*)x_u, (const float*)x_p,
        mask_u, mask_p, n_rows_u, n_p, identity, (float)scale, (float*)norm);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K12/K13 (lattice 0) and K11 (lattice 1): 3D Q2/Q1, out_u/out_p (nodal,
// zeroed by the caller) += the apply of nodal u, p, u* with constant
// coefficients, its phases the mask `phases` (kPh* bits; one of the probe
// variants). K11 takes phases = kPhAll and reads no cell table: its
// addresses come from the cells per axis ncx, ncy of the uniform,
// non-periodic lattice. sched: kSched* (0 for K11, K12 and K13's
// ablations; K13's schedules take phases = kPhAll, lattice 0 and the cell
// tables, and kSchedPipe also ncx, ncy, whose bulk copies address the
// lattice). M: M89 (89 x 89, row-major) for kPhMDot, else null. n_p:
// pressure length (read by kPhContig). tab, scal: as adaflo_coupled_cells.
int adaflo_coupled_variant(int dtype, int phases, int lattice, int sched, const void* u,
                           const void* p, const void* us, const int32_t* cell_u,
                           const int32_t* cell_p, const uint8_t* mask_u,
                           const uint8_t* mask_p, const void* M, void* out_u,
                           void* out_p, long long n_u, long long n_p,
                           long long n_cells, int ncx, int ncy, const double* tab,
                           const double* scal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_variant<double>(phases, lattice, sched, u, p, us, cell_u, cell_p, mask_u,
                                  mask_p, out_u, out_p, n_u, n_cells, tab, scal,
                                  ProbeArgs<double>{(const double*)M, n_p, ncx, ncy}, st);
  if (dtype == 0)
    return launch_variant<float>(phases, lattice, sched, u, p, us, cell_u, cell_p, mask_u,
                                 mask_p, out_u, out_p, n_u, n_cells, tab, scal,
                                 ProbeArgs<float>{(const float*)M, n_p, ncx, ncy}, st);
  return (int)cudaErrorInvalidValue;
}

// K13's schedules (sched kSchedRowAsync, kSchedPipe, kSchedPair) in the
// probe configuration: the cells per group (cpb), the dynamic shared memory
// of one block (smem, bytes) and the blocks of 128 threads one SM holds (the
// occupancy calculator); ncx: the lattice's cells along x (the pipe's slab
// depends on it).
int adaflo_coupled_residency(int dtype, int sched, int ncx, int* cpb, int* smem,
                             int* blocks_per_sm) {
  if (dtype == 1) return residency<double>(sched, ncx, cpb, smem, blocks_per_sm);
  if (dtype == 0) return residency<float>(sched, ncx, cpb, smem, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

// The production instance of entry `mode` (pres, dim, degree as
// adaflo_coupled_cells): its cells per block (cpb), the dynamic shared memory
// of one block (smem, bytes) and the blocks of 128 threads one SM holds (the
// occupancy calculator).
int adaflo_coupled_geometry(int dtype, int mode, int pres, int dim, int degree, int* cpb,
                            int* smem, int* blocks_per_sm) {
  if (dtype == 1) return geometry<double>(mode, pres, dim, degree, cpb, smem, blocks_per_sm);
  if (dtype == 0) return geometry<float>(mode, pres, dim, degree, cpb, smem, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

// K6, 3D Q2/Q1: out_u (3, n_u) and out_p += the cell-major block (E, 89) of
// the uniform ncx x ncy x ncz lattice (cells x fastest, E = ncx ncy ncz),
// each dof's address from its cell's lattice coordinates; periodic: bit a
// set where axis a wraps (its deg nc nodes, node deg nc being node 0).
int adaflo_scatter_cells(int dtype, const void* block, void* out_u, void* out_p, long long n_u,
                         int ncx, int ncy, int ncz, int periodic, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_scatter<double>(block, out_u, out_p, n_u, ncx, ncy, ncz, periodic, st);
  if (dtype == 0)
    return launch_scatter<float>(block, out_u, out_p, n_u, ncx, ncy, ncz, periodic, st);
  return (int)cudaErrorInvalidValue;
}

// K6's launch plan on the ncx x ncy x ncz lattice: the tile (tile[3], cells
// per axis), threads per block, dynamic shared memory of one block (bytes),
// resident blocks per SM (the occupancy calculator) and grid (tiles).
int adaflo_scatter_plan(int dtype, int ncx, int ncy, int ncz, int* tile, int* threads,
                        int* smem, int* blocks_per_sm, long long* grid) {
  if (dtype == 1)
    return scatter_plan<double>(ncx, ncy, ncz, tile, threads, smem, blocks_per_sm, grid);
  if (dtype == 0)
    return scatter_plan<float>(ncx, ncy, ncz, tile, threads, smem, blocks_per_sm, grid);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
