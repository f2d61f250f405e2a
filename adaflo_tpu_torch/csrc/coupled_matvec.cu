// Coupled Navier-Stokes cell apply for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels adaflo_tpu/ops/pallas_matvec.py:coupled_vmult_pr2
// (K1, the resident apply inside the Krylov solve) and :coupled_vmult_pr (K2,
// the plain apply of vmult / velocity_vmult). It computes, for every cell of a
// uniform Cartesian lattice, the Newton-linearized Navier-Stokes operator
//
//   value_c  = (rho w - d) u_c + tau1 rho conv_c          (constant mode)
//            = rho(q) (w u_c + tau1 conv_c) - d(q) u_c    (variable mode)
//   conv_c   = beta (div u  u*_c + div u*  u_c) + sum_e (u*_e d_e u_c + u_e d_e u*_c)
//   stress_cd = tau1 mu (d_d u_c + d_c u_d) + (tau_gd div u - p) delta_cd
//   prow     = -div u
//
// integrated against the test functions, and adds the cell results into the
// nodal output with atomicAdd. A second small kernel (the epilogue) sets the
// constrained rows (+x for velocity, -x for pressure, or 0), applies the output
// scale and accumulates sum(out^2).
//
// Design. The TPU kernel's parity packing, 128-lane blocks, 27->32 q-row
// padding and ring DMA answer the TPU's vector memory and are not copied.
// Here one thread block takes CPB cells. The cell's dofs (u, the frozen
// linearization point u*, p) are gathered through an int32 cell->dof table
// into shared memory, with constrained entries read as zero. Values and
// gradients at the Gauss points come from sum factorization: one 1D
// contraction per axis with the (Q1 x N1) basis values V and derivatives D.
// The q-point terms follow NavierStokesOperator._q_point_terms for "vmult";
// the transposed sum factorization integrates them. The 1D matrices travel
// as a by-value kernel argument, which the hardware keeps in the constant
// bank, and are staged into shared memory at block start. float64 and
// float32 are template instances, as are the table sets 3D Q2/Q1, 2D Q2/Q1
// and 3D Q3/Q2.
//
// Scatter. atomicAdd into the zeroed output (native for float64 on sm_60 and
// later). A dof on a vertex takes up to 8 cell contributions, so the sum order
// changes from run to run by roundoff: results agree with the plain PyTorch
// version to about 1e-15 relative, not bit for bit.
//
// Bound on an H100 SXM at its 700 W limit (NVIDIA data sheet: 3.35 TB/s
// HBM3, 34 TFLOP/s float64 outside the tensor cores). Per apply the kernel
// must read u, u* and p once, read the int32 cell tables and masks once, and
// write the output once: at the 48^3-cell Q2/Q1 lattice (2,855,668 dofs)
// that is 85.9 MB in float64, 25.6 us at 3.35 TB/s. The sum factorization
// needs 14,482 flops per cell (3D Q2/Q1; 14,067 without the pressure stages
// of the velocity-only entry), 1.60 GFLOP at 48^3, 47 us at 34 TFLOP/s: the
// kernel is bound by operations, about 1.8 times over (chip_smoke.py counts
// both bounds from each run's shapes). The design
// keeps every intermediate in shared memory, so that the only device-memory
// traffic is the gather, the atomic scatter and the epilogue's read, modify
// and write. It does not reach the bound: the gather is uncoalesced (one
// cell's dofs are strided across the lattice), the 1D contraction loops are
// 3 or 4 long, and the atomics serialize on shared vertices. Staging lattice
// slabs through shared memory with TMA and moving the contractions onto DMMA
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

constexpr int kThreads = 128;
constexpr int kMaxTab = 16;

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

template <int DIM, int N1, int Q1, int P1>
struct Shape {
  static constexpr int NL = ipow(N1, DIM);   // velocity dofs per component
  static constexpr int NQ = ipow(Q1, DIM);   // quadrature points
  static constexpr int NP = ipow(P1, DIM);   // pressure dofs
  static constexpr int NB = ipow(imax(N1, Q1), DIM);  // one buffer slot
  // buffer regions per cell, in slots (see the stage comments below)
  static constexpr int IN = 0;
  static constexpr int S1 = 2 * DIM + 1;
  static constexpr int S2 = S1 + 4 * DIM + 1;
  static constexpr int F = DIM == 3 ? S2 + 6 * DIM + 1 : S2;
  static constexpr int SLOTS = F + (DIM + 1) * 2 * DIM + 1;
};

// One output element of a 1D contraction along axis `ax` (0 = x, the fastest)
// of a tensor with input extents (e0, e1, e2) (x, y, z); the contracted axis
// becomes n_out long. M is (Q1 rows, ld cols): forward (tr = false) maps dofs
// to q points, out[r] = sum_s M[r ld + s] in[s]; transposed (tr = true) maps
// q points to dofs, out[r] = sum_s M[s ld + r] in[s]. An optional second
// (in2, M2) pair is added into the same output.
template <typename T>
__device__ __forceinline__ void axis_op(T* __restrict__ out, const T* in,
                                        const T* M, const T* in2, const T* M2,
                                        int ld, bool tr, int ax, int e0, int e1,
                                        int e2, int n_out, int o) {
  const int f0 = ax == 0 ? n_out : e0;
  const int f1 = ax == 1 ? n_out : e1;
  const int i0 = o % f0, i1 = (o / f0) % f1, i2 = o / (f0 * f1);
  int r, base, stride, n_in;
  if (ax == 0) {
    r = i0; base = (i2 * e1 + i1) * e0; stride = 1; n_in = e0;
  } else if (ax == 1) {
    r = i1; base = i2 * e1 * e0 + i0; stride = e0; n_in = e1;
  } else {
    r = i2; base = i1 * e0 + i0; stride = e0 * e1; n_in = e2;
  }
  T acc = T(0);
  for (int s = 0; s < n_in; ++s) {
    const int k = tr ? s * ld + r : r * ld + s;
    acc += M[k] * in[base + s * stride];
    if (in2 != nullptr) acc += M2[k] * in2[base + s * stride];
  }
  out[o] = acc;
}

// PRES: the pressure input and the pressure rows; the velocity-only entry
// (no pressure) skips the pressure evaluation and integration stages
template <int DIM, int N1, int Q1, int P1, bool PRES, typename T>
__global__ void __launch_bounds__(kThreads)
coupled_cell_kernel(const T* __restrict__ u, const T* __restrict__ p,
                    const T* __restrict__ us, const int32_t* __restrict__ cell_u,
                    const int32_t* __restrict__ cell_p,
                    const uint8_t* __restrict__ mask_u,
                    const uint8_t* __restrict__ mask_p,
                    const T* __restrict__ rho, const T* __restrict__ mu,
                    const T* __restrict__ damp, T* __restrict__ out_u,
                    T* __restrict__ out_p, long long n_u, long long n_cells,
                    int cpb, Tables<T> tab, Scalars<T> sc) {
  using S = Shape<DIM, N1, Q1, P1>;
  constexpr int NL = S::NL, NQ = S::NQ, NP = S::NP, NB = S::NB;
  constexpr int IN = S::IN, S1 = S::S1, S2 = S::S2, F = S::F;
  constexpr int CS = S::SLOTS * NB;  // per-cell stride in elements
  constexpr int FI = DIM + 1;        // final fields per item: value + grads
  constexpr int NI = 2 * DIM;        // items: u_0.., u*_0..

  extern __shared__ unsigned char smem_raw[];
  T* sV = reinterpret_cast<T*>(smem_raw);
  T* sD = sV + kMaxTab;
  T* sVp = sD + kMaxTab;
  T* buf = sVp + kMaxTab;

  const int tid = threadIdx.x, nth = blockDim.x;
  for (int i = tid; i < kMaxTab; i += nth) {
    sV[i] = tab.V[i];
    sD[i] = tab.D[i];
    sVp[i] = tab.Vp[i];
  }
  const long long c0 = (long long)blockIdx.x * cpb;
  const int nc = (int)min((long long)cpb, n_cells - c0);

  // ---- gather: u (constrained entries read 0), u* (plain), p (masked) ----
  constexpr int per_g = NI * NL + (PRES ? NP : 0);
  for (int t = tid; t < nc * per_g; t += nth) {
    const int cell = t / per_g;
    const int k = t % per_g;
    const long long e = c0 + cell;
    T* cb = buf + cell * CS;
    if (k < NI * NL) {
      const int item = k / NL, l = k % NL;
      const long long dof = cell_u[e * NL + l];
      T v;
      if (item < DIM) {
        const long long g = item * n_u + dof;
        v = (mask_u != nullptr && mask_u[g]) ? T(0) : u[g];
      } else {
        v = us[(item - DIM) * n_u + dof];
      }
      cb[(IN + item) * NB + l] = v;
    } else {
      const int l = k - NI * NL;
      const long long dof = cell_p[e * NP + l];
      cb[(IN + NI) * NB + l] = (mask_p != nullptr && mask_p[dof]) ? T(0) : p[dof];
    }
  }
  __syncthreads();

  // ---- evaluation, stage x: A0 = Vx u, A1 = Dx u; pressure Vpx p ---------
  {
    constexpr int n1 = ipow(N1, DIM - 1) * Q1, np1 = ipow(P1, DIM - 1) * Q1;
    constexpr int e2 = DIM == 3 ? N1 : 1, pe2 = DIM == 3 ? P1 : 1;
    constexpr int per = NI * 2 * n1 + (PRES ? np1 : 0);
    for (int t = tid; t < nc * per; t += nth) {
      T* cb = buf + (t / per) * CS;
      int k = t % per;
      if (k < NI * 2 * n1) {
        const int item = k / (2 * n1), which = (k / n1) % 2, o = k % n1;
        axis_op<T>(cb + (S1 + 2 * item + which) * NB, cb + (IN + item) * NB,
                   which ? sD : sV, nullptr, nullptr, N1, false, 0, N1, N1, e2,
                   Q1, o);
      } else {
        k -= NI * 2 * n1;
        axis_op<T>(cb + (S1 + 2 * NI) * NB, cb + (IN + NI) * NB, sVp, nullptr,
                   nullptr, P1, false, 0, P1, P1, pe2, Q1, k);
      }
    }
  }
  __syncthreads();

  // ---- evaluation, stage y: B00 = Vy A0, B01 = Dy A0, B10 = Vy A1 -------
  // (2D: these are the final fields value, d/dy, d/dx, written to F)
  {
    constexpr int n2 = ipow(Q1, 2) * (DIM == 3 ? N1 : 1);
    constexpr int np2 = ipow(Q1, 2) * (DIM == 3 ? P1 : 1);
    constexpr int e2 = DIM == 3 ? N1 : 1, pe2 = DIM == 3 ? P1 : 1;
    constexpr int per = NI * 3 * n2 + (PRES ? np2 : 0);
    for (int t = tid; t < nc * per; t += nth) {
      T* cb = buf + (t / per) * CS;
      int k = t % per;
      if (k < NI * 3 * n2) {
        const int item = k / (3 * n2), which = (k / n2) % 3, o = k % n2;
        const T* src = cb + (S1 + 2 * item + (which == 2 ? 1 : 0)) * NB;
        const T* M = which == 1 ? sD : sV;
        T* dst;
        if (DIM == 3) {
          dst = cb + (S2 + 3 * item + which) * NB;
        } else {
          // value, d/dy (Dy Vx), d/dx (Vy Dx) -> F slots 0, 2, 1
          const int f = which == 0 ? 0 : (which == 1 ? 2 : 1);
          dst = cb + (F + FI * item + f) * NB;
        }
        axis_op<T>(dst, src, M, nullptr, nullptr, N1, false, 1, Q1, N1, e2, Q1,
                   o);
      } else {
        k -= NI * 3 * n2;
        T* dst = DIM == 3 ? cb + (S2 + 3 * NI) * NB : cb + (F + FI * NI) * NB;
        axis_op<T>(dst, cb + (S1 + 2 * NI) * NB, sVp, nullptr, nullptr, P1,
                   false, 1, Q1, P1, pe2, Q1, k);
      }
    }
  }
  __syncthreads();

  // ---- evaluation, stage z (3D): value = Vz B00, d/dx = Vz B10,
  //      d/dy = Vz B01, d/dz = Dz B00 ---------------------------------------
  if constexpr (DIM == 3) {
    constexpr int n3 = NQ;
    constexpr int per = NI * 4 * n3 + (PRES ? n3 : 0);
    for (int t = tid; t < nc * per; t += nth) {
      T* cb = buf + (t / per) * CS;
      int k = t % per;
      if (k < NI * 4 * n3) {
        const int item = k / (4 * n3), which = (k / n3) % 4, o = k % n3;
        const int src_slot = which == 1 ? 2 : (which == 2 ? 1 : 0);
        axis_op<T>(cb + (F + FI * item + which) * NB,
                   cb + (S2 + 3 * item + src_slot) * NB, which == 3 ? sD : sV,
                   nullptr, nullptr, N1, false, 2, Q1, Q1, N1, Q1, o);
      } else {
        k -= NI * 4 * n3;
        axis_op<T>(cb + (F + FI * NI) * NB, cb + (S2 + 3 * NI) * NB, sVp,
                   nullptr, nullptr, P1, false, 2, Q1, Q1, P1, Q1, k);
      }
    }
    __syncthreads();
  }

  // ---- q-point terms (NavierStokesOperator._q_point_terms, "vmult") -------
  // outputs into S1: value_c at +c, stress_cd at +DIM+DIM c+d, prow at +DIM+DIM^2
  for (int t = tid; t < nc * NQ; t += nth) {
    const int cell = t / NQ, q = t % NQ;
    T* cb = buf + cell * CS;
    const int qx = q % Q1, qy = (q / Q1) % Q1, qz = q / (Q1 * Q1);
    T jxw = tab.w[qx] * tab.w[qy] * tab.vol;
    if (DIM == 3) jxw *= tab.w[qz];
    T uv[DIM], sv[DIM], ug[DIM][DIM], sg[DIM][DIM];
    for (int c = 0; c < DIM; ++c) {
      uv[c] = cb[(F + FI * c) * NB + q];
      sv[c] = cb[(F + FI * (DIM + c)) * NB + q];
      for (int d = 0; d < DIM; ++d) {
        ug[c][d] = cb[(F + FI * c + 1 + d) * NB + q] * tab.inv_h[d];
        sg[c][d] = cb[(F + FI * (DIM + c) + 1 + d) * NB + q] * tab.inv_h[d];
      }
    }
    const T pq = PRES ? cb[(F + FI * NI) * NB + q] : T(0);
    T div = T(0), div_s = T(0);
    for (int a = 0; a < DIM; ++a) {
      div += ug[a][a];
      div_s += sg[a][a];
    }
    const bool variable = rho != nullptr || mu != nullptr || damp != nullptr;
    const long long qi = (c0 + cell) * NQ + q;
    const T r_q = rho != nullptr ? rho[qi] : sc.rho0;
    const T m_q = mu != nullptr ? mu[qi] : sc.mu0;
    const T d_q = damp != nullptr ? damp[qi] : sc.damp0;
    const T tmu = sc.tau1 * m_q;
    for (int c = 0; c < DIM; ++c) {
      T conv = sc.beta * (div * sv[c] + div_s * uv[c]);
      for (int e = 0; e < DIM; ++e) conv += sv[e] * ug[c][e] + uv[e] * sg[c][e];
      const T value = variable
          ? r_q * (sc.weight * uv[c] + sc.tau1 * conv) - d_q * uv[c]
          : (sc.rho0 * sc.weight - sc.damp0) * uv[c] + sc.tau1 * sc.rho0 * conv;
      cb[(S1 + c) * NB + q] = value * jxw;
      for (int d = 0; d < DIM; ++d) {
        T st = tmu * (ug[c][d] + ug[d][c]);
        if (c == d) st += sc.tgd * div - pq;
        cb[(S1 + DIM + DIM * c + d) * NB + q] = st * jxw * tab.inv_h[d];
      }
    }
    if (PRES) cb[(S1 + DIM + DIM * DIM) * NB + q] = -div * jxw;
  }
  __syncthreads();

  // ---- integration, stage x (transposed): a_c = Vx^T value_c + Dx^T st_cx,
  //      b_c = Vx^T st_cy (, cz_c = Vx^T st_cz); pressure Vpx^T prow --------
  // outputs: 3D into S2 (3 per component), 2D into F (2 per component)
  {
    constexpr int TX = DIM == 3 ? S2 : F;
    constexpr int e2 = DIM == 3 ? Q1 : 1;
    constexpr int n1 = N1 * ipow(Q1, DIM - 1), np1 = P1 * ipow(Q1, DIM - 1);
    constexpr int per = DIM * DIM * n1 + (PRES ? np1 : 0);
    for (int t = tid; t < nc * per; t += nth) {
      T* cb = buf + (t / per) * CS;
      int k = t % per;
      if (k < DIM * DIM * n1) {
        const int c = k / (DIM * n1), j = (k / n1) % DIM, o = k % n1;
        const T* st = cb + (S1 + DIM + DIM * c) * NB;  // st_c0 .. st_c(DIM-1)
        T* dst = cb + (TX + DIM * c + j) * NB;
        if (j == 0) {
          axis_op<T>(dst, cb + (S1 + c) * NB, sV, st, sD, N1, true, 0, Q1, Q1,
                     e2, N1, o);
        } else {
          axis_op<T>(dst, st + j * NB, sV, nullptr, nullptr, N1, true, 0, Q1,
                     Q1, e2, N1, o);
        }
      } else {
        k -= DIM * DIM * n1;
        axis_op<T>(cb + (TX + DIM * DIM) * NB, cb + (S1 + DIM + DIM * DIM) * NB,
                   sVp, nullptr, nullptr, P1, true, 0, Q1, Q1, e2, P1, k);
      }
    }
  }
  __syncthreads();

  // ---- integration, stage y: 3D e_c = Vy^T a_c + Dy^T b_c, f_c = Vy^T cz_c
  //      into IN; 2D out_c = Vy^T a_c + Dy^T b_c into IN -------------------
  {
    constexpr int TX = DIM == 3 ? S2 : F;
    constexpr int e2 = DIM == 3 ? Q1 : 1;
    constexpr int n2 = N1 * N1 * (DIM == 3 ? Q1 : 1);
    constexpr int np2 = P1 * P1 * (DIM == 3 ? Q1 : 1);
    constexpr int NO = DIM == 3 ? 2 : 1;  // outputs per component
    constexpr int per = DIM * NO * n2 + (PRES ? np2 : 0);
    for (int t = tid; t < nc * per; t += nth) {
      T* cb = buf + (t / per) * CS;
      int k = t % per;
      if (k < DIM * NO * n2) {
        const int c = k / (NO * n2), j = (k / n2) % NO, o = k % n2;
        const T* src = cb + (TX + DIM * c) * NB;
        T* dst = cb + (IN + NO * c + j) * NB;
        if (j == 0) {
          axis_op<T>(dst, src, sV, src + NB, sD, N1, true, 1, N1, Q1, e2, N1,
                     o);
        } else {
          axis_op<T>(dst, src + 2 * NB, sV, nullptr, nullptr, N1, true, 1, N1,
                     Q1, e2, N1, o);
        }
      } else {
        k -= DIM * NO * n2;
        axis_op<T>(cb + (IN + NO * DIM) * NB, cb + (TX + DIM * DIM) * NB, sVp,
                   nullptr, nullptr, P1, true, 1, P1, Q1, e2, P1, k);
      }
    }
  }
  __syncthreads();

  // ---- integration, stage z (3D): out_c = Vz^T e_c + Dz^T f_c into S1 -----
  constexpr int OUT = DIM == 3 ? S1 : IN;
  if constexpr (DIM == 3) {
    constexpr int per = DIM * NL + (PRES ? NP : 0);
    for (int t = tid; t < nc * per; t += nth) {
      T* cb = buf + (t / per) * CS;
      int k = t % per;
      if (k < DIM * NL) {
        const int c = k / NL, o = k % NL;
        axis_op<T>(cb + (S1 + c) * NB, cb + (IN + 2 * c) * NB, sV,
                   cb + (IN + 2 * c + 1) * NB, sD, N1, true, 2, N1, N1, Q1, N1,
                   o);
      } else {
        k -= DIM * NL;
        axis_op<T>(cb + (S1 + DIM) * NB, cb + (IN + 2 * DIM) * NB, sVp, nullptr,
                   nullptr, P1, true, 2, P1, P1, Q1, P1, k);
      }
    }
    __syncthreads();
  }

  // ---- scatter: atomic adds into the nodal output --------------------------
  constexpr int per_s = DIM * NL + (PRES ? NP : 0);
  for (int t = tid; t < nc * per_s; t += nth) {
    const int cell = t / per_s;
    const int k = t % per_s;
    const long long e = c0 + cell;
    const T* cb = buf + cell * CS;
    if (k < DIM * NL) {
      const int c = k / NL, l = k % NL;
      atomicAdd(out_u + c * n_u + cell_u[e * NL + l], cb[(OUT + c) * NB + l]);
    } else {
      const int l = k - DIM * NL;
      atomicAdd(out_p + cell_p[e * NP + l], cb[(OUT + DIM) * NB + l]);
    }
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

template <int DIM, int N1, int Q1, int P1, typename T>
int launch_cells(const void* u, const void* p, const void* us,
                 const int32_t* cell_u, const int32_t* cell_p,
                 const uint8_t* mask_u, const uint8_t* mask_p, const void* rho,
                 const void* mu, const void* damp, void* out_u, void* out_p,
                 long long n_u, long long n_cells, const double* tab,
                 const double* scal, cudaStream_t stream) {
  using S = Shape<DIM, N1, Q1, P1>;
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
  Scalars<T> s{(T)scal[0], (T)scal[1], (T)scal[2], (T)scal[3],
               (T)scal[4], (T)scal[5], (T)scal[6]};
  const size_t cell_bytes = (size_t)S::SLOTS * S::NB * sizeof(T);
  int cpb = (int)(32768 / cell_bytes);
  if (cpb < 1) cpb = 1;
  const size_t smem = 3 * kMaxTab * sizeof(T) + cpb * cell_bytes;
  if ((p == nullptr) != (out_p == nullptr)) return (int)cudaErrorInvalidValue;
  auto kern = p != nullptr ? coupled_cell_kernel<DIM, N1, Q1, P1, true, T>
                           : coupled_cell_kernel<DIM, N1, Q1, P1, false, T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_cells > 0) {
    const long long grid = (n_cells + cpb - 1) / cpb;
    kern<<<(unsigned)grid, kThreads, smem, stream>>>(
        (const T*)u, (const T*)p, (const T*)us, cell_u, cell_p, mask_u, mask_p,
        (const T*)rho, (const T*)mu, (const T*)damp, (T*)out_u, (T*)out_p, n_u,
        n_cells, cpb, t, s);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_set(int dim, int degree, const void* u, const void* p,
               const void* us, const int32_t* cell_u, const int32_t* cell_p,
               const uint8_t* mask_u, const uint8_t* mask_p, const void* rho,
               const void* mu, const void* damp, void* out_u, void* out_p,
               long long n_u, long long n_cells, const double* tab,
               const double* scal, cudaStream_t stream) {
  if (dim == 3 && degree == 2)
    return launch_cells<3, 3, 3, 2, T>(u, p, us, cell_u, cell_p, mask_u, mask_p,
                                       rho, mu, damp, out_u, out_p, n_u, n_cells,
                                       tab, scal, stream);
  if (dim == 2 && degree == 2)
    return launch_cells<2, 3, 3, 2, T>(u, p, us, cell_u, cell_p, mask_u, mask_p,
                                       rho, mu, damp, out_u, out_p, n_u, n_cells,
                                       tab, scal, stream);
  if (dim == 3 && degree == 3)
    return launch_cells<3, 4, 4, 3, T>(u, p, us, cell_u, cell_p, mask_u, mask_p,
                                       rho, mu, damp, out_u, out_p, n_u, n_cells,
                                       tab, scal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Cell kernel: out_u/out_p (zeroed by the caller) += the coupled cell apply.
// dtype: 0 float32, 1 float64. p and out_p both null: velocity rows only,
// without a pressure input. rho/mu/damp null each: that coefficient is the constant
// scal value. tab: host doubles [V (Q1 x N1), D (Q1 x N1), Vp (Q1 x P1),
// w (Q1), inv_h (dim), vol]. scal: host doubles
// [beta, weight, tau1, rho0, mu0, damp0, tau_grad_div].
int adaflo_coupled_cells(int dtype, int dim, int degree, const void* u,
                         const void* p, const void* us, const int32_t* cell_u,
                         const int32_t* cell_p, const uint8_t* mask_u,
                         const uint8_t* mask_p, const void* rho, const void* mu,
                         const void* damp, void* out_u, void* out_p,
                         long long n_u, long long n_cells, const double* tab,
                         const double* scal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_set<double>(dim, degree, u, p, us, cell_u, cell_p, mask_u,
                              mask_p, rho, mu, damp, out_u, out_p, n_u, n_cells,
                              tab, scal, st);
  if (dtype == 0)
    return launch_set<float>(dim, degree, u, p, us, cell_u, cell_p, mask_u,
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

}  // extern "C"
